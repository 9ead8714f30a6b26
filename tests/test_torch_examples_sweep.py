"""The port's ``examples/torch/scenario_sweep.py`` against the reference's
``examples/scenario_sweep.py``, on the CPU at the script's own defaults
(64 nodes, 160 jobs, 100 windows, 8 lanes).

The reference runs once (``main()`` with ``sys.argv`` patched, its output
captured, its report recorded); the port runs twice with ``--device cpu``:
unsharded, and with ``--mesh 1``, a world of 1 over gloo that the script
starts and destroys (checked here, and destroyed in a ``finally`` should
the script fail). Each run's lines must equal the reference's line for
line, with only the wall time and the aggregate speed factor masked. The
report's integer entries must be equal exactly; its floats are held at the
fleet's parity bar (``tests/test_torch_scenarios.py``): the two balance
variances within rtol 5e-7 (the port sums them in f64 and rounds once),
the rest within rtol 2.5e-7.
"""
import importlib.util
import re
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
VAR_RTOL = 5e-7
RTOL = 2.5e-7
_TIMING = re.compile(r"in \d+\.\d+s wall \(\d+x aggregate speed factor\)")

torch.set_num_threads(1)


def load_script(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mask(lines):
    return [_TIMING.sub("in <wall>s wall (<speed>x aggregate speed factor)",
                        ln) for ln in lines]


@pytest.fixture(scope="module")
def reference():
    """The reference's printed lines and its report."""
    ref = load_script(ROOT / "examples" / "scenario_sweep.py",
                      "ref_ex_scenario_sweep")
    reports = []
    table = ref.format_table

    def recorded(report):
        reports.append(report)
        return table(report)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ref, "format_table", recorded)
        mp.setattr(sys, "argv", ["scenario_sweep.py"])
        from io import StringIO
        buf = StringIO()
        mp.setattr(sys, "stdout", buf)
        ref.main()
    finally:
        mp.undo()
    assert len(reports) == 1
    return buf.getvalue().splitlines(), reports[0]


def _port():
    return load_script(ROOT / "examples" / "torch" / "scenario_sweep.py",
                       "port_ex_scenario_sweep")


def _check(got_lines, res, reference):
    want_lines, want = reference
    assert sum(bool(_TIMING.search(ln)) for ln in want_lines) == 1
    assert _mask(got_lines) == _mask(want_lines)
    got = res["report"]
    assert got["baseline"] == want["baseline"]
    assert len(got["scenarios"]) == len(want["scenarios"]) == 8
    for g, w in zip(got["scenarios"], want["scenarios"]):
        assert g.keys() == w.keys()
        for k, wv in w.items():
            gv = g[k]
            if isinstance(wv, (int, str, bool)) or wv is None:
                assert gv == wv, (w["scenario"], k)
            else:
                rtol = VAR_RTOL if "balance_var" in k else RTOL
                assert gv == pytest.approx(float(wv), rel=rtol, abs=0), (
                    w["scenario"], k)
    assert res["placed"] == [s["placements"] for s in want["scenarios"]]
    assert res["windows"] == 100 and res["lanes"] == 8


def test_scenario_sweep_matches_reference(reference, capsys):
    capsys.readouterr()
    res = _port().main(["--device", "cpu"])
    _check(capsys.readouterr().out.splitlines(), res, reference)


def test_scenario_sweep_mesh_1_matches_reference(reference, capsys):
    """``--mesh 1``: the lanes through ``run_scenarios_sharded`` on a
    world of 1 over gloo, which the script ends before it returns."""
    assert not dist.is_initialized()
    capsys.readouterr()
    try:
        res = _port().main(["--mesh", "1", "--device", "cpu"])
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    _check(capsys.readouterr().out.splitlines(), res, reference)
