"""The port's simulator examples (``examples/torch/quickstart.py``,
``simulate_cluster.py``) against the reference's scripts of the same names,
on the CPU at the scripts' own defaults.

Each test loads the reference script by path, runs its ``main()`` with
``sys.argv`` patched and captures what it prints, then runs the port's
script with ``--device cpu`` at the same arguments. The printed lines
must be equal line for line, with only the timing fields masked (wall
seconds and the speed factor); every ``Simulation`` of a run is recorded
on both sides, and the integer columns of its stats frame must be equal
exactly, window by window. No printed float sits on a rounding edge at
these arguments, so every line is compared as text.

``scenario_sweep.py`` has its own file, ``test_torch_examples_sweep.py``:
the three scripts in one file would take about twice the time a test file
is given on one worker.
"""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def load_script(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_pair(name, args, monkeypatch, capsys):
    """(reference lines, port lines, reference sims, port sims, port
    result) of one example at ``args``."""
    ref = load_script(ROOT / "examples" / f"{name}.py", f"ref_ex_{name}")
    port = load_script(ROOT / "examples" / "torch" / f"{name}.py",
                       f"port_ex_{name}")
    sims = {"ref": [], "port": []}
    for side, mod in (("ref", ref), ("port", port)):
        base = mod.Simulation

        class Recorded(base):
            def __init__(self, *a, _side=side, **kw):
                super().__init__(*a, **kw)
                sims[_side].append(self)

        monkeypatch.setattr(mod, "Simulation", Recorded)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    got_res = port.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    return want, got, sims["ref"], sims["port"], got_res


def assert_int_stats_equal(ref_sims, port_sims):
    assert len(ref_sims) == len(port_sims)
    for r, p in zip(ref_sims, port_sims):
        assert r.windows_done == p.windows_done
        want, got = r.stats_frame(), p.stats_frame()
        assert want.keys() == got.keys()
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            if np.issubdtype(w.dtype, np.integer):
                assert g.dtype == w.dtype, k
                np.testing.assert_array_equal(g, w, err_msg=k)


def test_quickstart_matches_reference(monkeypatch, capsys):
    want, got, rs, ps, res = run_pair("quickstart", [], monkeypatch, capsys)
    assert got == want          # quickstart prints no timing field
    assert_int_stats_equal(rs, ps)
    parsed = {ln.split(":")[0].strip(): ln.split(":")[1].strip()
              for ln in want if " : " in ln}
    assert res["windows"] == int(parsed["windows simulated"]) == 100
    assert res["placed"] == int(parsed["tasks placed"])
    assert res["completed"] == int(parsed["tasks completed"])
    assert res["evictions"] == int(parsed["evictions"])
    assert want[0] == (f"trace: {res['n_tasks']} tasks / "
                       f"{res['n_machines']} nodes / "
                       f"{res['n_usage_records']} usage records")


# the table's row: name, then wall s (8.2f) and speed x (9.1f)
_ROW = re.compile(r"^(\S+\s+)(\d+\.\d+)(\s+)(\d+\.\d+)(\s+.*)$")


def _mask_cluster(lines):
    out = []
    for ln in lines:
        m = _ROW.match(ln)
        if m and not ln.startswith("trace:"):
            ln = f"{m.group(1).rstrip()} <wall> <speed>{m.group(5)}"
        out.append(ln)
    return out


def test_simulate_cluster_matches_reference(monkeypatch, capsys):
    """Four schedulers on one trace (``random`` and ``simulated_annealing``
    on the port's threefry stream), then a snapshot at window 96 restored
    onto the run's device. The snapshot line's MiB is the npz's size; the
    two packages' files differ in bytes but round to the same 0.1 MiB
    here, so the line is compared unmasked."""
    want, got, rs, ps, res = run_pair("simulate_cluster", [], monkeypatch,
                                      capsys)
    assert sum(bool(_ROW.match(ln)) for ln in want) == 4
    assert _mask_cluster(got) == _mask_cluster(want)
    assert_int_stats_equal(rs, ps)
    for sched, r in res["results"].items():
        row = next(ln for ln in want if ln.split()[:1] == [sched])
        placed, evicted = (int(x) for x in row.split()[3:5])
        assert (r["placed"], r["evicted"]) == (placed, evicted), sched
    snap = res["snapshot"]
    assert snap["window"] == 96 and snap["cfg_match"]
    assert snap["device"] == "cpu"
