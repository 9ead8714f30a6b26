"""BENCHMARK.json against the contract the harness relies on, and the
harness finding every configuration, traffic mix and per-layer metric by
name, including a cell added as new files in a copy of the benchmark."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench_cells import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_bounds():
    b = _bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in b["end_to_end"] + b["per_layer"])) == \
        len(b["end_to_end"]) + len(b["per_layer"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_finds_its_files():
    from portbench.harness import manifest
    man = manifest.Manifest(ROOT)
    for w in man.data["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cfg = man.config(w["config"])
        assert cfg["name"] == w["config"] and "cell" in cfg
        tf = man.traffic(w["traffic"])
        assert callable(man.driver(tf["kind"]))
        e2e = {m["name"] for m in man.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        readers = man.readers(w["name"])
        assert readers and all(callable(r) for r in readers.values())
        for m in man.per_layer(w["name"]):
            assert m["moves"] in e2e
    files = {f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench",
                                                     "metrics"))
             if f.endswith(".py")}
    assert files == {m["name"] for m in man.data["per_layer"]}
    for c in man.data["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert all(k in body for k in c["reduced"])


def test_a_cell_added_as_files_only(tmp_path):
    """A later cell, mix and metric are new files and entries: the harness
    finds them by name with no edit to an existing file."""
    from portbench.harness import manifest
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    tf = json.loads((root / "portbench" / "traffic" / "grid.json").read_text())
    tf["lanes"]["capacity_scale"] = [1.0, 0.5]
    (root / "portbench" / "traffic" / "halfcap.json").write_text(
        json.dumps(tf))
    (root / "portbench" / "metrics" / "windows_traced.sweep.py").write_text(
        "def read(inputs, window):\n    return float(inputs['windows'])\n")
    bench["workloads"].append({
        "name": "cellA-sweep64.halfcap", "config": "cellA",
        "traffic": "halfcap", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({
        "name": "windows_traced.sweep", "unit": "windows", "better": "higher",
        "source": "program_counter", "layer": "driver", "moves": "sweep_rate",
        "workloads": ["cellA-sweep64.halfcap"]})
    for m in bench["end_to_end"]:
        if m["name"] == "sweep_rate":
            m["workloads"].append("cellA-sweep64.halfcap")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    man = manifest.Manifest(str(root))
    assert man.traffic(man.workload("cellA-sweep64.halfcap")["traffic"])[
        "lanes"]["capacity_scale"] == [1.0, 0.5]
    readers = man.readers("cellA-sweep64.halfcap")
    assert readers["windows_traced.sweep"]({"windows": 7}, None) == 7.0
    assert "windows_traced.sweep" not in man.readers("cellA-sweep64.grid")


def test_a_kind_of_cell_added_as_a_file(tmp_path):
    """A new kind of cell is a new ``harness/<kind>.py``: the manifest
    imports its ``run`` by the mix's ``kind``, with no edit to run.py."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    (root / "portbench" / "harness" / "replay.py").write_text(
        "def run(job):\n    return 'replayed ' + job\n")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench.harness import manifest; "
            "m = manifest.Manifest(sys.argv[1]); "
            "print(m.driver('replay')('cell'))")
    out = subprocess.run([sys.executable, "-c", code, str(root)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "replayed cell"


def test_an_unknown_kind_is_refused():
    from portbench.harness import manifest
    with pytest.raises(KeyError):
        manifest.Manifest(ROOT).driver("../run")


@pytest.mark.parametrize("seed", [1, 2100000999, 2 ** 31 + 5])
def test_query_sequence_asks_one_spec_a_scheduler_a_cycle(seed):
    from portbench.harness import workload
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "planners.json")) as f:
        specs = workload.grid_specs(json.load(f)["lanes"])
    seq = workload.query_sequence(seed, specs, 256)
    assert len(seq) == 256
    for c in range(0, 256, 4):
        assert sorted(specs[k]["scheduler"] for k in seq[c:c + 4]) == \
            ["first_fit", "greedy", "random", "round_robin"]
    assert sorted(seq) == sorted(list(range(64)) * 4)
    assert seq == workload.query_sequence(seed, specs, 256)


@pytest.mark.parametrize("name,inputs,expect", [
    ("batch_fill.serve", {"lanes": 48, "padded": 16}, 75.0),
    ("answer_p95_s.serve", {"latencies": list(range(1, 21))}, 19.05),
])
def test_service_readers(name, inputs, expect):
    from portbench.harness import manifest
    read = manifest.Manifest(ROOT).reader(name)
    assert read(inputs, None) == pytest.approx(expect)


class _Window:
    window_s = 2.0

    def __init__(self):
        self.device_ops = [(0, 1, "k")] * 30

    def busy_s(self):
        return 1.5

    def letters(self):
        return {"A": (2, 0.004), "D": (2, 0.02), "glue": (26, 0.3)}


@pytest.mark.parametrize("cell", ["sweep", "serve"])
def test_trace_readers(cell):
    from portbench.harness import manifest, roofline
    man = manifest.Manifest(ROOT)
    work = {"A": (6.7e9, 0.0), "D": (3.35e9, 0.0)}
    inputs = {"windows": 10, "work": work}
    w = _Window()
    assert man.reader(f"host_launches_per_window.{cell}")(inputs, w) == 3.0
    assert man.reader(f"glue_device_ms_per_window.{cell}")(inputs, w) == \
        pytest.approx(30.0)
    assert man.reader(f"device_idle_share.{cell}")(inputs, w) == \
        pytest.approx(25.0)
    assert man.reader(f"match_roofline.{cell}")(inputs, w) == \
        pytest.approx(100.0 * roofline.bound_s(*work["A"]) / 0.002)
    assert man.reader(f"commit_roofline.{cell}")(inputs, w) == \
        pytest.approx(10.0)
    assert man.reader(f"match_roofline.{cell}")(inputs, None) is None
