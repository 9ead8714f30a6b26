"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: module names compared by their
whole top-level name (``repro_torch`` is not ``repro``)."""
import ast
import os
import subprocess
import sys

import pytest

from portbench_cells import ROOT

BENCH = os.path.join(ROOT, "portbench")
JAX_SIDE = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(sub=""):
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_no_jax_side_import_anywhere():
    found = {(os.path.relpath(p, ROOT), m) for p in _files()
             for m in _imports(p) if m in JAX_SIDE}
    assert not found


def test_reference_imports_nothing_of_the_program():
    found = {(os.path.relpath(p, ROOT), m) for p in _files("reference")
             for m in _imports(p) if m.startswith("repro")}
    assert not found


def test_reference_runs_with_the_program_blocked():
    code = (
        "import sys\n"
        "for m in ('repro', 'repro_torch', 'jax'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path[:0] = [{ROOT!r}]\n"
        "import torch\n"
        "from portbench.reference import sim\n"
        "cell = sim.Cell(max_nodes=8, max_tasks=64, max_events_per_window=16,"
        " n_resources=3, n_usage_stats=8, n_attr_slots=4, max_constraints=2,"
        " sched_batch=8, resync_windows=4)\n"
        "fl = sim.Fleet(cell, [{'scheduler': 'random'}], 'cpu')\n"
        "w = {f: torch.zeros((16,) + s, dtype=d) for f, s, d in ["
        "('kind', (), torch.int8), ('slot', (), torch.int32),"
        " ('a', (3,), torch.float32), ('u', (8,), torch.float32),"
        " ('prio', (), torch.int32), ('job', (), torch.int32),"
        " ('constraints', (2, 3), torch.int32), ('attr_idx', (), torch.int32),"
        " ('attr_val', (), torch.int32), ('t_off', (), torch.int32)]}\n"
        "print(int(fl.step(w, sim.prng.key(1, 'cpu'))['n_running'][0]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"


@pytest.mark.parametrize("loaded,found", [
    (["repro_torch", "repro_torch.core"], []),
    (["repro.core"], ["repro"]),
    (["jax.numpy", "flax"], ["flax", "jax"]),
])
def test_run_names_whole_top_level_modules(monkeypatch, loaded, found):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "portbench_run", os.path.join(BENCH, "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    fake = {m: object() for m in loaded}
    monkeypatch.setattr(run.sys, "modules", fake)
    assert run.forbidden_modules() == found
