"""The port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports ``jax`` or anything of ``repro`` (the reference
package); importing the port works with both blocked."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
    r"|from\s+repro(\.|\s)(?!_))")


def _sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [line for line in path.read_text().splitlines()
           if FORBIDDEN.search(line)]
    assert not bad, bad


def test_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "import repro.core", "from repro.core import x",
                 "    from repro import parsers"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "import jaxlib_like_name_x", "# import jax"):
        assert not FORBIDDEN.search(line), line


def test_port_imports_with_jax_and_reference_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.core.engine, "
            "repro_torch.core.pipeline, repro_torch.launch.simulate, "
            "repro_torch.launch.whatif, repro_torch.scenarios, "
            "repro_torch.scenarios.batch, repro_torch.sched.table, "
            "repro_torch.kernels._build, repro_torch.configs, "
            "repro_torch.models.model, repro_torch.models.moe, "
            "repro_torch.models.mamba, repro_torch.serve.engine, "
            "repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.fused_ce.ops, repro_torch.train.step, "
            "repro_torch.distributed.fault, repro_torch.checkpoint.ckpt, "
            "repro_torch.launch.train, repro_torch.core.prng, "
            "repro_torch.sched.metaheuristics, repro_torch.core.snapshot, "
            "repro_torch.core.precompile, repro_torch.resilience, "
            "repro_torch.parsers.alibaba_openb, "
            "repro_torch.configs.agocs_full_cell, repro_torch.service, "
            "repro_torch.launch.serve_whatif, repro_torch.core.fleet, "
            "repro_torch.core.monitor\n"
            "assert 'jax' not in [m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None]\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
