"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). The build happens on first use, one ``nvcc`` per
source started together, into ``build/kernels/<hash of sources and
flags>/`` at the repository root (or ``$REPRO_TORCH_BUILD_DIR``); a library
already built from the same sources is loaded as it is.

Floating point: no ``--use_fast_math`` and ``--fmad=false``, so divides are
IEEE and no multiply-add is contracted, as in the reference's float
expressions; denormals are kept (no ``-ftz``).

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# -ldl: kernels F and G look their tensor-map encoder up in libcuda with
# dlsym (csrc/tma.cuh)
LINK_FLAGS = ["-ldl"]
LIB_NAME = "librepro_torch_kernels.so"

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
# C signatures: pointers and the stream as void*, sizes as int (long long
# where a count may pass 2**31), strides as long long, scales as float
SIGNATURES: Dict[str, List] = {
    "constraint_match_launch": [P, P, P, P, P, P, P, I, I, I, I, I, I, P],
    "placement_commit_launch": [P, P, P, P, P, P, P, P, P,
                                I, I, I, I, I, I, P],
    "placement_commit_cluster": [I, I],
    "sched_commit_launch": [P, P, P, P, P, P, P, P, P, P,
                            I, I, I, I, I, P],
    "sched_commit_cluster": [I, I],
    "window_stats_launch": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
    "segment_usage_launch": [P, P, P, P, P, L, I, I, I, I, I, P],
    "flash_attention_launch": [P, P, P, P, L, L, L, L, L, L, L, L, L,
                               I, I, I, I, I, I, F, P],
    "flash_attention_tc_launch": [P, P, P, P, L, L, L, L, L, L, L, L, L,
                                  I, I, I, I, I, F, P],
    "fused_ce_launch": [P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    "fused_ce_tc_launch": [P, P, P, P, P, P, I, I, I, I, I, I, P],
    "threefry_launch": [P, P, L, L, I, P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build did: seconds, library path, nvcc's -Xptxas -v output
BUILD_INFO: Dict[str, object] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) — the "
                           "kernels are built with nvcc on first use")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _digest(sources: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    sources = _sources()
    out = build_dir() / _digest(sources)
    lib = out / LIB_NAME
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, path=str(lib), ptxas="(cached)")
        return lib
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src in sources:
        obj = out / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out / (LIB_NAME + f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _ in procs], *LINK_FLAGS],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)
    BUILD_INFO.update(seconds=time.time() - t0, path=str(lib),
                      ptxas="\n".join(logs))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a CUDA error.

    ``args`` are tensors (passed as device pointers), None (a null pointer),
    floats and ints; the current stream of the first tensor's device is
    appended.
    """
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    stream = torch.cuda.current_stream(dev).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor)
              else a if a is None or isinstance(a, float) else int(a)
              for a in args]
    with torch.cuda.device(dev):
        err = getattr(library(), name)(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: cudaGetLastError() = {err} at launch")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def register_flops(op, formula) -> None:
    """``formula(*shapes and scalars of op's arguments)`` as ``op``'s count
    in ``torch.utils.flop_counter`` (so ``FlopCounterMode`` and the dry-run
    planner count a kernel's custom op); once per process."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    if op not in flop_registry:
        register_flop_formula(op)(formula)
