"""The threefry kernel (``csrc/threefry.cu`` through
``kernels/threefry/ops``) against its plain version (``kernels/threefry/
ref``), bit for bit, on the card: the sweeps' draw (one key, 1,024 x
12,500 uniforms), a stack of keys (the vmap form), empty, tiny and ragged
draws and one past the plain version's chunk of the flat index, ``split``,
``bits``, ``randint`` over several spans, and one launch a draw. The plain
version runs on the card too (its int64 arithmetic is exact on any
device). Without a CUDA device those tests skip; the CPU test checks that
CPU keys take the plain version and launch nothing. On the card (JAX, which
tests/conftest.py imports, need not be installed):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_threefry_cuda.py
"""
import math

import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels.threefry import ops, ref

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda", 0)


def _keys(device, n=None, seed=29):
    k = ref.split(ref.key(seed, device), 4)[1]
    return k if n is None else ref.split(k, n)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("stack,shape", [
    (None, (1024, 12_500)),          # the sweeps' draw (sched/table)
    (3, (37, 101)),                  # three stacked keys, as vmap
    (None, (0,)), (None, (1,)), (None, (7,)),
    (None, (ref.CHUNK + 5,)),        # past the plain version's chunk
    (3, (0,)), (3, (1,)), (3, (7,)),
], ids=str)
@pytest.mark.parametrize("draw", ["uniform", "bits"])
def test_draw_bitwise(dev, draw, stack, shape):
    k = _keys(dev, stack)
    _same(getattr(ops, draw)(k, shape), getattr(ref, draw)(k, shape))


@pytest.mark.parametrize("n", [2, 65])
@pytest.mark.parametrize("lead", [(), (3,), (2, 5)], ids=str)
def test_split_bitwise(dev, lead, n):
    k = ref.split(_keys(dev), math.prod(lead)).reshape(lead + (2,))
    _same(ops.split(k, n), ref.split(k, n))


@pytest.mark.parametrize("span", [1, 7, 12_500, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(), (64,), (1024, 250)], ids=str)
def test_randint_bitwise(dev, span, shape):
    for k in (_keys(dev), _keys(dev, 3)):
        _same(ops.randint(k, 0, span, shape), ref.randint(k, 0, span, shape))
    _same(ops.randint(_keys(dev), -40, 3, (64,)),
          ref.randint(_keys(dev), -40, 3, (64,)))


def test_non_contiguous_keys(dev):
    """Strided and broadcast key views (``ks[:, 0]``, ``expand``) are made
    contiguous before the launch."""
    ks = ref.split(_keys(dev), 12).reshape(4, 3, 2)
    _same(ops.uniform(ks[:, 1], (9, 13)), ref.uniform(ks[:, 1], (9, 13)))
    k = ks[0, 0, None].expand(5, 2)
    _same(ops.bits(k, (33,)), ref.bits(k, (33,)))


def test_one_launch_a_draw(dev):
    k = _keys(dev)
    counts = []
    for fn in (lambda: prng.uniform(k, (1024, 12_500)),
               lambda: prng.bits(k, (100,)),
               lambda: prng.split(k, 65),
               lambda: prng.randint(k, 0, 7, (100,)),   # split, then bits
               lambda: prng.uniform(k, (0,))):          # nothing to draw
        before = ops.threefry_cuda.launches
        fn()
        counts.append(ops.threefry_cuda.launches - before)
    torch.cuda.synchronize()
    assert counts == [1, 1, 1, 2, 0]


def test_kernel_refuses_bad_keys(dev):
    with pytest.raises(TypeError):
        ops.threefry_cuda(_keys(dev, 2).to(torch.int32), 4, ops.UNIFORM)
    with pytest.raises(ValueError):
        ops.threefry_cuda(_keys(dev, 4)[::2], 4, ops.UNIFORM)


@pytest.mark.parametrize("draw", ["split", "bits", "uniform", "randint"])
def test_cpu_keys_take_the_plain_version(monkeypatch, draw):
    """CPU keys go to ``ref`` and launch nothing (the launch would raise)."""
    def no_launch(*args):
        raise AssertionError("a CPU draw reached the kernel")
    monkeypatch.setattr(ops._build, "launch", no_launch)
    before = ops.threefry_cuda.launches
    k = _keys("cpu", 3)
    args = {"split": (5,), "bits": ((4, 6),), "uniform": ((4, 6),),
            "randint": (0, 12_500, (4, 6))}[draw]
    _same(getattr(prng, draw)(k, *args), getattr(ref, draw)(k, *args))
    assert ops.threefry_cuda.launches == before
