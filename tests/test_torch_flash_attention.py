"""Kernel F's plain version in the port against the reference's Pallas
kernel (interpret mode, as the reference's own tests run it) and its jnp
oracle: the reference sweep's four shapes, causal and full, f32 within
1e-5 and bf16 within 2e-2 (the reference's own bar,
tests/test_kernels.py); and the dispatch rules of ``ops``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as fa_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

torch.set_num_threads(1)

SHAPES = [(1, 64, 2, 16, 32, 32, "float32"),
          (2, 128, 3, 32, 64, 32, "float32"),
          (2, 96, 1, 64, 32, 96, "float32"),
          (1, 128, 2, 32, 128, 64, "bfloat16")]


def _inputs(seed, B, S, H, D):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _to_jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,S,H,D,bq,bk,dtype", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_kernel(B, S, H, D, bq, bk, dtype, causal):
    q, k, v = _inputs(B * S + H * D, B, S, H, D)
    want = fa_jax(*[_to_jax(x, dtype) for x in (q, k, v)], causal=causal,
                  use_kernel=True, interpret=True, block_q=bq, block_k=bk)
    got = fa_ops.flash_attention(*[_to_torch(x, dtype) for x in (q, k, v)],
                                 causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    err = np.abs(got.float().numpy()
                 - np.asarray(want.astype(jnp.float32))).max()
    assert err <= tol, err


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_oracle_with_scale(causal):
    q, k, v = _inputs(7, 2, 40, 3, 24)
    want = fa_jax(*[jnp.asarray(x) for x in (q, k, v)], causal=causal,
                  scale=0.3, use_kernel=False)
    got = fa_ops.flash_attention(*[torch.from_numpy(x) for x in (q, k, v)],
                                 causal=causal, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_cpu_tensor_takes_plain_version_and_counts_nothing():
    q, k, v = [torch.from_numpy(x) for x in _inputs(3, 1, 16, 2, 8)]
    before = fa_ops.flash_attention_cuda.launches
    got = fa_ops.flash_attention(q, k, v, causal=True)
    assert fa_ops.flash_attention_cuda.launches == before
    assert torch.equal(got, attention_ref(q, k, v, causal=True))


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = [torch.from_numpy(x) for x in _inputs(4, 1, 16, 2, 8)]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fa_ops.flash_attention_cuda(q, k, v, True, 0.5)
