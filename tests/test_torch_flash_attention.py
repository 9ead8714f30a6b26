"""Kernel F's plain version in the port against the reference's Pallas
kernel (interpret mode, as the reference's own tests run it) and its jnp
oracle: the reference sweep's four shapes, causal and full, f32 within
1e-5 and bf16 within 2e-2 (the reference's own bar,
tests/test_kernels.py); a plain-torch model of the tensor-core body's
rounding against the same kernel; and the dispatch rules of ``ops``."""
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


def _tc_body_model(q, k, v, causal, scale, split=True):
    """The tensor-core body's arithmetic (csrc/flash_attention.cu) in plain
    torch on bf16 q, k, v: scores as f32 sums of bf16 products (exact in
    f32), times ``scale`` after the product; online softmax over 64-key
    tiles in f32; p split into p_hi = bf16(p) and p_lo = bf16(p - p_hi),
    each multiplied by bf16 v exactly in f32 and summed (``split=False``:
    one bf16 p, for contrast); acc / max(l, 1e-30). Returns f32."""
    B, S, H, D = q.shape
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, 64):
        kt, vt = kf[..., k0:k0 + 64, :], vf[..., k0:k0 + 64, :]
        s = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[-2])[None, :]
            s = s.masked_fill(keys > rows, -1e30)
        m_new = torch.maximum(m, s.max(-1, keepdim=True).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


@pytest.mark.parametrize("B,S,H,D,causal", [(1, 128, 2, 64, True),
                                            (2, 192, 1, 32, False)])
def test_tensor_core_rounding_model_matches_reference_kernel(B, S, H, D,
                                                             causal):
    """The model of the tensor-core body against the reference's Pallas
    kernel (interpret mode) on the same bf16 inputs, output in bf16: within
    2e-2, the reference's bf16 bar; the two differ by at most a rounding of
    the bf16 output (one bf16 step is 2^-7 of |o|, 1.6e-2 at |o| near 2-4),
    since in f32 the model sits within 2e-5 of the reference's jnp oracle:
    the products are exact, and p_hi + p_lo keeps p to about 2^-16 of
    itself. One bf16 p instead would miss that by two orders (~2e-3)."""
    q, k, v = [_to_torch(x, "bfloat16") for x in _inputs(B * S + D, B, S,
                                                           H, D)]
    scale = 1.0 / D ** 0.5
    as_jax = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)]
    want = fa_jax(*as_jax, causal=causal, use_kernel=True, interpret=True,
                  block_q=64, block_k=64)
    got = _tc_body_model(q, k, v, causal, scale)
    err = np.abs(got.bfloat16().float().numpy()
                 - np.asarray(want.astype(jnp.float32))).max()
    assert err <= 2e-2, err
    oracle = np.asarray(fa_jax(*[jnp.asarray(x.float().numpy())
                                 for x in (q, k, v)], causal=causal,
                               use_kernel=False))
    err32 = np.abs(got.numpy() - oracle).max()
    one = np.abs(_tc_body_model(q, k, v, causal, scale, split=False).numpy()
                 - oracle).max()
    assert err32 <= 2e-5, err32
    assert one > 10 * err32, (one, err32)


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


@pytest.mark.parametrize("dtype,D,tc", [(torch.bfloat16, 128, True),
                                        (torch.bfloat16, 96, True),
                                        (torch.bfloat16, 16, True),
                                        (torch.bfloat16, 40, False),
                                        (torch.bfloat16, 8, False),
                                        (torch.float32, 64, False)])
def test_body_is_picked_by_dtype_and_head_dim(dtype, D, tc):
    assert fa_ops.uses_tensor_cores(dtype, D) is tc


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = [torch.from_numpy(x) for x in _inputs(4, 1, 16, 2, 8)]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fa_ops.flash_attention_cuda(q, k, v, True, 0.5)
