"""Kernel G's plain version and the chunked loss built on it against the
reference, on the CPU: the same numpy inputs go through both packages.

Bars: the plain version against the reference's ``fused_ce_ref`` and its
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) within
1e-5 in f32 and within 0.05 in bf16 (the reference's own kernel bar; both
sides take the bf16 inputs' exact f32 products, so they agree far closer);
ignored labels give exactly 0; ``mean_ce`` and :class:`FusedCEMean` (loss
and the gradients dx, dw) against the reference's
``cross_entropy_chunked`` and ``jax.grad`` of it in f32 within 1e-5; the
CPU branch of ``cross_entropy_chunked`` (the copy of the reference's scan)
within 1e-5 in f32 and in bf16 (the compiled reference keeps the chunk
logits in f32, and so does the port); :class:`FusedCEMean`'s bf16
gradients within 1e-2 of the largest gradient of ``jax.grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_ce.ops import fused_ce as ref_fused_ce
from repro.kernels.fused_ce.ops import mean_ce as ref_mean_ce
from repro.kernels.fused_ce.ref import fused_ce_ref as ref_plain
from repro.models.model import cross_entropy_chunked as ref_chunked
from repro_torch.kernels.fused_ce import ops
from repro_torch.models import model

torch.set_num_threads(1)

TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

# tests/test_kernels.py::test_fused_ce_sweep's four shapes
SWEEP = [
    (64, 32, 256, 250, 32, 64, jnp.float32),     # vocab padding masked
    (100, 16, 128, 128, 32, 128, jnp.float32),   # token padding
    (128, 64, 512, 500, 128, 256, jnp.bfloat16),
    (32, 8, 64, 64, 32, 32, jnp.float32),
]


def _inputs(seed, T, d, Vp, V, dtype, lo=-1):
    r = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(r.standard_normal((T, d)), dtype)
                   .astype(jnp.float32))
    w = np.asarray(jnp.asarray(r.standard_normal((Vp, d)), dtype)
                   .astype(jnp.float32))
    lab = r.integers(lo, V, T).astype(np.int32)
    return x, w, lab


def _both(x, w, lab, dtype):
    """(jax arrays, torch tensors) of the same values in ``dtype``."""
    jx = (jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(lab))
    tx = (torch.from_numpy(x).to(TORCH_DT[dtype]),
          torch.from_numpy(w).to(TORCH_DT[dtype]), torch.from_numpy(lab))
    return jx, tx


@pytest.mark.parametrize("T,d,Vp,V,bt,bv,dtype", SWEEP)
def test_plain_matches_reference_and_pallas_kernel(T, d, Vp, V, bt, bv,
                                                   dtype):
    x, w, lab = _inputs(0, T, d, Vp, V, dtype)
    (jx, jw, jl), (tx, tw, tl) = _both(x, w, lab, dtype)
    nll, lse = ops.fused_ce_with_lse(tx, tw, tl, V)
    assert nll.dtype == lse.dtype == torch.float32 and nll.shape == (T,)
    want = np.asarray(ref_plain(jx, jw, jl, V))
    ker = np.asarray(ref_fused_ce(jx, jw, jl, V, use_kernel=True,
                                  interpret=True, block_t=bt, block_v=bv))
    tol = 1e-5 if dtype == jnp.float32 else 0.05
    assert np.abs(nll.numpy() - want).max() <= tol
    assert np.abs(nll.numpy() - ker).max() <= tol
    # the wrapper with the reference's keywords gives the same numbers
    assert torch.equal(ops.fused_ce(tx, tw, tl, V, use_kernel=True,
                                    interpret=True, block_t=bt,
                                    block_v=bv), nll)
    # ignored labels contribute exactly zero
    assert not nll[tl < 0].any()
    # lse is the logsumexp of the masked f32 logits
    logits = np.asarray(x, np.float64) @ np.asarray(w, np.float64).T
    logits[:, V:] = -1e30
    mx = logits.max(-1)
    lse64 = np.log(np.exp(logits - mx[:, None]).sum(-1)) + mx
    assert np.abs(lse.numpy() - lse64).max() <= 1e-4


def test_mean_ce_matches_reference_and_chunked_loss():
    T, d, V = 64, 32, 256
    x, w, lab = _inputs(1, T, d, V, V, jnp.float32, lo=0)
    (jx, jw, jl), (tx, tw, tl) = _both(x, w, lab, jnp.float32)
    got = float(ops.mean_ce(tx, tw, tl, V, use_kernel=True, block_t=32,
                            block_v=64))
    assert abs(got - float(ref_mean_ce(jx, jw, jl, V, use_kernel=True,
                                       block_t=32, block_v=64))) <= 1e-5
    assert abs(got - float(ref_chunked(jx, jw, jl, V, n_chunks=4))) <= 1e-5


@pytest.mark.parametrize("T,d,Vp,V,n_chunks", [
    (48, 16, 256, 250, 4),      # padded vocab in the last chunk
    (30, 24, 128, 100, 2),      # a whole padded tail, ragged T
    (64, 32, 256, 256, 8),
])
def test_fused_ce_mean_loss_and_grads_match_jax_grad(T, d, Vp, V, n_chunks):
    x, w, lab = _inputs(2, T, d, Vp, V, jnp.float32)
    (jx, jw, jl), _ = _both(x, w, lab, jnp.float32)
    want, (gx, gw) = jax.value_and_grad(
        lambda a, b: ref_chunked(a, b, jl, V, n_chunks),
        argnums=(0, 1))(jx, jw)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = ops.FusedCEMean.apply(tx, tw, torch.from_numpy(lab), V, n_chunks)
    (loss * 1.0).backward()
    assert abs(float(loss) - float(want)) <= 1e-5
    assert np.abs(tx.grad.numpy() - np.asarray(gx)).max() <= 1e-5
    assert np.abs(tw.grad.numpy() - np.asarray(gw)).max() <= 1e-5
    # padded columns get no gradient
    assert not tw.grad[V:].any()


@pytest.mark.parametrize("T,d,Vp,V", [(40, 32, 256, 250),
                                       (100, 128, 1024, 1000)])
def test_fused_ce_mean_bf16_grads_match_jax_grad(T, d, Vp, V):
    """In bf16 the gradients come back in bf16 on both sides: within 1e-2
    of the largest gradient (about two bf16 steps at that magnitude)."""
    x, w, lab = _inputs(5, T, d, Vp, V, jnp.bfloat16)
    (jx, jw, jl), (tx, tw, tl) = _both(x, w, lab, jnp.bfloat16)
    want, (gx, gw) = jax.value_and_grad(
        lambda a, b: ref_chunked(a, b, jl, V, 4), argnums=(0, 1))(jx, jw)
    tx.requires_grad_()
    tw.requires_grad_()
    loss = ops.FusedCEMean.apply(tx, tw, tl, V, 4)
    loss.backward()
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    assert abs(float(loss) - float(want)) <= 1e-5
    for got, ref in ((tx.grad, gx), (tw.grad, gw)):
        ref = np.asarray(jnp.asarray(ref, jnp.float32))
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= 1e-2 * np.abs(ref).max(), err


def test_fused_ce_mean_scales_by_incoming_gradient_and_ignores_rows():
    T, d, V = 20, 8, 64
    x, w, lab = _inputs(3, T, d, V, V, jnp.float32)
    lab[:5] = -1
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = ops.FusedCEMean.apply(tx, tw, torch.from_numpy(lab), V, 2)
    (3.0 * loss).backward()
    tx2 = torch.from_numpy(x).requires_grad_()
    tw2 = torch.from_numpy(w).requires_grad_()
    loss2 = model.cross_entropy_chunked_plain(
        tx2, tw2, torch.from_numpy(lab), V, 2)
    (3.0 * loss2).backward()
    assert abs(float(loss) - float(loss2)) <= 1e-5
    assert np.abs(tx.grad.numpy() - tx2.grad.numpy()).max() <= 1e-5
    assert np.abs(tw.grad.numpy() - tw2.grad.numpy()).max() <= 1e-5
    assert not tx.grad[:5].any()


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, 1e-5)])
def test_cross_entropy_chunked_cpu_is_the_reference_scan(dtype, tol):
    T, d, Vp, V = 40, 32, 256, 250
    x, w, lab = _inputs(4, T, d, Vp, V, dtype)
    (jx, jw, jl), (tx, tw, tl) = _both(x, w, lab, dtype)
    got = model.cross_entropy_chunked(tx, tw, tl, V, 4)
    want = ref_chunked(jx, jw, jl, V, 4)
    assert abs(float(got) - float(want)) <= tol


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ops.fused_ce_cuda(x, torch.zeros(16, 8),
                          torch.zeros(4, dtype=torch.int32), 16)


@pytest.mark.parametrize("T,Vp,sms", [(2048, 152064, 132), (1, 64, 132),
                                      (200, 1000, 132), (5000, 64, 8)])
def test_vocab_splits_cover_the_tiles_exactly(T, Vp, sms):
    n_split, per = ops._splits(T, Vp, sms)
    n_tiles = -(-Vp // ops.BLOCK_V)
    assert n_split * per >= n_tiles > (n_split - 1) * per
    assert 1 <= n_split <= 65535


@pytest.mark.parametrize("T,Vp,sms", [(2048, 152064, 132), (1, 64, 132),
                                      (200, 1000, 132), (5000, 64, 8),
                                      (513, 4096, 132)])
def test_tensor_core_splits_cover_its_tiles_exactly(T, Vp, sms):
    n_split, per = ops._splits(T, Vp, sms, ops.TC_BLOCK_T, ops.TC_BLOCK_V,
                               ops.TC_BLOCKS_PER_SM)
    n_tiles = -(-Vp // ops.TC_BLOCK_V)
    assert n_split * per >= n_tiles > (n_split - 1) * per
    assert 1 <= n_split <= 65535


def test_tensor_core_splits_at_the_training_shape():
    """qwen3-4b's training shape on 132 SMs: 16 row tiles x 33 splits of 18
    vocab tiles, 528 blocks, four full waves of one block an SM."""
    n_split, per = ops._splits(2048, 152064, 132, ops.TC_BLOCK_T,
                               ops.TC_BLOCK_V, ops.TC_BLOCKS_PER_SM)
    assert (n_split, per) == (33, 18)
    assert -(-2048 // ops.TC_BLOCK_T) * n_split == 4 * 132


@pytest.mark.parametrize("dtype,d,tc", [(torch.bfloat16, 2560, True),
                                        (torch.bfloat16, 8, True),
                                        (torch.bfloat16, 12, False),
                                        (torch.float32, 2560, False),
                                        (torch.float32, 8, False)])
def test_body_choice_by_dtype_and_shape(dtype, d, tc):
    """The tensor-core body takes bf16 with d % 8 == 0; f32 and bf16 with
    other d take the SIMT body, decided before any launch."""
    x, w = torch.zeros(4, d, dtype=dtype), torch.zeros(16, d, dtype=dtype)
    assert ops.uses_tensor_cores(x, w) is tc
    if tc:     # a base off 16 bytes cannot be a TMA address
        assert not ops.uses_tensor_cores(
            torch.zeros(4 * d + 1, dtype=dtype)[1:].view(4, d), w)
