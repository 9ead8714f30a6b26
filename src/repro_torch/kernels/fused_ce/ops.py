"""Dispatch for the fused cross-entropy kernel (kernel G): CUDA tensors
launch ``csrc/fused_ce.cu`` (its tensor-core body for bf16 with d % 8 ==
0, its SIMT body otherwise), CPU tensors take the plain version.

:class:`FusedCEMean` is the training loss built on it: the forward is the
kernel (the plain version on the CPU), the backward plain PyTorch chunked
over the vocab, since the reference has no backward kernel either (its
gradient is autodiff of the chunked scan).

The launch is the custom op ``repro_torch::fused_ce``, with a fake (shape)
function and a flop formula: a fake CUDA tensor (the dry-run planner's)
gets outputs of the right shapes and is counted by the formula, and never
reaches a data pointer or the build; a real one launches the kernel as
before."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_ce.ref import NEG, fused_ce_ref

#: dtype codes of the C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_T, BLOCK_V = 64, 64        # the SIMT body's token rows, vocab columns
BLOCKS_PER_SM = 8                # its splits of the vocab fill ~8 blocks an SM
TC_BLOCK_T, TC_BLOCK_V = 128, 256  # the tensor-core body's tile
TC_BLOCKS_PER_SM = 4             # its splits: 4 waves of one block an SM


def _splits(n_tok: int, Vp: int, n_sms: int, block_t: int = BLOCK_T,
            block_v: int = BLOCK_V, per_sm: int = BLOCKS_PER_SM
            ) -> Tuple[int, int]:
    """(splits of the vocab tiles, tiles per split): enough blocks to fill
    the card when T is small, every split non-empty."""
    n_tiles = -(-Vp // block_v)
    row_tiles = -(-n_tok // block_t)
    want = max(1, min(n_tiles, -(-per_sm * n_sms // row_tiles)))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def uses_tensor_cores(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a call takes the tensor-core body: bf16 with d % 8 == 0 and
    16-byte aligned bases (TMA's stride and address rules); f32 (where TF32
    would miss the f32 bar) and other bf16 shapes take the SIMT body."""
    return (x.dtype == torch.bfloat16 and x.shape[1] % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def fused_ce_cuda(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel itself: x (T, d) and w (Vp, d) contiguous CUDA tensors,
    both f32 or both bf16, labels (T,) int32 -> (nll (T,), lse (T,)) f32.
    ``launches`` counts every launch, ``launches_tc`` those of the
    tensor-core body."""
    T, d = x.shape
    Vp = w.shape[0]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_ce: unsupported dtype {x.dtype}")
    _build.check(x, "x", x.dtype, (T, d))
    _build.check(w, "w", x.dtype, (Vp, d))
    _build.check(labels, "labels", torch.int32, (T,))
    if w.device != x.device or labels.device != x.device:
        raise ValueError("fused_ce: x, w and labels must share a device")
    return torch.ops.repro_torch.fused_ce(x, w, labels, int(vocab_size))


@torch.library.custom_op("repro_torch::fused_ce", mutates_args=())
def _launch(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
            vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the body the operands pick, on checked tensors."""
    T, d = x.shape
    Vp = w.shape[0]
    nll = torch.empty(T, dtype=torch.float32, device=x.device)
    lse = torch.empty(T, dtype=torch.float32, device=x.device)
    if T == 0:
        return nll, lse
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tc = uses_tensor_cores(x, w)
    if tc:
        n_split, per = _splits(T, Vp, n_sms, TC_BLOCK_T, TC_BLOCK_V,
                               TC_BLOCKS_PER_SM)
    else:
        n_split, per = _splits(T, Vp, n_sms)
    scratch = torch.empty(3 * n_split * T, dtype=torch.float32,
                          device=x.device)
    if tc:
        _build.launch("fused_ce_tc_launch", x, w, labels, nll, lse, scratch,
                      T, d, Vp, vocab_size, n_split, per)
        fused_ce_cuda.launches_tc += 1
    else:
        _build.launch("fused_ce_launch", x, w, labels, nll, lse, scratch, T,
                      d, Vp, vocab_size, n_split, per, DTYPE_CODES[x.dtype])
    fused_ce_cuda.launches += 1
    return nll, lse


@_launch.register_fake
def _(x, w, labels, vocab_size):
    T = x.shape[0]
    return (torch.empty(T, dtype=torch.float32, device=x.device),
            torch.empty(T, dtype=torch.float32, device=x.device))


def ce_flops(x_shape, w_shape, *args, **kwargs) -> int:
    """The kernel's work: the (T, d) x (d, Vp) product of the logits."""
    T, d = x_shape
    return 2 * T * d * w_shape[0]


_build.register_flops(torch.ops.repro_torch.fused_ce, ce_flops)


fused_ce_cuda.launches = 0
fused_ce_cuda.launches_tc = 0


def fused_ce_with_lse(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse) per token: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if x.device.type != "cuda":
        return fused_ce_ref(x, w, labels, vocab_size)
    return fused_ce_cuda(x, w, labels, vocab_size)


def fused_ce(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
             vocab_size: int, *, use_kernel: bool = True,
             interpret: bool = True, block_t: int = 128,
             block_v: int = 512) -> torch.Tensor:
    """Per-token NLL of softmax(x @ w.T) at ``labels``. (T,d),(Vp,d),(T,)
    -> (T,) f32.

    The reference's keywords are accepted; ``use_kernel``, ``interpret``,
    ``block_t`` and ``block_v`` are ignored: the device decides (CUDA ->
    the kernel or raise, CPU -> the plain version) and the kernel picks its
    own tiles, any T allowed.
    """
    return fused_ce_with_lse(x, w, labels, vocab_size)[0]


def mean_ce(x, w, labels, vocab_size, **kw) -> torch.Tensor:
    nll = fused_ce(x, w, labels, vocab_size, **kw)
    valid = (labels >= 0).sum()
    return nll.sum() / valid.clamp_min(1)


class FusedCEMean(torch.autograd.Function):
    """Mean NLL over the valid labels, ``nll.sum() / max(valid, 1)``, of
    the logits x @ w.T (x: (T, d), w: (Vp, d), labels: (T,) int32).

    Forward: kernel G on the card, its plain version on the CPU. Backward:
    for each of ``n_chunks`` vocab chunks the chunk's logits are recomputed
    as the reference's compiled scan computes them, the f32 products of the
    operands (``x.float() @ w_c.float().T``: no bf16 rounding), masked past
    ``vocab_size``, turned into softmax - onehot with the forward's lse,
    scaled by valid / n_valid x the incoming gradient, cast to x's dtype
    and multiplied back in it, as the reference's transposed products are:
    dx = sum_c p_c @ w_c (summed in f32), dw_c = p_c.T @ x. The (T, Vp)
    logits are never built."""

    @staticmethod
    def forward(ctx, x, w, labels, vocab_size: int, n_chunks: int):
        nll, lse = fused_ce_with_lse(x, w, labels, vocab_size)
        valid = (labels >= 0).sum()
        ctx.save_for_backward(x, w, labels, lse)
        ctx.vocab_size, ctx.n_chunks = vocab_size, n_chunks
        return nll.sum() / valid.clamp_min(1)

    @staticmethod
    def backward(ctx, grad_out):
        x, w, labels, lse = ctx.saved_tensors
        T, d = x.shape
        Vp = w.shape[0]
        n_chunks, V = ctx.n_chunks, ctx.vocab_size
        assert Vp % n_chunks == 0, (Vp, n_chunks)
        Vc = Vp // n_chunks
        valid = labels >= 0
        coef = (valid.float() / valid.sum().clamp_min(1) * grad_out)[:, None]
        safe = labels.clamp_min(0).long()
        rows = torch.arange(T, device=x.device)
        xf = x.float()
        dx = torch.zeros((T, d), dtype=torch.float32, device=x.device)
        need_w = ctx.needs_input_grad[1]
        dw = torch.empty_like(w) if need_w else None
        for c in range(n_chunks):
            c0 = c * Vc
            w_c = w[c0:c0 + Vc]
            logits = xf @ w_c.float().T
            if c0 + Vc > V:
                logits[:, max(V - c0, 0):] = NEG
            p = torch.exp(logits - lse[:, None])
            inchunk = valid & (safe >= c0) & (safe < c0 + Vc)
            p.index_put_((rows, (safe - c0).clamp(0, Vc - 1)),
                         -inchunk.float(), accumulate=True)
            p = (p * coef).to(x.dtype)
            dx += (p @ w_c).float()
            if need_w:
                torch.matmul(p.T, x, out=dw[c0:c0 + Vc])
        return dx.to(x.dtype), dw, None, None, None
