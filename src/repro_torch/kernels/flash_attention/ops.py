"""Dispatch for the flash-attention kernel (kernel F): CUDA tensors launch
``csrc/flash_attention.cu``, CPU tensors take the plain version.

The kernel reads q, k and v in the reference's (B, S, H, D) layout by
strides (the last dim contiguous), so the reference's fold to (B*H, S, D)
and back is not needed."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: dtype codes of the C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, scale: float) -> torch.Tensor:
    """The kernel itself: q, k, v (B, S, H, D) CUDA tensors, all f32 or all
    bf16, D <= 128, each with a unit stride on D -> (B, S, H, D) in q's
    dtype, contiguous."""
    B, S, H, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{t.device}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: expected {q.dtype}, got {t.dtype}")
        if tuple(t.shape) != (B, S, H, D):
            raise ValueError(f"{name}: expected shape {(B, S, H, D)}, "
                             f"got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch("flash_attention_launch", q, k, v, out,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  B, S, H, D, int(bool(causal)), DTYPE_CODES[q.dtype],
                  float(scale))
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    use_kernel: bool = True, interpret: bool = True,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q,k,v: (B, S, H, D) with KV heads already expanded to H.

    The reference's keywords are accepted; ``use_kernel``, ``interpret``,
    ``block_q`` and ``block_k`` are ignored: the device decides (CUDA ->
    the kernel or raise, CPU -> the plain version) and the kernel picks its
    own tiles, any S allowed.
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type != "cuda":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    return flash_attention_cuda(q, k, v, causal, scale)
