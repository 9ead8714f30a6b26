"""Dispatch for the flash-attention kernel (kernel F): CUDA tensors launch
``csrc/flash_attention.cu``, CPU tensors take the plain version.

The kernel reads q, k and v in the reference's (B, S, H, D) layout by
strides (the last dim contiguous), so the reference's fold to (B*H, S, D)
and back is not needed. It has two bodies, and dtype and D alone pick one:

- bf16 with D a multiple of 16 and D <= 128 (qwen3-4b's 128, phi3's 96,
  64, ...): the tensor-core body (TMA, wgmma; p kept at f32 accuracy as two
  bf16 operands). TMA needs 16-byte aligned bases and strides: such a call
  with a base, or the stride of an axis longer than 1, that is not a
  multiple of 16 bytes raises ValueError.
- f32 (held to 1e-5, which bf16 tensor-core products would miss), and bf16
  with any other D: the SIMT body (f32 scalar arithmetic).

Neither body is the plain version; ``flash_attention_cuda.launches`` counts
every launch and ``launches_tc`` those of the tensor-core body.

The launch is the custom op ``repro_torch::flash_attention``, with a fake
(shape) function and a flop formula: a fake CUDA tensor (the dry-run
planner's) gets an output of the right shape and is counted by the
formula, and never reaches a data pointer, the TMA checks or the build; a
real one launches the kernel as before."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

#: dtype codes of the C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
TC_BODY = "tensor cores: TMA + wgmma m64n64k16 (q k^T), m64nDk16 x 2 (p v)"
SIMT_BODY = "SIMT: f32 scalar arithmetic"


def uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a call of this dtype and head dim takes the tensor-core
    body: bf16 with D % 16 == 0 and D <= 128."""
    return (dtype == torch.bfloat16 and head_dim % 16 == 0
            and 16 <= head_dim <= MAX_HEAD_DIM)


def _check_tma(name: str, t: torch.Tensor) -> None:
    """Raise ValueError unless ``t``'s base and the strides of its axes
    longer than 1 are multiples of 16 bytes (TMA's rule)."""
    es = t.element_size()
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name}: base address not 16-byte aligned, which "
                         f"the tensor-core body's TMA needs")
    for ax in range(3):
        if t.shape[ax] > 1 and (t.stride(ax) * es) % 16 != 0:
            raise ValueError(f"{name}: stride {t.stride(ax)} of axis {ax} "
                             f"is not a multiple of 16 bytes, which the "
                             f"tensor-core body's TMA needs")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, scale: float) -> torch.Tensor:
    """The kernel itself: q, k, v (B, S, H, D) CUDA tensors, all f32 or all
    bf16, D <= 128, each with a unit stride on D -> (B, S, H, D) in q's
    dtype, contiguous. bf16 with D % 16 == 0 goes through the tensor-core
    body (16-byte aligned bases and strides, else ValueError), the rest
    through the SIMT body."""
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
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal),
                                                 float(scale))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    """One launch of the body that dtype and D pick, on checked tensors."""
    B, S, H, D = q.shape
    tc = uses_tensor_cores(q.dtype, D)
    if tc:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, t)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if tc:
        _build.launch("flash_attention_tc_launch", q, k, v, out, *strides,
                      B, S, H, D, int(causal), scale)
        flash_attention_cuda.launches_tc += 1
    else:
        _build.launch("flash_attention_launch", q, k, v, out, *strides,
                      B, S, H, D, int(causal), DTYPE_CODES[q.dtype], scale)
    flash_attention_cuda.launches += 1
    return out


@_launch.register_fake
def _(q, k, v, causal, scale):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def attention_flops(q_shape, k_shape, v_shape, causal: bool, *args,
                    **kwargs) -> int:
    """The kernel's work: two products of D multiply-adds for each (query,
    key) pair it scores, S(S+1)/2 pairs a head causal, S^2 full."""
    B, S, H, D = q_shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * H * D * pairs


_build.register_flops(torch.ops.repro_torch.flash_attention, attention_flops)


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_tc = 0


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
