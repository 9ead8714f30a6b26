"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060], chunked.

A copy of ``repro.models.mamba`` in PyTorch. The sequence is processed in
chunks of Q tokens by a Python loop over chunks carrying the (B, H, P, N)
state in f32, as the reference's ``lax.scan`` carries it. Per-chunk score
matrices are (B, Q, Q, H), so peak memory is O(L·Q) not O(L²).

Layout: d_inner = expand * d_model, H = d_inner / head_dim SSD heads,
single B/C group of state size N, depthwise causal conv of width K over the
concatenated [x, B, C] channels.

One change from the reference: the intra-chunk decay is
``exp(where(i >= j, cumA_i - cumA_j, -inf))`` where the reference takes
``where(i >= j, exp(cumA_i - cumA_j), 0)``. The forward values are the same
bit for bit (``exp(-inf)`` is exactly 0), but the reference exponentiates
the upper triangle too, which overflows to inf once a chunk's decay passes
~88 in the exponent (chunk 128 at the families' dt and A scales), and its
gradient there is 0 * inf = NaN. Here the gradient is finite at any chunk
length, and equal to the reference's where that is finite.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models.layers import ParamDef, rms_norm


def param_defs(cfg) -> Dict[str, ParamDef]:
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * din + 2 * n + h          # z, x, B, C, dt
    conv_ch = din + 2 * n
    return {
        "in_proj": ParamDef((d, proj_out), ("embed", "ssm_proj")),
        "conv_w": ParamDef((cfg.ssm_conv, conv_ch), (None, "conv_ch"), scale=0.5),
        "conv_b": ParamDef((conv_ch,), ("conv_ch",), init="zeros"),
        "A_log": ParamDef((h,), ("ssm_heads",), init="ones"),
        "D": ParamDef((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "norm": ParamDef((din,), ("ssm_inner",), init="ones"),
        "out_proj": ParamDef((din, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :din]
    xBC = zxbcdt[..., din:2 * din + 2 * n]
    dt = zxbcdt[..., 2 * din + 2 * n:]
    assert dt.shape[-1] == h
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via K shifted adds. xBC: (B, L, CH); w: (K, CH)."""
    K, L = w.shape[0], xBC.shape[1]
    out = xBC * w[-1].to(xBC.dtype)
    for i in range(K - 1):
        shift = K - 1 - i
        shifted = F.pad(xBC, (0, 0, shift, 0))[:, :L]
        out = out + shifted * w[i].to(xBC.dtype)
    return F.silu(out + b.to(xBC.dtype))


def _conv(xBC, w, b):
    """:func:`_causal_conv`, independent for each batch row. DTensors go
    through ``local_map`` (batch over the data axes, channels whole; the
    kernel's and bias's gradients partial over the data ranks): DTensor's
    pad of a shift gives a gradient of the padded shape in torch 2.11."""
    if not sharding.is_dtensor(xBC):
        return _causal_conv(xBC, w, b)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, rules = sharding._current()
    x_pl = sharding.make_sharding(("batch", None, None), mesh,
                                  rules).placements
    rep = tuple(Replicate() for _ in x_pl)
    part = tuple(Partial() if isinstance(p, Shard) else p for p in x_pl)
    local_map, kw = sharding.import_shard_map()
    return local_map(_causal_conv, out_placements=list(x_pl),
                     in_placements=(x_pl, rep, rep),
                     in_grad_placements=(x_pl, part, part),
                     device_mesh=sharding.dtensor_mesh(mesh), **kw)(
        xBC, w, b)


def intra_chunk_decay(cumq: torch.Tensor) -> torch.Tensor:
    """(B, Q, H) inclusive cumulative dA of one chunk -> (B, Qi, Qj, H)
    ``exp(cumA_i - cumA_j)`` for i >= j and 0 above the diagonal, the
    exponent set to -inf there before the exp (finite gradients)."""
    Q = cumq.shape[1]
    upper = torch.ones((Q, Q), dtype=torch.bool,
                       device=cumq.device).triu(1)[None, :, :, None]
    diff = cumq[:, :, None, :] - cumq[:, None, :, :]
    return torch.exp(diff.masked_fill(upper, float("-inf")))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (B, L, H, P); dt: (B, L, H) (already softplus'ed); A: (H,) negative;
    Bm, Cm: (B, L, N). Returns (y (B, L, H, P), final_state (B, H, P, N)).
    """
    Bb, L, H, Pp = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q

    # the (B, L, ...) sequence tensors keep their input dtype; each chunk
    # casts its own slice to f32, as the reference does
    xc = xh.reshape(Bb, nc, Q, H, Pp)
    dtc = dt.reshape(Bb, nc, Q, H).float()
    Bc = Bm.reshape(Bb, nc, Q, N)
    Cc = Cm.reshape(Bb, nc, Q, N)

    dA = dtc * A.float()                             # (B, nc, Q, H), negative
    cumA = torch.cumsum(dA, dim=2)                   # inclusive within chunk

    state = (torch.zeros((Bb, H, Pp, N), dtype=torch.float32,
                         device=xh.device)
             if initial_state is None else initial_state)

    ys = []
    for c in range(nc):
        xq = xc[:, c].float()                        # (B, Q, H, P)
        dtq, cumq = dtc[:, c], cumA[:, c]            # (B, Q, H)
        bq, cq = Bc[:, c].float(), Cc[:, c].float()  # (B, Q, N)
        # intra-chunk: scores[b,i,j,h] = (C_i . B_j) * exp(cumA_i - cumA_j),
        # i >= j; the upper triangle's exponent is -inf before the exp
        cb = torch.einsum("bin,bjn->bij", cq, bq)    # (B, Q, Q)
        decay = intra_chunk_decay(cumq)              # (B, Qi, Qj, H)
        xdt = xq * dtq[..., None]                    # (B, Q, H, P)
        scores = cb[..., None] * decay               # (B, Qi, Qj, H)
        y_diag = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        # inter-chunk: state entering this chunk, decayed to each position
        y_off = torch.einsum("bin,bhpn->bihp", cq, state) * \
            torch.exp(cumq)[..., None]
        # state update: decay old state across chunk + this chunk's part
        decay_end = torch.exp(cumq[:, -1, :][:, :, None]
                              - cumq.transpose(1, 2))        # (B, H, Q)
        wgt = (decay_end * dtq.transpose(1, 2)).transpose(1, 2)  # (B, Q, H)
        contrib = torch.einsum("bjn,bjhp->bhpn", bq, xq * wgt[..., None])
        state = state * torch.exp(cumq[:, -1, :])[:, :, None, None] + contrib
        ys.append((y_diag + y_off).to(xh.dtype))
    y = torch.stack(ys, dim=1).reshape(Bb, L, H, Pp)
    return y, state


def _ssd(xh, dt, A, Bm, Cm, chunk: int):
    """:func:`ssd_chunked`, which is independent for each (batch row, SSD
    head). DTensors go through ``local_map``: batch over the data axes,
    heads over 'model' where the rules split them ('act_ssm_heads'); B and
    C are read by every head and A by every batch row, so their gradients
    are partial over the ranks that split those."""
    if not sharding.is_dtensor(xh):
        return ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    from torch.distributed.tensor import Partial, Shard
    mesh, rules = sharding._current()

    def pl(*axes):
        return sharding.make_sharding(axes, mesh, rules).placements
    x_pl = pl("batch", "seq", "act_ssm_heads", None)
    bc_pl = pl("batch", "seq", None)
    heads = pl("act_ssm_heads")
    bc_grad = tuple(Partial() if isinstance(h, Shard) else b
                    for b, h in zip(bc_pl, heads))
    # A is read by every batch row: partial over the ranks that split them
    a_grad = tuple(h if isinstance(h, Shard) else
                   Partial() if isinstance(b, Shard) else h
                   for b, h in zip(bc_pl, heads))
    local_map, kw = sharding.import_shard_map()
    return local_map(
        lambda a, b, c, d, e: ssd_chunked(a, b, c, d, e, chunk),
        out_placements=(x_pl, pl("batch", "act_ssm_heads", None, None)),
        in_placements=(x_pl, pl("batch", "seq", "act_ssm_heads"), heads,
                       bc_pl, bc_pl),
        in_grad_placements=(x_pl, pl("batch", "seq", "act_ssm_heads"),
                            a_grad, bc_grad, bc_grad),
        device_mesh=sharding.dtensor_mesh(mesh), **kw)(xh, dt, A, Bm, Cm)


def apply(params, cfg, x: torch.Tensor, *, return_state: bool = False):
    """Train/prefill forward. x: (B, L, d)."""
    Bb, L, d = x.shape
    din, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = _conv(xBC, params["conv_w"], params["conv_b"])
    xs, Bm, Cm = xBC[..., :din], xBC[..., din:din + n], xBC[..., din + n:]
    xs = logical_constraint(xs, "batch", "seq", "ssm_inner")

    dt_f = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())

    xh = xs.reshape(Bb, L, h, p)
    y, state = _ssd(xh, dt_f, A, Bm, Cm, cfg.ssm_chunk)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(Bb, L, din)

    # gated RMSNorm then output projection
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"],
                 cfg.norm_eps)
    out = y @ params["out_proj"].to(x.dtype)
    if return_state:
        return out, {"ssm": state, "conv": xBC_tail(cfg, x, zxbcdt)}
    return out


def xBC_tail(cfg, x, zxbcdt):
    """Last (conv_width - 1) pre-conv xBC rows — the decode conv window."""
    _, xBC_raw, _ = _split_proj(cfg, zxbcdt)
    k = cfg.ssm_conv
    return xBC_raw[:, -(k - 1):, :].float()


def init_state(cfg, batch: int, device=None) -> Dict[str, torch.Tensor]:
    din, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "ssm": torch.zeros((batch, h, p, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * n),
                            dtype=torch.float32, device=device),
    }


def state_axes(cfg) -> Dict[str, Tuple[Optional[str], ...]]:
    return {
        "ssm": ("batch", "act_ssm_heads", None, None),
        "conv": ("batch", None, "conv_ch"),
    }


def decode(params, cfg, x: torch.Tensor, state: Dict[str, torch.Tensor]
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, d). Returns (out, the new state); the
    state passed in is not written."""
    Bb = x.shape[0]
    din, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xBC_new, dt = _split_proj(cfg, zxbcdt)

    # conv over ring buffer
    window = torch.cat([state["conv"].to(x.dtype), xBC_new], dim=1)  # (B, K, ch)
    conv_out = (window * params["conv_w"].to(x.dtype)).sum(1)
    xBC = F.silu(conv_out + params["conv_b"].to(x.dtype))[:, None, :]
    new_conv = window[:, 1:, :].float()

    xs, Bm, Cm = xBC[..., :din], xBC[..., din:din + n], xBC[..., din + n:]
    dt_f = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())

    xh = xs.reshape(Bb, h, p).float()
    dt1 = dt_f[:, 0, :]                                # (B, H)
    dA = torch.exp(dt1 * A)                            # (B, H)
    contrib = (Bm[:, 0].float()[:, None, None, :]
               * (dt1[:, :, None] * xh)[..., None])    # (B, H, P, N)
    new_ssm = state["ssm"] * dA[:, :, None, None] + contrib
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), new_ssm)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(Bb, 1, din).to(x.dtype)

    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"],
                 cfg.norm_eps)
    out = y @ params["out_proj"].to(x.dtype)
    return out, {"ssm": new_ssm, "conv": new_conv}
