"""Plain PyTorch version: dense projection + cross-entropy, per-token NLL."""
from __future__ import annotations

from typing import Tuple

import torch

NEG = -1e30


def fused_ce_ref(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d); w: (Vp, d); labels: (T,) (<0 = ignore) -> (nll (T,), lse
    (T,)), both f32. The logits are taken in f32; columns at or past
    ``vocab_size`` are -1e30; ignored rows give an nll of exactly 0."""
    logits = torch.einsum("td,vd->tv", x.float(), w.float())
    cols = torch.arange(w.shape[0], device=x.device)
    logits = logits.masked_fill(cols[None, :] >= vocab_size, NEG)
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, safe[:, None])[:, 0]
    nll = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return nll, lse
