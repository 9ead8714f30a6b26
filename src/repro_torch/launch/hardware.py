"""NVIDIA H100 SXM (80 GB HBM3) model used for the roofline analysis.

The dry-run plans for this card (``launch/dryrun.py``). These constants
turn the planner's per-device counts into roofline seconds. Source:
NVIDIA's H100 data sheet, SXM part, dense rates without sparsity, at the
full power limit of 700 W (``nvidia-smi`` reports the card as "NVIDIA
H100 80GB HBM3, 700.00 W"); a card set to a lower limit runs slower under
load. The interconnect is that of an 8-GPU HGX node: NVLink within the
node, one 400 Gb/s NDR InfiniBand port a GPU between nodes.
"""
from __future__ import annotations

import torch

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = 989e12      # tensor cores, bf16/f16, dense, per card
PEAK_FLOPS_F32 = 67e12        # float32 outside the tensor cores, per card
HBM_BW = 3.35e12              # bytes/s per card
HBM_BYTES = 80 * 10**9        # 80 GB per card
NVLINK_BW = 450e9             # bytes/s per card, each way, within a node
IB_BW = 50e9                  # bytes/s per card between nodes (400 Gb/s)
NODE_GPUS = 8                 # cards joined by NVLink in one node

# Effective wire-bytes multiplier per collective kind (ring algorithms):
#   all-reduce moves ~2x the payload ((n-1)/n reduce-scatter + (n-1)/n all-gather),
#   the others move ~1x. Payload accounting (see launch/plan_cost.py) counts
#   each rank's local output, so shapes are already per-shard.
COLLECTIVE_WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_NAMED = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}
#: bytes of an element, by the reference's (HLO) names and by torch dtype
DTYPE_BYTES = {
    **_NAMED,
    torch.bool: 1, torch.int8: 1, torch.uint8: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int16: 2, torch.float16: 2, torch.bfloat16: 2,
    torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}


def link_bw(n_ranks: int) -> float:
    """Bytes/s a card moves in a collective over ``n_ranks`` cards: NVLink
    within one node, InfiniBand once the group spans nodes (every mesh
    axis of 16 spans two)."""
    return IB_BW if n_ranks > NODE_GPUS else NVLINK_BW
