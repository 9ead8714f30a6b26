"""Paper-scale ingestion geometry: cell A over the FULL month-long trace.

``agocs_cell_a`` is the paper's cell *shape*; this config is the same cell
sized for ingesting the complete 2011 trace span — 29 days of 5-second
windows (:data:`MONTH_WINDOWS` = 501,120). At this scale the trace stack
does not fit in host RAM as one materialised list (≈0.5 MB/window × 500K
windows), which is exactly what the streaming pre-compiler exists for:
peak host memory stays O(``shard_windows``) regardless of the horizon.

``tracegen.generate_paper_scale_trace`` synthesises a GCD-schema trace at
this node count.
"""
from repro_torch.config import SimConfig
# 29 days x 86,400 s/day / 5 s-per-window — the GCD v2 trace span (501,120)
from repro_torch.core.tracegen import MONTH_WINDOWS

CONFIG = SimConfig(
    max_nodes=12_500,
    max_tasks=262_144,
    max_events_per_window=8_192,
    window_us=5_000_000,
    n_parser_workers=5,
    buffer_windows=360,          # 30 sim-minutes ahead (paper Sec III)
    buffer_max_events=1_000_000, # paper's hard buffer limit
    scheduler="greedy",
)

__all__ = ["CONFIG", "MONTH_WINDOWS"]
