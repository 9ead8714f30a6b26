"""The paper's own built-in scenario: Google Cluster cell A — 12.5K nodes,
~140K concurrently-running tasks, month-long trace, 5-second windows."""
from repro_torch.config import SimConfig

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


def get_sim_config() -> SimConfig:
    return CONFIG
