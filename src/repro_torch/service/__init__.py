"""Persistent what-if serving (ROADMAP: "what-if-as-a-service").

A :class:`WhatIfServer` keeps a warm fleet geometry and the trace stack
on the card between queries, micro-batches compatible strangers into one
lane-batched launch, and serves fork-point queries from mid-trace fleet
snapshots — so an interactive caller pays for the windows it asks about
instead of a cold CLI run's parse and a replay from window 0.

    from repro_torch.service import WhatIfServer, WhatIfQuery
    with WhatIfServer(cfg, "stack.npz", schedulers=("greedy", "first_fit"),
                      max_lanes=8) as srv:
        srv.build_fork_points(trunk_specs, every=32)
        r = srv.query(WhatIfQuery(spec, n_windows=64, start_window=32))
        print(r.row, r.total_s)

CLI front end: ``python -m repro_torch.launch.whatif --serve ...`` (or
``python -m repro_torch.launch.serve_whatif``); both take ``--device cpu``
for the plain PyTorch path.
"""
from repro_torch.service.batcher import MicroBatcher, Ticket
from repro_torch.service.engine_cache import EngineCache
from repro_torch.service.forkpoint import ForkPointStore, build_fork_points
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.protocol import (ErrorCode, ServingError,
                                          WhatIfQuery, WhatIfResult,
                                          decode_query, decode_result,
                                          encode_query, encode_result,
                                          spec_from_dict, spec_to_dict)
from repro_torch.service.server import WhatIfServer

__all__ = [
    "EngineCache", "ErrorCode", "ForkPointStore", "MicroBatcher",
    "ServiceMetrics", "ServingError", "Ticket", "WhatIfQuery",
    "WhatIfResult", "WhatIfServer", "build_fork_points", "decode_query",
    "decode_result", "encode_query", "encode_result", "spec_from_dict",
    "spec_to_dict",
]
