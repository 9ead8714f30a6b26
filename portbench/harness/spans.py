"""The program's spans in a traced window: the program span the
dispatching thread was in when each idle gap of the device began, and the
device launches and time of the work launched inside each span.

A program span is a host op whose name starts with ``agocs.`` (the port's
``repro_torch.trace.span``). It makes no device-side copy, so the device
ops of :class:`~portbench.harness.profile.Window` read the same with the
spans as without them. A span's device work is found through each device
op's link to the host op that launched it (``linked_correlation_id``),
and that op's innermost span on its own thread. On a program without such
spans the readers here find nothing.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

from portbench.harness.common import WINDOW_SPAN
from portbench.harness.profile import Window

PREFIX = "agocs."
# the spans in which a thread waits for work: the driver's next batch,
# the service's queue
WAITS = ("agocs.driver.next_batch", "agocs.service.wait")
OUTSIDE = "no_program_span"
UNLINKED = "no_host_op"

Span = Tuple[int, int, str]


def innermost(spans: Sequence[Span], times: Sequence[int]
              ) -> List[Optional[str]]:
    """The innermost of the nested ``spans`` (start, end, name), sorted by
    (start, -end), that holds each of the ascending ``times`` (None where
    none does)."""
    starts = [s[0] for s in spans]
    out: List[Optional[str]] = []
    stack: List[Span] = []
    i = 0
    for t in times:
        j = bisect.bisect_right(starts, t)
        while i < j:
            sp = spans[i]
            while stack and stack[-1][1] < sp[0]:
                stack.pop()
            stack.append(sp)
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def idle_by_program_span(window: Window) -> Optional[Dict[str, float]]:
    """Idle seconds of the device by the program span the dispatching
    thread was in when each gap began (``no_program_span`` where it was in
    none); None when that thread recorded no program span."""
    spans = [op for op in window.host_ops if op[2].startswith(PREFIX)]
    if not spans:
        return None
    gaps = window.gaps()
    out: Dict[str, float] = collections.defaultdict(float)
    for (g0, g1), name in zip(gaps, innermost(spans, [g[0] for g in gaps])):
        out[name or OUTSIDE] += (g1 - g0) / 1e9
    return dict(out)


def wait_idle_share(window: Optional[Window]) -> Optional[float]:
    """The share of the window, in %, in which the device was idle while
    the dispatching thread waited for work (a gap that began inside one of
    :data:`WAITS`)."""
    if window is None or window.window_s <= 0:
        return None
    idle = idle_by_program_span(window)
    if idle is None:
        return None
    return 100.0 * sum(idle.get(n, 0.0) for n in WAITS) / window.window_s


def _torch_op(name: str) -> bool:
    """A host op of torch's recorder (an ATen or custom op, or a program
    span), which a device op links to. The host events of the CUDA runtime
    and driver and the profiler's own (``cudaLaunchKernel``, ``Command
    Buffer Full``) carry CUPTI's correlation ids, another numbering."""
    return "::" in name or name.startswith(PREFIX)


def device_by_span(events: Iterable, t0: int, t1: int, skip: str,
                   keep: Callable[[str], bool] = lambda name: True
                   ) -> Dict[str, Tuple[int, float]]:
    """Span name -> (launches, device seconds) of the device ops inside
    [t0, t1] (clipped to it, as ``Window.device_ops``; ops named ``skip``
    left out) whose name ``keep`` takes, each put under the innermost
    program span that held the host op which launched it, on that op's
    thread: ``no_program_span`` when none did, ``no_host_op`` when the op
    has no recorded host op."""
    launcher: Dict[int, Tuple[int, int]] = {}
    spans: Dict[int, List[Span]] = collections.defaultdict(list)
    device = []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if s + d >= t0 and s <= t1 and e.name() != skip and \
                    keep(e.name()):
                device.append((max(s, t0), min(s + d, t1),
                               e.linked_correlation_id()))
        elif not e.linked_correlation_id() and _torch_op(e.name()):
            tid = e.start_thread_id()
            launcher[e.correlation_id()] = (tid, s)
            if e.name().startswith(PREFIX):
                spans[tid].append((s, s + d, e.name()))
    asks: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(list)
    where: List[str] = [UNLINKED] * len(device)
    for k, (_, _, corr) in enumerate(device):
        if corr and corr in launcher:
            tid, t = launcher[corr]
            asks[tid].append((t, k))
    for tid, ask in asks.items():
        ask.sort()
        held = sorted(spans[tid], key=lambda x: (x[0], -x[1]))
        for (_, k), name in zip(ask, innermost(held, [t for t, _ in ask])):
            where[k] = name or OUTSIDE
    out: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    for (s, e, _), name in zip(device, where):
        out[name][0] += 1
        out[name][1] += (e - s) / 1e9
    return {n: (c, t) for n, (c, t) in out.items()}


class SpanWindow(Window):
    """A :class:`Window` that also keeps :func:`device_by_span` of every
    device op (``by_span``) and of the copies from pageable host memory
    (``pageable_by_span``)."""

    def __init__(self, prof, span: str):
        super().__init__(prof, span)
        events = list(prof.profiler.kineto_results.events())
        self.by_span = device_by_span(events, self.t0, self.t1, span)
        self.pageable_by_span = device_by_span(
            events, self.t0, self.t1, span, lambda name: "Pageable" in name)


@contextlib.contextmanager
def all_threads_profile(job, holder: dict):
    """``common.window_profile`` with the host ops of every thread of the
    process recorded (the service's batcher, the prefetcher's fill
    thread); ``holder['window']`` gets a :class:`SpanWindow`."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(job.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield
    holder["window"] = SpanWindow(prof, WINDOW_SPAN)
