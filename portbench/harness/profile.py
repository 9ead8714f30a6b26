"""Reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer metrics and the result's ``breakdown`` read: device busy
time, device time and count by kernel, the longest idle gaps by what the
dispatching host thread was doing, and the harness's own spans.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

# the program's hand-written kernels by the name CUPTI reports for them
KERNELS = {
    "A": ("constraint_match_kernel",),
    "B": ("placement_commit_kernel",),
    "C": ("window_stats_kernel",),
    "D": ("sched_commit_kernel",),
    "E": ("radix_hist_kernel", "radix_scan_kernel", "radix_scatter_kernel",
          "segment_sum_kernel"),
}
_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
           "cuLaunchKernelEx")


def _is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def kernel_letter(name: str) -> Optional[str]:
    for letter, subs in KERNELS.items():
        if any(s in name for s in subs):
            return letter
    return None


class Window:
    """The traced window [t0, t1] (ns on the profiler's clock)."""

    def __init__(self, prof, span: str):
        evs = list(prof.profiler.kineto_results.events())
        marks = [e for e in evs if e.name() == span]
        if not marks:
            raise RuntimeError(f"no {span!r} span in the trace")
        m = min(marks, key=lambda e: str(e.device_type()).endswith("CUDA"))
        self.t0, self.t1 = m.start_ns(), m.end_ns()
        self.window_s = (self.t1 - self.t0) / 1e9
        dev, cpu, launches = [], [], collections.Counter()
        for e in evs:
            s, d = e.start_ns(), e.duration_ns()
            if s + d < self.t0 or s > self.t1:
                continue
            if e.name() == span:          # the span's device-side copy
                continue
            if str(e.device_type()).endswith("CUDA"):
                dev.append((max(s, self.t0), min(s + d, self.t1), e.name()))
            else:
                cpu.append((s, s + d, e.name(), e.start_thread_id()))
                if e.name() in _LAUNCH:
                    launches[e.start_thread_id()] += 1
        dev.sort()
        self.device_ops = dev
        self.kernels = [d for d in dev if not _is_copy(d[2])]
        # the thread that launched most kernels is the one that paces them
        self.dispatch_thread = (launches.most_common(1)[0][0] if launches
                                else None)
        # the window's own span is left out: a gap inside no op of the
        # program is 'no_host_op'
        self.host_ops = sorted(
            ((s, e, n) for s, e, n, t in cpu
             if t == self.dispatch_thread and n not in _LAUNCH and n != span),
            key=lambda x: (x[0], -x[1]))

    def busy_s(self) -> float:
        """The union of device op intervals inside the window."""
        total, end = 0, None
        for s, e, _ in self.device_ops:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def by_kernel(self) -> Dict[str, Tuple[int, float]]:
        """name -> (count, device seconds) over every device op."""
        out: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
        for s, e, n in self.device_ops:
            out[n][0] += 1
            out[n][1] += (e - s) / 1e9
        return {n: (c, t) for n, (c, t) in out.items()}

    def letters(self) -> Dict[str, Tuple[int, float]]:
        """A-E and 'glue' (every other kernel) -> (launches, seconds)."""
        out = {k: [0, 0.0] for k in list(KERNELS) + ["glue"]}
        for s, e, n in self.kernels:
            k = kernel_letter(n) or "glue"
            out[k][0] += 1
            out[k][1] += (e - s) / 1e9
        return {k: (c, t) for k, (c, t) in out.items()}

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle intervals of the device inside the window."""
        out, cur = [], self.t0
        for s, e, _ in self.device_ops:
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if self.t1 > cur:
            out.append((cur, self.t1))
        return out

    def idle_by_host_op(self) -> Dict[str, float]:
        """Idle seconds by the innermost op the dispatching thread was in
        when each gap began ('no_host_op' when it was in none)."""
        ops = self.host_ops
        starts = [o[0] for o in ops]
        out: Dict[str, float] = collections.defaultdict(float)
        stack: List[Tuple[int, int, str]] = []
        i = 0
        for g0, g1 in self.gaps():
            j = bisect.bisect_right(starts, g0)
            while i < j:
                op = ops[i]
                while stack and stack[-1][1] < op[0]:
                    stack.pop()
                stack.append(op)
                i += 1
            while stack and stack[-1][1] < g0:
                stack.pop()
            out[stack[-1][2] if stack else "no_host_op"] += (g1 - g0) / 1e9
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, t) for n, (c, t) in self.by_kernel().items()),
                     key=lambda x: -x[1])[:top]
        gaps = sorted(self.idle_by_host_op().items(), key=lambda x: -x[1])
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": [[n[:120], t] for n, t in gaps[:top]]}
