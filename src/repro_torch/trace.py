"""The port's spans, on ``torch.profiler``'s own clock.

``span(name)`` marks where a layer of the program does its work. While no
profiler records it is one shared no-op context; while one does, it is a
``RecordFunction`` of the ``FUNCTION`` scope, the scope of every ATen op:
it appears in the trace as a host op named ``name`` on the thread that
entered it, beside the ops it encloses, and makes no device-side copy.
(``torch.profiler.record_function`` is of the ``USER`` scope, whose span
CUPTI also draws on the device, from the first kernel it launched to the
last; a reader of the device's timeline would count that copy as an op.)
A span's device work is what its thread launched inside it, found through
each device op's link to the host op that launched it.

A profiler records the host ops of the thread that started it, or of every
thread with ``experimental_config=_ExperimentalConfig(
profile_all_threads=True)``. Every name starts with ``agocs.``; the
names, their threads and the metrics they serve are listed in README.md
("Tracing the port").
"""
from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)
