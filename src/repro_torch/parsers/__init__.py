"""Trace-family parser registry: the GCD family and Alibaba's OpenB.

Every parser streams its on-disk format into the ``HostEvent``/``EventWindow``
contract, so ``simulate``/``whatif``/``precompile`` pick a family by name and
the device programs never know the difference. Built-in families register
on import; external plugins call :func:`register_parser` themselves.
"""
from repro_torch.parsers.base import (ParseStats, SlotAllocator, AttrVocab,
                                      TraceParser, PARSERS, register_parser,
                                      get_parser, describe_parsers)
from repro_torch.parsers.gcd import GCDParser
from repro_torch.parsers.alibaba_openb import AlibabaOpenBParser

__all__ = ["ParseStats", "SlotAllocator", "AttrVocab", "TraceParser",
           "PARSERS", "register_parser", "get_parser", "describe_parsers",
           "GCDParser", "AlibabaOpenBParser", "default_start_us"]


def default_start_us(family: str, cfg) -> int:
    """The window-0 time origin a family's trace expects.

    GCD declares pre-existing machines during its 10-minute shift, so its
    runs start one window before the shift; OpenB times start at 0.
    """
    cls = get_parser(family)
    fn = getattr(cls, "default_start_us", None)
    if fn is not None:
        return int(fn(cfg))
    return 0
