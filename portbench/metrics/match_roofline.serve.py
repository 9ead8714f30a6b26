"""Kernel A's (constraint_match) share of its roofline, in %: the least
time its call's work needs over its device time per launch."""
from portbench.harness import roofline


def read(inputs, window):
    if window is None:
        return None
    launches, seconds = window.letters()["A"]
    if not launches:
        return None
    least = roofline.bound_s(*inputs["work"]["A"])
    return 100.0 * least / (seconds / launches)
