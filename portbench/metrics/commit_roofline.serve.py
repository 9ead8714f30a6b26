"""Kernel D's (sched_commit) share of its roofline, in %: the least time
its call's work needs over its device time per launch. D is a sequential
scan over the batch's tasks, so it is latency-bound and its share small."""
from portbench.harness import roofline


def read(inputs, window):
    if window is None:
        return None
    launches, seconds = window.letters()["D"]
    if not launches:
        return None
    least = roofline.bound_s(*inputs["work"]["D"])
    return 100.0 * least / (seconds / launches)
