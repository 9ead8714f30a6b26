"""The share of the traced window, in %, in which the device was idle while
the driver waited for its next batch: the gaps that began inside the
program's ``agocs.driver.next_batch`` span (``harness/spans``)."""
from portbench.harness import spans


def read(inputs, window):
    return spans.wait_idle_share(window)
