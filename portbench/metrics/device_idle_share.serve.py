"""The share of the traced window in which no operation ran on the device,
in %."""


def read(inputs, window):
    if window is None or window.window_s <= 0:
        return None
    return 100.0 * (window.window_s - window.busy_s()) / window.window_s
