"""Device launches (kernels, copies, fills) in the traced window over the
windows it simulated: the driver's and the glue's launch count a window."""


def read(inputs, window):
    if window is None or not inputs["windows"]:
        return None
    return len(window.device_ops) / inputs["windows"]
