"""Device milliseconds a window of every kernel that is not one of the
hand-written A-E: the engine's and the scenario passes' plain PyTorch."""


def read(inputs, window):
    if window is None or not inputs["windows"]:
        return None
    launches, seconds = window.letters()["glue"]
    return seconds * 1e3 / inputs["windows"] if launches else None
