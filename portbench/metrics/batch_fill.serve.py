"""Live lanes over all lanes the server launched in the window, in %
(``ServiceMetrics.lanes`` and ``padded_lanes``)."""


def read(inputs, window):
    total = inputs["lanes"] + inputs["padded"]
    return 100.0 * inputs["lanes"] / total if total else None
