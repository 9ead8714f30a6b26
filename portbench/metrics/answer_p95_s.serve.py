"""The 95th percentile of the window's answers' latency, from a client's
submit to its answer, in seconds."""
import numpy as np


def read(inputs, window):
    lat = inputs["latencies"]
    return float(np.percentile(lat, 95)) if lat else None
