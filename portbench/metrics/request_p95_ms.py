"""The 95th percentile of every request's latency in the window, each timed
on the host clock from its call to its result in hand on the host."""
import numpy as np


def read(run):
    lat = run["window"].get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
