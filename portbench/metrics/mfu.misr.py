"""RAMS serving's model FLOPs in the traced window (every 3-D, 2-D and
1x1 conv of every request's forward, ``_conv.py``'s count from the
configuration's shapes) over the chip's bf16 peak for the window."""
from portbench.metrics import _conv, _count


def read(run):
    trace = run.get("trace")
    if trace is None or trace.busy_s() is None:  # no device activity traced
        return None
    w = run["window"]
    work = w["requests"] * _conv.forward_flops(w["convs"])
    return 100.0 * work / (trace.window_s() * _count.PEAK_FLOPS)
