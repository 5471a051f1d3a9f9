"""K6's share of its roofline in RAMS serving: the least time of the 34
3x3x3 body convs of every request in the traced window (``_conv.py``, from
the configuration's shapes: bf16 input, kernel and output, float32 bias)
over the device time launched inside the program's ``kernel.conv3d_rfab``
spans."""
from portbench.metrics import _conv, _program


def read(run):
    recorded = _program.spans(run)
    if not recorded:
        return None
    w = run["window"]
    least = w["requests"] * _conv.body_least_s(w["convs"])
    device = _program.device_s(run["trace"], _program.intervals(recorded, "kernel.conv3d_rfab"))
    return 100.0 * least / device if least and device else None
