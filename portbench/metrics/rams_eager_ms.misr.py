"""Device milliseconds a RAMS forward launches outside K6: the device time
launched inside the program's ``rams.forward`` spans and outside every
``kernel.conv3d_rfab`` span (the gates, the weight norms, the pads, the
residuals and the library convs), over the forwards."""
from portbench.metrics import _program


def read(run):
    recorded = _program.spans(run)
    if not recorded:
        return None
    forwards = _program.intervals(recorded, "rams.forward")
    eager = _program.subtract(forwards, _program.intervals(recorded, "kernel.conv3d_rfab"))
    device = _program.device_s(run["trace"], eager)
    return _program.per_span(device or None, recorded, "rams.forward")
