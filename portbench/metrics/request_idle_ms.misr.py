"""Device idle milliseconds a RAMS request: the device's idle time while the
host is inside the program's ``misr.request`` spans (``pipelines/misr.py``'s
``predict_case``: the host's draws and copies, and its launches),
over the requests."""
from portbench.metrics import _program


def read(run):
    recorded = _program.spans(run)
    if not recorded:
        return None
    idle = _program.idle_s(run["trace"], _program.intervals(recorded, "misr.request"))
    return _program.per_span(idle, recorded, "misr.request")
