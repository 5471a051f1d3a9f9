"""Device idle milliseconds a dense-grid request: the device's idle time
while the host is inside the program's ``infer.request`` spans
(``fit/engine.py``'s ``infer_dense_grid``), over the requests."""
from portbench.metrics import _program


def read(run):
    recorded = _program.spans(run)
    if not recorded:
        return None
    idle = _program.idle_s(run["trace"], _program.intervals(recorded, "infer.request"))
    return _program.per_span(idle, recorded, "infer.request")
