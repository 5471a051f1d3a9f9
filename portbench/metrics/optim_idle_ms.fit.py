"""Device idle milliseconds an optimizer step: the device's idle time while
the host is inside the program's ``optim.step`` spans (``fit/optim.py``'s
``Adam`` and ``StackedAdam``), over the steps."""
from portbench.metrics import _program


def read(run):
    recorded = _program.spans(run)
    if not recorded:
        return None
    idle = _program.idle_s(run["trace"], _program.intervals(recorded, "optim.step"))
    return _program.per_span(idle, recorded, "optim.step")
