"""Host milliseconds a call of the optimizer's ``step`` (``fit/optim.py``'s
``Adam`` or ``StackedAdam``, as the fit loop calls it), from the span the
benchmark wraps around it in the traced window."""


def read(run):
    return run["spans"].host_ms_per_call("optim")
