"""Device milliseconds a PerturbNet step launches outside the kernels and
the optimizer: the device time launched inside the program's
``fit.pn_step`` spans and outside every ``kernel.*`` and ``optim.step``
span (the PerturbNet's products, both Fourier mappings, the loss and
autograd's elementwise work), over the steps."""
from portbench.metrics import _program


def read(run):
    recorded = _program.spans(run)
    if not recorded:
        return None
    steps = _program.intervals(recorded, "fit.pn_step")
    eager = _program.subtract(steps, _program.intervals(recorded, "kernel.", "optim.step"))
    device = _program.device_s(run["trace"], eager)
    return _program.per_span(device or None, recorded, "fit.pn_step")
