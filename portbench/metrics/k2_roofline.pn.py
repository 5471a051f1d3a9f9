"""K2's share of its roofline in the alternating phase: the least time of
the window's K2 work over the device time launched inside the program's
``kernel.siren_fused_bwd`` spans (the backward of ``siren_fused``, which
autograd runs on its device thread). The work is the INR's input gradient
of every PerturbNet step (the window's ``input_grad`` product at the INR's
widths); its bytes are x, the upstream gradient and the weights read and
dx written, float32, each once."""
from portbench.metrics import _count, _program


def _bytes(dims, rows: int) -> float:
    return _count.F32 * (2 * rows * int(dims[0]) + rows * int(dims[-1]) + _count.n_params(dims))


def read(run):
    recorded = _program.spans(run)
    if not recorded:
        return None
    products = run["window"]["products"]
    inr = [list(dims) for kind, dims, *_ in products if kind == "loss_grads"]
    least = sum(n * max(_count.flops(kind, dims, rows, slots) / _count.PEAK_FLOPS,
                        slots * _bytes(dims, rows) / _count.PEAK_BYTES)
                for kind, dims, rows, slots, n in products
                if kind == "input_grad" and list(dims) in inr)
    device = _program.device_s(run["trace"], _program.intervals(recorded, "kernel.siren_fused_bwd"))
    return 100.0 * least / device if least and device else None
