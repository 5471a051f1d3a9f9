"""The fits' model FLOPs in the traced window (every product of every step:
forward, weight and input gradients, the PerturbNet and the Fourier
mapping where they run) over the chip's bf16 peak for the window."""
from portbench.metrics import _count


def read(run):
    return _count.mfu(run)
