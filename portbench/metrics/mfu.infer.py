"""The requests' model FLOPs in the traced window (the Fourier mapping and
the INR forward of every row served) over the chip's bf16 peak for the
window."""
from portbench.metrics import _count


def read(run):
    return _count.mfu(run)
