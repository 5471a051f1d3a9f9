"""The 2-D ensemble's model FLOPs in the traced window (each batched
update's forward, weight and input gradients for every direction, and the
tail's predictions on both grids) over the chip's bf16 peak for the
window."""
from portbench.metrics import _count


def read(run):
    return _count.mfu(run)
