"""Percent of the traced window in which no operation ran on the device
(one minus the union of the device's kernel, copy and set intervals)."""
from portbench.metrics import _count


def read(run):
    return _count.idle_share(run)
