"""The batched K1-w's share of its roofline in the 2-D ensemble: the least
time of the work of every value-and-grad call in the traced window
(forward, dW, the input gradients of all layers but the first, for each of
the stacked models; x, their targets, sample weights and weights read,
gradients written) over the device time of all the call launched."""
from portbench.metrics import _count


def read(run):
    return _count.span_roofline_share(run, "vag")
