"""K3's share of its roofline in dense-grid inference: the least time of
the forward of every ``apply_fn`` call in the traced window (the encoded
chunk and the weights read, the output written) over the device time of
all the call launched."""
from portbench.metrics import _count


def read(run):
    return _count.span_roofline_share(run, "apply")
