"""What every entry's driver shares: the timed window loop, the capture of
the first optimizer updates, and the faults a check plants in the timed
path.

A driver builds the program's state from the seed in ``setup`` (the first
call into the program doubles as the warm-up and as the steps the check
follows), drives the window in ``window``, hands over what the check
compares in ``observations`` and the raw inputs in ``inputs``, and frees
the program's state in ``free``. ``fault=`` plants what a check must catch
(``calibrate.py``, the CPU tests): ``"unchanged"`` (no update changes the
state), ``"half_batch"`` (half of the rows left out, the mean taken over
the rest), ``"altered"`` (one answer altered where it is produced).
"""
from __future__ import annotations

import contextlib
import time

import torch

from portbench import spans

ADAM_B1 = 0.9


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(seconds: float, device, recorder: spans.Recorder, one) -> float:
    """Call ``one()`` until ``seconds`` have passed on the host clock, then
    wait for the device; returns the window's seconds, from a synchronised
    start to the synchronised end of the last call's work."""
    sync(device)
    label = (torch.profiler.record_function(spans.PREFIX + "window") if recorder.active
             else contextlib.nullcontext())
    with label:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            one()
        sync(device)
        return time.perf_counter() - t0


def mu_leaves(opt) -> list[torch.Tensor]:
    """The first moments of ``fit/optim.py``'s ``Adam`` (a list like its
    params) or ``StackedAdam`` (one flat buffer, laid out as its params'
    buffer), as tensors shaped like the params."""
    if isinstance(opt.mu, torch.Tensor):
        return [opt.mu.as_strided(p.shape, p.stride(), p.storage_offset())
                for p in opt.params]
    return list(opt.mu)


class FirstUpdates:
    """Wraps an optimizer's ``step`` for the set-up's first updates: after
    the first it keeps the gradient the optimizer took, worked out from its
    state (mu = (1 - b1) g after one step of Adam from zero moments); after
    the ``n``-th it keeps the params. With ``fault="unchanged"`` no update
    is taken."""

    def __init__(self, opt, n: int, fault: str | None):
        self.opt, self.n, self.fault = opt, n, fault
        self.step, self.grad, self.params = opt.step, None, None
        self.calls = 0

    def __call__(self, grads, *args, **kwargs):
        if self.fault != "unchanged":
            self.step(grads, *args, **kwargs)
        self.calls += 1
        if self.calls == 1:
            self.grad = [m.detach().clone() / (1.0 - ADAM_B1) for m in mu_leaves(self.opt)]
        if self.calls == self.n:
            self.params = [p.detach().clone() for p in self.opt.params]


def first_calls(fn, n: int, keep: list):
    """``fn`` that also keeps (a detached copy of) each of its first ``n``
    results in ``keep``."""
    def kept(*args, **kwargs):
        out = fn(*args, **kwargs)
        if len(keep) < n:
            keep.append(_detach(out))
        return out

    return kept


def _detach(out):
    if isinstance(out, torch.Tensor):
        return out.detach().clone()
    if isinstance(out, (list, tuple)):
        return type(out)(_detach(o) for o in out)
    return out


def to_host(obj):
    """Tensors (in lists, tuples and dicts) copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu")
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(o) for o in obj)
    return obj


def mlp_signature(kind: str, weighted: bool = False):
    """A span signature ``(kind, dims, rows, slots, weighted)`` from the
    ``(params, x, ...)`` of a value-and-grad or apply call."""
    def signature(params, x, *rest):
        W = params[0::2]
        slots = int(W[0].shape[0]) if W[0].dim() == 3 else 1
        dims = (int(x.shape[-1]),) + tuple(int(w.shape[-2]) for w in W)
        return (kind, dims, int(x.shape[0]), slots, weighted)

    return signature
