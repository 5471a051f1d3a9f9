"""Profiling: the program's spans and a Chrome-trace exporter.

- ``span(name)``: a named range around a layer's work, as a context manager
  or a decorator. While a ``torch.profiler`` collects, a span opens a
  profiler range under its name (so that the Chrome trace shows it and the
  device work launched inside it can be tied to it) and keeps
  ``Span(name, thread, parent, start_ns, end_ns)`` in memory, timed on
  ``time.time_ns()``, the clock of the profiler's events. With no profiler
  collecting it opens and keeps nothing: tracing is on exactly while a
  profiler runs, and there is no other switch.
- ``recorded()`` and ``clear()``: the spans kept, in the order they closed.
- ``trace``: a ``torch.profiler`` trace of the block it wraps, written as a
  Chrome trace (``trace.json``) into a directory.

Counters stay beside the code they count: ``ops/siren_kernel.py``'s
``LAUNCHES`` (kernel launches by route), ``ops/conv3d_kernel.py``'s
``LAUNCHES`` (K6 and K7 launches on the card: ``conv3d_rfab``, 34 a RAMS
forward at the reference architecture, and ``conv3d_rfab_bwd``),
``fit/optim.py``'s ``count`` and ``step_index`` (updates, by slot in
``StackedAdam``).
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import NamedTuple

import torch

_collecting = torch._C._autograd._profiler_enabled  # one C call: is a profiler on?
# a RecordFunction range for Python callers at about 1 us, where
# ``torch.profiler.record_function`` costs about 15 us
_Range = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    thread: int  # ``threading.get_ident()`` of the thread it ran on
    parent: str | None  # the innermost span open on that thread when it opened
    start_ns: int
    end_ns: int


_recorded: list[Span] = []
_open = threading.local()  # ``.names``: the names of the spans open on this thread


def recorded() -> list[Span]:
    """The spans closed while a profiler collected, since the last
    :func:`clear`, in the order they closed."""
    return list(_recorded)


def clear() -> None:
    _recorded.clear()


class span:
    """A named range of the program's work: ``with span("infer.chunk"):`` or
    ``@span("optim.step")`` (a fresh range each call). Off (no profiler
    collecting) it costs one check; on, it opens a profiler range, and on
    exit, raising or not, keeps its :class:`Span`. Its times lie inside the
    profiler's own range, which opens before the start is read and closes
    after the end is."""

    __slots__ = ("name", "_range", "_parent", "_start")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> span:
        if not _collecting():
            return self
        names = getattr(_open, "names", None)
        if names is None:
            names = _open.names = []
        self._range = _Range(self.name)
        self._range.__enter__()
        self._parent = names[-1] if names else None
        names.append(self.name)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        rng = self._range
        if rng is None:
            return
        end = time.time_ns()
        self._range = None
        _open.names.pop()
        _recorded.append(Span(self.name, threading.get_ident(), self._parent, self._start, end))
        rng.__exit__(*exc)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _collecting():
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)

        return spanned


@contextlib.contextmanager
def trace(logdir: str | None):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    when a card is present), its Chrome trace written to
    ``<logdir>/trace.json``, where the program's spans are named ranges; a
    no-op without ``logdir``. Yields the profiler (``None`` when off)."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
