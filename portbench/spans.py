"""Spans around the callables the benchmark hands into the program.

In a traced run (``--trace 1``) each callable the harness passes into a fit
or an inference (the value-and-grad function, the ``apply_fn``, an
optimizer's ``step``) is wrapped: the wrapper adds the call's host time and
the shape signature of its work to a :class:`Recorder`, and opens a
``torch.profiler.record_function`` range named ``portbench.<name>`` so that
the trace's launches inside it can be tied to their kernels. In an untimed
set-up or an untraced run the callables go in unwrapped.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Callable

PREFIX = "portbench."


class Recorder:
    """Host time and work signatures per span name, for one run."""

    def __init__(self, active: bool):
        self.active = active
        self.calls: Counter = Counter()
        self.host_ns: Counter = Counter()
        self.work: dict[str, Counter] = {}

    def wrap(self, name: str, fn: Callable, signature: Callable | None = None) -> Callable:
        """``fn`` itself when the recorder is off; else ``fn`` inside a span
        ``name`` whose ``signature(*args)`` (hashable, or None) is counted."""
        if not self.active:
            return fn
        from torch.profiler import record_function

        label = PREFIX + name

        def spanned(*args, **kwargs):
            t0 = time.perf_counter_ns()
            with record_function(label):
                out = fn(*args, **kwargs)
            self.host_ns[name] += time.perf_counter_ns() - t0
            self.calls[name] += 1
            if signature is not None:
                self.work.setdefault(name, Counter())[signature(*args)] += 1
            return out

        return spanned

    def host_ms_per_call(self, name: str) -> float | None:
        n = self.calls.get(name, 0)
        return self.host_ns[name] / n / 1e6 if n else None
