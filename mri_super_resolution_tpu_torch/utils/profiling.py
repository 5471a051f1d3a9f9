"""Profiling and throughput accounting.

Counterpart of ``mri_super_resolution_tpu/utils/profiling.py``:
- ``Throughput``: items/sec counters (voxels/sec, BASELINE.json's
  north-star metric);
- ``trace``: a ``torch.profiler`` trace of the block it wraps, written as a
  Chrome trace (``trace.json``) into a directory;
- ``time_jitted``: the median wall-clock seconds of a call after warm-up,
  fenced with ``torch.cuda.synchronize()`` on the card (a CUDA call returns
  before its work is done).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable

import torch


@dataclasses.dataclass
class Throughput:
    """Accumulates (items, seconds) and reports items/sec."""

    items: float = 0.0
    seconds: float = 0.0

    def add(self, items: float, seconds: float) -> None:
        self.items += items
        self.seconds += seconds

    @property
    def per_sec(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def trace(logdir: str | None):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    when a card is present), its Chrome trace written to
    ``<logdir>/trace.json``; a no-op without ``logdir``. Yields the profiler
    (``None`` when off)."""
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


def _fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_jitted(fn: Callable[[], Any], repeats: int = 3, warmup: int = 1) -> float:
    """Median wall-clock seconds of ``fn()`` over ``repeats`` calls, after
    ``warmup`` untimed calls, each call fenced by ``torch.cuda.synchronize``
    when CUDA is in use."""
    for _ in range(warmup):
        fn()
        _fence()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _fence()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
