"""The device trace of a traced window, reduced to what the per-layer
metrics read.

The window runs under ``torch.profiler`` (CPU and CUDA activity). Its
events are read straight from the profiler's Kineto results: the
benchmark's ``portbench.*`` ranges on the host, the CUDA runtime's launch
and copy calls, and the device's kernels, copies and sets. A span's device
time is that of the device operations whose correlation id is that of a
runtime call made inside the span: kernels are tied to spans by launch
correlation, never by their names, so a kernel renamed or split by a later
change is still counted where it was launched.
"""
from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict

from portbench.spans import PREFIX

RUNTIME_NAME = re.compile(r"^(cuda[A-Z]|cu[A-Z])")  # the CUDA runtime's and driver's calls


@contextlib.contextmanager
def profiled(holder: dict):
    """Profile the body; on exit put a :class:`Trace` of it in
    ``holder["trace"]``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    holder["trace"] = Trace(prof.profiler.kineto_results.events())


def _kind(name: str, on_device: bool) -> str:
    """``kernel``, ``memcpy``, ``memset`` (device operations), ``runtime``
    (a CUDA API call on the host) or ``host`` (anything else there), from
    the name of the operation or API (``Memcpy``/``Memset`` on the device,
    ``cuda*``/``cu*`` on the host): not every version of the profiler gives
    events an activity type."""
    if on_device:
        return "memcpy" if name.startswith("Memcpy") else (
            "memset" if name.startswith("Memset") else "kernel")
    return "runtime" if RUNTIME_NAME.match(name) else "host"


def _union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


class Trace:
    def __init__(self, events):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        self.spans: dict[str, list[tuple[int, int]]] = defaultdict(list)
        # host calls and ops: (start ns, correlation id); device operations:
        # (kind, name, start, end, correlation id, the launching op's id)
        self.runtime: list[tuple[int, int]] = []
        self.ops: list[tuple[int, int]] = []
        self.device: list[tuple[str, str, int, int, int, int]] = []
        for e in events:
            name, start = e.name(), e.start_ns()
            on_device = e.device_type() == cuda
            if on_device and name.startswith(PREFIX):
                continue  # the device's copy of a span
            kind = _kind(name, on_device)
            if on_device:
                self.device.append((kind, name, start, start + e.duration_ns(),
                                    e.correlation_id(), e.linked_correlation_id()))
            elif kind == "runtime":
                self.runtime.append((start, e.correlation_id()))
            else:
                self.ops.append((start, e.correlation_id()))
                if name.startswith(PREFIX):
                    self.spans[name[len(PREFIX):]].append((start, start + e.duration_ns()))
        for v in self.spans.values():
            v.sort()
        window = self.spans.get("window")
        self.window = window[0] if window else None

    def window_s(self) -> float | None:
        return (self.window[1] - self.window[0]) / 1e9 if self.window else None

    def _busy(self) -> list[tuple[int, int]]:
        lo, hi = self.window
        return _union((max(s, lo), min(t, hi)) for _, _, s, t, _, _ in self.device
                      if t > lo and s < hi)

    def busy_s(self) -> float | None:
        """Seconds of the window in which some device operation ran (the
        union of their intervals)."""
        if not self.window or not self.device:
            return None
        return sum(t - s for s, t in self._busy()) / 1e9

    def _inside(self, name: str, t: int) -> bool:
        iv = self.spans.get(name, [])
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]

    def span_device_s(self, name: str) -> float | None:
        """Device seconds of every operation launched inside a span
        ``name``; None when no such operation was traced."""
        calls = {c for t, c in self.runtime if self._inside(name, t)}
        ops = {c for t, c in self.ops if self._inside(name, t)}
        total = sum(t - s for _, _, s, t, c, op in self.device if c in calls or op in ops)
        return total / 1e9 if total > 0 else None

    def copy_s(self, direction: str) -> float | None:
        """Device seconds of the copies whose kind names ``direction``
        (``"DtoH"``, ``"HtoD"``, ``"DtoD"``)."""
        total = sum(t - s for kind, name, s, t, _, _ in self.device
                    if kind == "memcpy" and direction in name)
        return total / 1e9 if total > 0 else None

    def top_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device operations (by name) that took most time."""
        by: dict[str, int] = defaultdict(int)
        for _, name, s, t, _, _ in self.device:
            by[name[:160]] += t - s
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The device's idle time inside the window, summed by the
        innermost span the host was in at each gap's middle (``host`` when
        in none), the ``k`` largest."""
        if not self.window or not self.device:
            return []
        busy = self._busy()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        by: dict[str, int] = defaultdict(int)
        names = [n for n in self.spans if n != "window"]
        for s, t in zip(edges[0::2], edges[1::2]):
            if t <= s:
                continue
            mid = (s + t) // 2
            inner = [n for n in names if self._inside(n, mid)]
            by[min(inner, key=lambda n: self._span_len(n, mid)) if inner else "host"] += t - s
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def _span_len(self, name: str, t: int) -> int:
        iv = self.spans[name]
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        return iv[i][1] - iv[i][0]
