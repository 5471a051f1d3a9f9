"""The program's own spans read against the device trace of a traced window.

The program records a span around each step of its fit loop, each
optimizer step, each kernel entry and launch and each part of a dense-grid
request (``mri_super_resolution_tpu_torch/utils/profiling.py``:
``recorded()`` gives ``(name, thread, parent, start_ns, end_ns)``, on the
clock of the profiler's events). A metric reads them through the union of
their intervals, never through parent links: autograd runs a backward's
kernel entry on its own device thread, where the span has no parent.

- :func:`device_s`: the device time of the operations whose launch, a
  runtime call or a linked host op, started inside the intervals (the
  correlation rule of ``Trace.span_device_s``; id 0 links nothing);
- :func:`idle_s`: the device's idle time inside the intervals: the window
  less the union of the device's intervals, met with the intervals;
- :func:`idle_split`: that idle time by the innermost span open on one
  thread.

A program that records no spans (one from before they were added) gives
:func:`spans` None, and each metric then reads nothing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict


def spans(run) -> list | None:
    """The program's spans that opened inside the traced window; None when
    the run was not traced or the program records no spans."""
    trace = run.get("trace")
    if trace is None or trace.window is None:
        return None
    try:
        from mri_super_resolution_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    lo, hi = trace.window
    return [s for s in recorded() if lo <= s.start_ns <= hi]


def _matches(name: str, patterns) -> bool:
    """``name`` is one of ``patterns``, a pattern ending in ``.`` naming a
    prefix (``kernel.``: every kernel entry and launch)."""
    return any(name.startswith(p) if p.endswith(".") else name == p for p in patterns)


def named(recorded, *patterns) -> list:
    return [s for s in recorded if _matches(s.name, patterns)]


def union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        elif t > s:
            out.append([s, t])
    return [(s, t) for s, t in out]


def intervals(recorded, *patterns) -> list[tuple[int, int]]:
    """The union of the intervals of the spans ``patterns`` names."""
    return union((s.start_ns, s.end_ns) for s in named(recorded, *patterns))


def subtract(a, b) -> list[tuple[int, int]]:
    """The union ``a`` less the union ``b``."""
    out, j = [], 0
    for s, t in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < t:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < t:
            out.append((cur, t))
    return out


def overlap(a, b) -> int:
    """Nanoseconds the unions ``a`` and ``b`` share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(iv, t: int) -> bool:
    i = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return i >= 0 and iv[i][0] <= t <= iv[i][1]


def device_s(trace, iv) -> float:
    """Device seconds of every operation launched inside the union ``iv``:
    its runtime call, or the host op it is linked to, started there."""
    calls = {c for t, c in trace.runtime if c and _inside(iv, t)}
    ops = {c for t, c in trace.ops if c and _inside(iv, t)}
    return sum(t - s for _, _, s, t, c, op in trace.device
               if c in calls or op in ops) / 1e9


def idle(trace) -> list[tuple[int, int]] | None:
    """The window less the union of the device's intervals; None when the
    trace holds no device operation."""
    if not trace.device:
        return None
    lo, hi = trace.window
    busy = union((max(s, lo), min(t, hi)) for _, _, s, t, _, _ in trace.device
                 if t > lo and s < hi)
    return subtract([(lo, hi)], busy)


def idle_s(trace, iv) -> float | None:
    """Seconds the device was idle inside the union ``iv`` (and the
    window); None when the trace holds no device operation."""
    gaps = idle(trace)
    return None if gaps is None else overlap(gaps, iv) / 1e9


def innermost(recorded) -> list[tuple[int, int, str]]:
    """Time cut into pieces ``(start, end, name)``, each named by the
    innermost span open there; ``recorded`` are spans of one thread, which
    nest."""
    out, stack, cursor = [], [], 0
    for s in sorted(recorded, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1][0] <= s.start_ns:
            end, name = stack.pop()
            out.append((cursor, end, name))
            cursor = end
        if stack:
            out.append((cursor, s.start_ns, stack[-1][1]))
        stack.append((s.end_ns, s.name))
        cursor = s.start_ns
    while stack:
        end, name = stack.pop()
        out.append((cursor, end, name))
        cursor = end
    return [p for p in out if p[1] > p[0]]


def idle_split(trace, recorded) -> dict[str, float] | None:
    """The device's idle seconds in the window by the innermost of the spans
    ``recorded`` (of one thread) open at the time, and under ``""`` outside
    them all; None when the trace holds no device operation."""
    gaps = idle(trace)
    if gaps is None:
        return None
    by: dict[str, int] = defaultdict(int)
    pieces = innermost(recorded)
    labelled = 0
    for s, t, name in pieces:
        i = max(bisect.bisect_right(gaps, (s, float("inf"))) - 1, 0)
        while i < len(gaps) and gaps[i][0] < t:
            share = min(gaps[i][1], t) - max(gaps[i][0], s)
            if share > 0:
                by[name] += share
                labelled += share
            i += 1
    by[""] = sum(b - a for a, b in gaps) - labelled
    return {k: v / 1e9 for k, v in by.items()}


def per_span(total: float | None, recorded, name: str) -> float | None:
    """Milliseconds of ``total`` seconds for each span ``name``; None when
    there is no total or no such span."""
    n = sum(1 for s in recorded if s.name == name)
    return 1e3 * total / n if total is not None and n else None
