"""The port's profiling helpers (``utils/profiling.py``) against the JAX
package's: ``Throughput``'s arithmetic, ``trace`` writing a Chrome trace of
``torch.profiler`` (a no-op without a directory), and ``time_jitted``'s
median after warm-up."""
import json
import os

import pytest
import torch

from mri_super_resolution_tpu.utils import profiling as jprof
from mri_super_resolution_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)


def test_throughput_matches_jax():
    a, b = tprof.Throughput(), jprof.Throughput()
    assert a.per_sec == b.per_sec == 0.0
    for items, secs in ((70_000, 0.5), (35_000, 0.25)):
        a.add(items, secs)
        b.add(items, secs)
    assert a.per_sec == b.per_sec == 140_000.0


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with tprof.trace(str(tmp_path / "t")) as prof:
        (x @ x).sum()
    assert prof is not None
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with tprof.trace(None) as off:
        assert off is None
    assert not os.path.exists(tmp_path / "none")


def test_time_jitted_takes_the_median_after_warmup(monkeypatch):
    calls = []
    clock = iter([0.0, 3.0, 10.0, 11.0, 20.0, 22.0])  # 3 s, 1 s, 2 s
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: next(clock))
    assert tprof.time_jitted(lambda: calls.append(1), repeats=3, warmup=2) == 2.0
    assert len(calls) == 5


def test_time_jitted_on_a_real_call():
    t = tprof.time_jitted(lambda: torch.ones(128, 128) @ torch.ones(128, 128), repeats=3)
    assert 0.0 < t < 5.0
    with pytest.raises(ZeroDivisionError):
        tprof.time_jitted(lambda: 1 / 0, repeats=1, warmup=0)
