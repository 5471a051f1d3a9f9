"""The port's Chrome-trace exporter (``utils/profiling.py``'s ``trace``):
a Chrome trace of ``torch.profiler`` written into a directory, a no-op
without one. The spans are ``test_torch_spans.py``'s."""
import json
import os

import torch

from mri_super_resolution_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)


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
