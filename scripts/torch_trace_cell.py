"""One traced run of a cell of the port's benchmark, reduced by the
program's own spans (``mri_super_resolution_tpu_torch/utils/profiling.py``).

    python3 scripts/torch_trace_cell.py --workload sr3d_ref.infer --seed 7 --seconds 51

Runs the cell as ``portbench/run.py --trace 1`` does and prints one JSON
line: the result line; the window's end-to-end metrics as read under the
profiler (against an untraced run they give the cost of tracing); for each
span name its count and, a span, its host ms, the device ms launched inside
it and the device's idle ms inside it; the device time launched inside the
benchmark's own spans (``vag``, ``apply``, ``optim``), beside which the
program's kernel spans should read alike; and the window's idle seconds by
the innermost span the main thread was in (``""``: in none). Needs a card.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "portbench" / "build"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    os.environ["MRI_SR_TORCH_BUILD_DIR"] = str(BUILD / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness
    from portbench.metrics import _program

    if not torch.cuda.is_available():
        print("torch_trace_cell: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    run = harness.measure(cell, args.seed, args.seconds, True, "cuda:0", T_START)
    trace, spans = run["trace"], _program.spans(run) or []
    read = lambda m: harness.load_module(harness.BENCH / "metrics" / f"{m}.py").read(run)
    out = {"line": harness.result_line(cell, run, True, torch.cuda.get_device_name(0)),
           "traced_end_to_end": {m["name"]: read(m["name"]) for m in cell.end_to_end
                                 if m["name"] != "setup_s"},
           "window_s": trace.window_s(), "busy_s": trace.busy_s(), "spans": {}}
    main_thread = threading.get_ident()
    for name in sorted({s.name for s in spans}):
        mine = [s for s in spans if s.name == name]
        iv = _program.intervals(spans, name)
        n = len(mine)
        out["spans"][name] = {
            "count": n, "off_main_thread": sum(s.thread != main_thread for s in mine),
            "host_ms": sum(s.end_ns - s.start_ns for s in mine) / n / 1e6,
            "device_ms": 1e3 * _program.device_s(trace, iv) / n,
            "idle_ms": _program.per_span(_program.idle_s(trace, iv), spans, name)}
    out["benchmark_spans_device_s"] = {n: trace.span_device_s(n) for n in ("vag", "apply", "optim")}
    out["idle_s_by_innermost"] = _program.idle_split(
        trace, [s for s in spans if s.thread == main_thread])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
