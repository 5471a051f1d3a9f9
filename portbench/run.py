"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernels' build or load, the seeded inputs, the
program's preparation and warm-up), a window of ``--seconds``, the check of
the window's answers against the plain reference, then one JSON line last
on standard output. ``--trace 1`` runs the window under ``torch.profiler``
and reports the cell's per-layer metrics instead of its end-to-end ones.
The numbers the check compared, each beside its limit, close standard
error. Exits non-zero, printing no result, without enough CUDA devices,
without the program in the checkout, or with JAX or the JAX package
loaded once the window has closed.

The kernels are built into ``portbench/build/`` (``MRI_SR_TORCH_BUILD_DIR``;
Triton's cache beside it), so only a checkout's first run builds them.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "portbench" / "build"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ["MRI_SR_TORCH_BUILD_DIR"] = str(BUILD / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.Cell(args.workload)
    need = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: {args.workload} needs {need} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.measure(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    line = harness.result_line(cell, run, bool(args.trace), torch.cuda.get_device_name(0))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
