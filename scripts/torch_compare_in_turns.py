"""Time the PyTorch port's full-schedule INR paths in two checkouts on one
card, in turns: parent, change, change, parent, each run in a process of its
own, after every kernel library of both checkouts has been built (so no
timed run includes an ``nvcc`` build).

Run from the root of the changed checkout on a machine with one H100:

    python3 scripts/torch_compare_in_turns.py --parent <parent checkout> \
        [--paths wire master hybrid k1w] [--master_steps 3000 --master_seg 150]
        [--hybrid_epochs 2500]

``wire`` is ``chip_smoke.phase_main_path("wire", 2500, 10)``: the 3-D
pipeline's WIRE patient at the full schedule; ``siren`` the same with the
SIREN; ``master`` is ``chip_smoke.phase_master_main(master_steps,
master_seg)``: one 2-D directional-ensemble case; ``hybrid`` is
``chip_smoke.phase_hybrid(hybrid_epochs)``: the hybrid tissue fit's four
TEs and the NLLS maps; ``k1w`` is ``chip_smoke.phase_k1w_batched_time``:
the batched K1-w call of the 2-D ensemble through each checkout's own
wrapper, its kernel row, and the update's costs on the host clock (the
call, the stacked Adam step, both). Each checkout's own ``chip_smoke.py``
drives its own port, so both must have these phases. Prints each run's
``[main ...]`` and ``[times]`` lines (phases, launches, wall clock, kernel
and host-clock times) prefixed with the checkout's role.
"""
import argparse
import os
import subprocess
import sys
import time

BUILD = """
import chip_smoke as cs
from mri_super_resolution_tpu_torch.ops import _build
_build.build(cs.SOURCES)
print("[built]", {k: round(v, 1) for k, v in _build.BUILD_SECONDS.items()})
"""
RUN = """
import sys, tempfile
import chip_smoke as cs
from mri_super_resolution_tpu_torch import set_float32_precision
set_float32_precision()
with tempfile.TemporaryDirectory() as d:
    if sys.argv[1] == "master":
        cs.phase_master_main(d, int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1] == "hybrid":
        cs.phase_hybrid(int(sys.argv[2]))
    elif sys.argv[1] == "k1w":
        from collections import defaultdict
        cs.phase_k1w_batched_time(defaultdict(float), defaultdict(int))
    else:
        cs.phase_main_path(sys.argv[1], 2500, 10, d)
"""


def run(role: str, tree: str, code: str, *args: str) -> int:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code, *args], cwd=tree, capture_output=True,
                       text=True, stdin=subprocess.DEVNULL)
    for line in p.stdout.splitlines():
        if line.startswith(("[main", "[built", "[times]")):
            print(f"[{role}] {line[:900]}", flush=True)
    if p.returncode:
        print(f"[{role}] rc {p.returncode}: {p.stderr[-3000:]}", flush=True)
    print(f"[{role}] {' '.join(args) or 'build'} process {time.perf_counter() - t0:.1f} s",
          flush=True)
    return p.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the parent checkout")
    ap.add_argument("--paths", nargs="+", default=["wire", "master"],
                    choices=["wire", "siren", "master", "hybrid", "k1w"])
    ap.add_argument("--master_steps", type=int, default=3000)
    ap.add_argument("--master_seg", type=int, default=150)
    ap.add_argument("--hybrid_epochs", type=int, default=2500)
    args = ap.parse_args(argv)
    extra = {"master": [str(args.master_steps), str(args.master_seg)],
             "hybrid": [str(args.hybrid_epochs)]}
    trees = {"parent": os.path.abspath(args.parent), "change": os.getcwd()}
    rc = 0
    for role, tree in trees.items():
        rc |= run(role, tree, BUILD)
    for path in args.paths:
        for role in ("parent", "change", "change", "parent"):
            rc |= run(role, trees[role], RUN, path, *extra.get(path, []))
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
