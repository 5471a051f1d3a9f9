"""Readings that a cell's limits are set from, on the card at the cell's own
size: every compared number on sound runs of the program over many seeds
(the lower readings), on the control (the plain reference computed in TF32,
the nearest precision below the configurations' float32, put in the
program's place) and on each fault planted in the timed path (the upper
readings).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--faults unchanged,half_batch] [--seconds 0] [--out FILE]

``--seconds``: a window after set-up (the inference cell's answers come
from its window; a fit's readings come from its set-up's first updates).
The control and the faults run on the first ``--control`` seeds. Prints
the largest sound reading and the smallest control and fault readings of
each number, and writes every reading to ``--out`` as JSON.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    os.environ["MRI_SR_TORCH_BUILD_DIR"] = str(ROOT / "portbench" / "build" / "kernels")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spans

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = "cuda:0"
    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    out = {"cell": cell.name, "device": torch.cuda.get_device_name(0), "sound": {},
           "control": {}, **{f: {} for f in faults}}

    def observe(seed, fault=None):
        driver = cell.driver(seed, dev, fault)
        driver.setup()
        driver.window(args.seconds, spans.Recorder(active=False))
        obs, inputs = driver.observations(), driver.inputs()
        driver.free()
        return obs, inputs

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        obs, inputs = observe(seed)
        ref = cell.expected(inputs, "float32")
        out["sound"][seed] = cell.readings(obs, inputs, ref)
        if i < args.control:
            control = cell.expected(inputs, "tf32")
            out["control"][seed] = cell.readings(control, inputs, ref)
            for f in faults:
                out[f][seed] = cell.readings(observe(seed, f)[0], inputs, ref)
        print(f"seed {seed} ({time.perf_counter() - t0:.1f} s): "
              + json.dumps({k: out[k].get(seed) for k in out if isinstance(out[k], dict)}),
              flush=True)
        del obs, inputs, ref
        torch.cuda.empty_cache()
    names = list(next(iter(out["sound"].values())))
    for name in names:
        sound = max(r[name] for r in out["sound"].values())
        upper = {k: min(r[name] for r in out[k].values())
                 for k in ["control", *faults] if out[k]}
        print(f"{cell.name} {name}: lower (max of {len(seeds)} sound) {sound!r}; "
              + "; ".join(f"{k} min {v!r}" for k, v in upper.items()))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
