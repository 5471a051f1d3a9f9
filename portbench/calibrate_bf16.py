"""Readings that a bfloat16 cell's limits are set from, as ``calibrate.py``
reads them, with a control below the configuration's precision that TF32
cannot give (TF32 products are finer than bfloat16 activations): the
plain reference computed with bfloat16 activations and each convolution's
sum over its taps kept in bfloat16 (the entry's ``expected(...,
precision="bf16_sums")``), put in the program's place.

    python3 portbench/calibrate_bf16.py --workload rams_misr.serve --seeds 1,2,3 \
        [--control 3] [--faults half_batch,altered,stale] [--seconds 2] [--out FILE]

Every reading comes from the window's kept answers, so ``--seconds`` must
let the window serve some. A fault run keeps answers of its own, and its
readings are taken against the reference of its own inputs. Prints the
largest sound reading and the smallest control and fault readings of each
number, and writes every reading to ``--out`` as JSON.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL = "bf16_sums"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    os.environ["MRI_SR_TORCH_BUILD_DIR"] = str(ROOT / "portbench" / "build" / "kernels")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, plain, spans

    if not torch.cuda.is_available():
        print("calibrate_bf16: no CUDA device", file=sys.stderr)
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
        del driver
        torch.cuda.empty_cache()
        return obs, inputs

    def reference(inputs, precision="float32"):
        with plain.precision("float32"):
            return cell.entry.expected(cell.ref, inputs, cell.cfg, cell.traffic, precision)

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        obs, inputs = observe(seed)
        ref = reference(inputs)
        out["sound"][seed] = cell.readings(obs, inputs, ref)
        if i < args.control:
            out["control"][seed] = cell.readings(reference(inputs, CONTROL), inputs, ref)
            for f in faults:
                f_obs, f_inputs = observe(seed, f)
                out[f][seed] = cell.readings(f_obs, f_inputs, reference(f_inputs))
        print(f"seed {seed} ({time.perf_counter() - t0:.1f} s): "
              + json.dumps({k: out[k].get(seed) for k in out if isinstance(out[k], dict)}),
              flush=True)
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
