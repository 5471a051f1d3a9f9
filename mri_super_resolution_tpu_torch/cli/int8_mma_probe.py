"""Probe: does the card run int8 products at twice the bf16 rate?

Run as ``python -m mri_super_resolution_tpu_torch.cli.int8_mma_probe``. The
PyTorch counterpart of ``scripts/int8_mxu_probe.py``: times P1
(``ops/mma_probe.py``, ``csrc/mma_probe.cu``) at ``--tile T H`` (384 512),
``--reps`` (8) and ``--grid`` (512) steps, in bf16 with float32 sums and in
int8 with int32 sums, and writes the JSON of the JAX probe (``platform``,
``device``, ``tile``, ``reps``, ``grid``, ``cases.{bf16_f32acc,
int8_i32acc}.{us_per_call, achieved_tops}``) to ``--out``. Each case runs
one untimed call and ``--calls`` (10) timed ones, host clock around them and
a final synchronise, as the JAX probe times. ``--device cpu`` runs the plain
version (no rate of the card). A failure raises.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mri_super_resolution_tpu_torch import resolve_device
from mri_super_resolution_tpu_torch.ops.mma_probe import mma_probe

CASES = (("bf16_f32acc", torch.bfloat16), ("int8_i32acc", torch.int8))


def operands(dtype: torch.dtype, T: int, H: int, reps: int, seed: int = 0):
    """The JAX probe's operands: int8 uniform in [-127, 127), bf16 uniform
    in [-1, 1), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        a = rng.integers(-127, 127, (reps * T, H))
        b = rng.integers(-127, 127, (H, H))
        return torch.as_tensor(a, dtype=torch.int8), torch.as_tensor(b, dtype=torch.int8)
    a = rng.uniform(-1, 1, (reps * T, H)).astype(np.float32)
    b = rng.uniform(-1, 1, (H, H)).astype(np.float32)
    return (torch.as_tensor(a).to(torch.bfloat16), torch.as_tensor(b).to(torch.bfloat16))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tile", type=int, nargs=2, default=(384, 512), metavar=("T", "H"))
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--grid", type=int, default=512)
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--out", default="int8_mma_probe.json")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    T, H = args.tile
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"platform": dev.type, "device": name, "tile": [T, H], "reps": args.reps,
           "grid": args.grid, "cases": {}}
    flops = 2.0 * T * H * H * args.reps * args.grid
    for case, dtype in CASES:
        a, b = (t.to(dev) for t in operands(dtype, T, H, args.reps))
        bt = b.t().contiguous()
        mma_probe(a, b, args.reps, args.grid, bt)  # builds the kernel on its first call
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.calls):
            r = mma_probe(a, b, args.reps, args.grid, bt)
        float(r[0, 0])  # waits for the last call
        dt = (time.perf_counter() - t0) / args.calls
        out["cases"][case] = {"us_per_call": round(dt * 1e6, 2),
                              "achieved_tops": round(flops / dt / 1e12, 2)}
        print(json.dumps({case: out["cases"][case]}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
