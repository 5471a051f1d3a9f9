"""How far the 2-D ensemble's loss trace on two ranks drifts from one rank's.

Run from the repository root (on a machine with a card, or with
``--device cpu``):

    python3 scripts/torch_shard_drift.py [--device cuda] [--steps 20]

For each route (autograd through the plain batched forward; on the card
also the batched K1-w kernel) and each kind of target (uniform noise in
[-1, 1], as ``chip_smoke.py`` uses; a smooth image,
``data/synthetic.toy_image`` with 5% noise) it spawns two gloo ranks that
run ``fit_ensemble_batched`` with ``mesh=`` at the 2-D case's full width
(three Siren(2 -> 64x7 -> 1) on the 60 x 60 ROI, nine acquisitions, lr
3e-4), and one rank on the whole batch, and prints each step's worst
relative gap between the two loss traces and the first step beyond 1e-4.
In one process it first holds the two halves' reduced (loss, grads) of one
batched call against the whole batch's: a gap there would be a fault of
the reduction, a gap only in the traces is the fit amplifying two
reduction orders' rounding.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DIRS, SLOTS, SIDE, HIDDEN, LAYERS, LR = 3, 9, 60, 64, 6, 3e-4


def problem(device: str, targets: str, seed: int = 91):
    """Three seeded Sirens stacked, the ROI grid and its 3x grid, targets
    and acceptance weights (one row in ten rejected) per acquisition."""
    from mri_super_resolution_tpu_torch.core.coords import mgrid
    from mri_super_resolution_tpu_torch.data import synthetic
    from mri_super_resolution_tpu_torch.models import Siren

    gen = torch.Generator().manual_seed(seed)
    models = [Siren(2, HIDDEN, LAYERS, generator=gen) for _ in range(DIRS)]
    init = [torch.stack(t).to(device) for t in zip(*(m.weights() for m in models))]
    shape = (DIRS, SLOTS, SIDE * SIDE, 1)
    if targets == "random":
        pixels = torch.rand(shape, generator=gen) * 2 - 1
    else:
        img = torch.as_tensor(synthetic.toy_image(SIDE, seed=3)).reshape(1, 1, -1, 1) * 2 - 1
        pixels = img + 0.05 * torch.randn(shape, generator=gen)
    weights = (torch.rand(shape, generator=gen) > 0.1).float()
    return (models[0], init, mgrid((SIDE, SIDE), device=device),
            mgrid((3 * SIDE, 3 * SIDE), device=device), pixels.to(device), weights.to(device))


def reduce_check(device: str) -> float:
    """max |halves reduced - whole| / max |whole| over one call's loss and
    grads (the kernel on the card, its plain version on the CPU)."""
    from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk

    model, init, x, _, pixels, weights = problem(device, "random")
    ws = StackedAdam(init, LR).params
    t, w = pixels[:, 0].contiguous(), weights[:, 0].contiguous()
    n = x.shape[0] // 2
    halves = [sk.siren_loss_grads_batched(x[i * n:(i + 1) * n], ws, t[:, i * n:(i + 1) * n]
                                          .contiguous(), acts=model.acts,
                                          sample_weights=w[:, i * n:(i + 1) * n].contiguous())
              for i in range(2)]
    whole = sk.siren_loss_grads_batched(x, ws, t, acts=model.acts, sample_weights=w)
    pairs = [(0.5 * (halves[0][0] + halves[1][0]), whole[0])]
    pairs += [(0.5 * (a + b), c) for a, b, c in zip(halves[0][1], halves[1][1], whole[1])]
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs)


def rank_fit(device: str, route: str, targets: str, steps: int) -> dict:
    """One rank: the sharded fit, then on rank 0 the whole batch alone."""
    import torch.distributed as dist

    from mri_super_resolution_tpu_torch import set_float32_precision
    from mri_super_resolution_tpu_torch.fit.engine import fit_ensemble_batched
    from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
    from mri_super_resolution_tpu_torch.ops import siren_kernel as sk
    from mri_super_resolution_tpu_torch.parallel import Spec, make_mesh, shard_batch

    set_float32_precision()
    rank = dist.get_rank()
    flat, one = make_mesh(case=1), make_mesh(1, 1, ranks=[rank])
    model, init, x, xs, pixels, weights = problem(device, targets)
    vag = sk.make_fused_weighted_value_and_grad_batched(model) if route == "kernel" else None
    out = {}
    for name, mesh in (("ranks", flat), ("one", one)):
        if mesh is one and rank != 0:
            continue
        on = (lambda a, spec=None: a) if mesh is one else (
            lambda a, spec=None: shard_batch(a, mesh, spec))
        res = fit_ensemble_batched(
            lambda p, c: sk.siren_forward_batched_ref(c, p, model.omegas), StackedAdam(init, LR),
            on(x), on(pixels, Spec(None, None, "data")), on(weights, Spec(None, None, "data")),
            on(x), on(xs), steps, 1, weighted_value_and_grad_fn=vag, mesh=mesh)
        out[name] = res.losses.cpu().numpy()
    dist.barrier()
    return out


def main() -> None:
    from mri_super_resolution_tpu_torch import set_float32_precision
    from mri_super_resolution_tpu_torch.parallel.distributed import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    set_float32_precision()
    where = (torch.cuda.get_device_name(0) if args.device == "cuda" else "the CPU")
    print(f"[drift] {where}; one batched call, two halves reduced vs the whole: worst rel "
          f"{reduce_check(args.device):.3e}")
    routes = ("plain", "kernel") if args.device == "cuda" else ("plain",)
    for route in routes:
        for targets in ("random", "image"):
            r = spawn_ranks(rank_fit, 2, args.device, route, targets, args.steps,
                            device=args.device, timeout=900)
            a, b = r[0]["ranks"], r[0]["one"]
            rel = np.abs(a / b - 1.0).max(axis=1)
            over = np.flatnonzero(rel > 1e-4)
            print(f"[drift] {route} route, {targets} targets, {args.steps} steps: worst rel a "
                  f"step {np.array2string(rel, precision=2, max_line_width=200)}; first step "
                  f"beyond 1e-4: {int(over[0]) if len(over) else None}; ranks bit-equal: "
                  f"{np.array_equal(r[0]['ranks'], r[1]['ranks'])}")


if __name__ == "__main__":
    main()
