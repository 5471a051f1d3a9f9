"""Cohort-parallel INR fitting (BASELINE config 5) on PyTorch.

Run as ``python -m mri_super_resolution_tpu_torch.cli.cohort_run``. Fits
every patient's cancer-slice mean at once, the cases spread over the ranks
of a multi-process run, and reports cohort voxels/sec. The flags of the JAX
package's ``cli/cohort_run.py`` plus ``--data_dir`` and ``--device``
(default ``cuda``; raises without a card). ``--distributed`` starts the
process group from ``MRI_SR_COORDINATOR`` / ``MRI_SR_NUM_PROCESSES`` /
``MRI_SR_PROCESS_ID`` or torchrun's variables
(``parallel/distributed.py:init_distributed``).
"""
from __future__ import annotations

import argparse
import os

from mri_super_resolution_tpu_torch.config import add_preset_arg
from mri_super_resolution_tpu_torch.data import load_cases
from mri_super_resolution_tpu_torch.parallel import distributed
from mri_super_resolution_tpu_torch.pipelines import cohort


def main(argv=None) -> cohort.CohortResult:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--hidden_features", type=int, default=64)
    p.add_argument("--hidden_layers", type=int, default=6)
    p.add_argument("--limit_cases", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--inr_restart_every", type=int, default=0,
                   help=">0: periodic Adam-moment restarts on the per-case fits")
    p.add_argument("--tensorboard_dir", default=None,
                   help="write per-case loss curves as tfevents under this dir")
    p.add_argument("--distributed", action="store_true",
                   help="start torch.distributed: rank and coordinator from "
                        "MRI_SR_COORDINATOR / MRI_SR_NUM_PROCESSES / MRI_SR_PROCESS_ID "
                        "or torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    add_preset_arg(p, argv)
    args = p.parse_args(argv)

    if args.distributed:
        multi = distributed.init_distributed(auto=True, device=args.device)
        pid, count = distributed.process_info()
        print(f"distributed: process {pid}/{count} "
              f"({'multi' if multi else 'single'}-process)")
    rank, _ = distributed.process_info()
    cases = load_cases(data_dir=args.data_dir, limit=args.limit_cases)
    if not cases:
        p.error("no cases found")
    res = cohort.run_cohort(cases, num_steps=args.steps, hidden_features=args.hidden_features,
                            hidden_layers=args.hidden_layers, seed=args.seed,
                            inr_restart_every=args.inr_restart_every, device=args.device)
    if args.tensorboard_dir and rank == 0:
        from mri_super_resolution_tpu_torch.utils.tbevents import EventWriter

        for case, losses in zip(cases, res.losses):
            with EventWriter(os.path.join(args.tensorboard_dir, str(case.pt_id))) as w:
                for step, loss in enumerate(losses):
                    w.add_scalar("Loss", float(loss), step + 1)
        print(f"tfevents written to {args.tensorboard_dir}")
    print(f"cohort of {len(cases)} cases on mesh {res.mesh_shape}: "
          f"{res.voxels_per_sec:,.0f} voxels/sec, "
          f"final losses {[round(float(v), 5) for v in res.losses[:, -1]]}")
    if args.distributed:
        distributed.shutdown()
    return res


if __name__ == "__main__":
    main()
