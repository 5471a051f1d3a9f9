"""Driver of ``fit/engine.py:fit_ensemble_batched`` as
``pipelines/master2d.py:fit_directions`` calls it: the ROI stack's AutoERD
acceptance (``ops/erd.py:auto_erd``, rule 1) computed in set-up, the
Normalize(0.5, 0.5) targets of each direction's acquisitions, D stacked
Sirens under one ``StackedAdam``, one batched K1 with sample weights an
update (``make_fused_weighted_value_and_grad_batched``), the last ``seg``
steps' predictions on the 1x and scale-x grids by the plain batched
forward.

The window calls the engine over and over with the configuration's
``total_steps`` and ``seg``, a chunk of the published schedule; after
``chunks_per_fit`` chunks the weights go back to their seeded start under a
fresh ``StackedAdam``, as the next case's fit would. The set-up's call is
one step with one prediction; its first three updates are what the check
follows.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import driving, inputs as make

FOLLOWED = 3  # updates the reference follows


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault: str | None = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device, self.fault = torch.device(device), fault

    def setup(self) -> None:
        from mri_super_resolution_tpu_torch import set_float32_precision
        from mri_super_resolution_tpu_torch.core.coords import mgrid
        from mri_super_resolution_tpu_torch.core.normalize import to_tensor_normalize
        from mri_super_resolution_tpu_torch.fit.engine import fit_ensemble_batched
        from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
        from mri_super_resolution_tpu_torch.models import Siren
        from mri_super_resolution_tpu_torch.ops.erd import auto_erd
        from mri_super_resolution_tpu_torch.ops.siren_kernel import (
            make_fused_weighted_value_and_grad_batched,
            siren_forward_batched_ref,
        )

        cfg, dev = self.cfg, self.device
        set_float32_precision()
        gen = make.generator(self.seed, dev)
        acqs = list(cfg["acquisitions"])
        side = cfg["roi_end"] - cfg["roi_begin"]
        self.roi = make.case_2d(gen, side, sum(acqs), dev)
        self.dims = [2] + [cfg["hidden_features"]] * (cfg["hidden_layers"] + 1) + [1]
        D, A_max, P = len(acqs), max(acqs), side * side
        self.params0 = make.siren_weights(gen, self.dims, dev, cfg["omega"], slots=D)

        # fit_directions' preparation, on run_case's AutoERD acceptance
        accept = auto_erd(self.roi, None, mode=1).to(torch.float32)
        pixels = torch.zeros(D, A_max, P, 1, device=dev)
        weights = torch.zeros(D, A_max, P, 1, device=dev)
        valid = np.zeros((D, A_max), dtype=bool)
        at = 0
        for d, n in enumerate(acqs):
            for i in range(n):
                pixels[d, i, :, 0] = to_tensor_normalize(self.roi[:, :, at + i]).reshape(-1)
                weights[d, i, :, 0] = accept[:, :, at + i].reshape(-1)
            valid[d, :n] = True
            at += n
        self.accept, self.pixels, self.weights, self.valid = accept, pixels, weights, valid
        self.coords = mgrid((side, side), device=dev)
        self.coords_s = mgrid((side * cfg["scale"], side * cfg["scale"]), device=dev)
        model = Siren(2, cfg["hidden_features"], cfg["hidden_layers"], 1,
                      first_omega_0=cfg["omega"], hidden_omega_0=cfg["omega"])
        omegas = model.omegas
        self.apply = lambda params, x: siren_forward_batched_ref(x, params, omegas)
        self.vag = make_fused_weighted_value_and_grad_batched(model)
        self.fit = fit_ensemble_batched
        self.new_opt = lambda: StackedAdam([p.clone() for p in self.params0],
                                           cfg["learning_rate"])
        self.opt = self.new_opt()

        self.first = driving.FirstUpdates(self.opt, FOLLOWED, self.fault)
        self.opt.step = self.first
        self.losses: list = []
        self._call(self.apply, driving.first_calls(self.vag, FOLLOWED, self.losses), 1, 1)
        self.opt.step = self.first.step
        self.chunks = 0
        driving.sync(dev)

    def _call(self, apply, vag, total_steps: int, seg: int):
        x, px, w = self.coords, self.pixels, self.weights
        if self.fault == "half_batch":
            h = x.shape[0] // 2
            x, px, w = x[:h], px[:, :, :h], w[:, :, :h]
        return self.fit(apply, self.opt, x, px, w, self.coords, self.coords_s,
                        total_steps=total_steps, seg=seg, valid=self.valid,
                        weighted_value_and_grad_fn=vag)

    def window(self, seconds: float, recorder) -> dict:
        steps, seg = self.cfg["total_steps"], self.cfg["seg"]
        apply = recorder.wrap("apply", self.apply, driving.mlp_signature("forward"))
        vag = recorder.wrap("vag", self.vag, driving.mlp_signature("loss_grads", weighted=True))
        self.opt.step = recorder.wrap("optim", self.first.step)
        chunks, losses = 0, []

        def one():
            nonlocal chunks
            losses.append(self._call(apply, vag, steps, seg).losses)
            chunks += 1
            self.chunks += 1
            if self.chunks % self.traffic["chunks_per_fit"] == 0:
                self.opt = self.new_opt()
                self.opt.step = recorder.wrap("optim", self.opt.step)

        window_s = driving.timed_window(seconds, self.device, recorder, one)
        failed = int((~torch.isfinite(torch.cat(losses))).sum()) if losses else 0
        D, rows = len(self.cfg["acquisitions"]), int(self.coords.shape[0])
        fed = rows // 2 if self.fault == "half_batch" else rows
        updates = chunks * steps * int(self.valid.any(axis=0).sum())
        return {"window_s": window_s, "attempted": updates, "failed": failed,
                "voxels": chunks * steps * int(self.valid.sum()) * fed,
                "products": [("loss_grads", self.dims, fed, D, updates),
                             ("forward", self.dims, rows, D, chunks * seg),
                             ("forward", self.dims, int(self.coords_s.shape[0]), D, chunks * seg)]}

    def observations(self) -> dict:
        return driving.to_host({
            "prep": {"accept": self.accept, "pixels": self.pixels, "weights": self.weights},
            "losses": [loss.tolist() for loss, _ in self.losses],
            "grad": self.first.grad, "params": self.first.params})

    def inputs(self) -> dict:
        return {"roi": self.roi, "params0": self.params0}

    def free(self) -> None:
        for name in ("opt", "first", "pixels", "weights", "accept", "losses", "apply", "vag"):
            self.__dict__.pop(name, None)


def expected(ref, inputs: dict, cfg: dict, traffic: dict) -> dict:
    prepped = ref.prep(inputs, cfg)
    steps = ref.updates(inputs, cfg, prepped, FOLLOWED)
    return driving.to_host({"prep": prepped, **steps})


def compare(program: dict, reference: dict, inputs: dict, traffic: dict) -> dict:
    from portbench import compare as cmp

    accept = np.asarray(program["prep"]["accept"]).astype(np.int32)
    out = {"erd_mismatch": float((accept != np.asarray(reference["prep"]["accept"])).sum()),
           "prep_gap": max(cmp.array_gap(program["prep"][k], reference["prep"][k])
                           for k in ("pixels", "weights"))}
    out.update(cmp.training(program, reference, inputs["params0"], stacked=True))
    return out
