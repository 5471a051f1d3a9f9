"""Driver of ``fit/engine.py:fit_alternating_pn`` on the 3-D pipeline's
inputs and kernel route, as ``pipelines/superres3d.py:run_patient`` builds
them with the pipeline's own functions: the per-(b, TE) max normalisation,
the combination mean and the cross-b combinations of the LR ROI, the LR
grid's Fourier features; K1 for the mean steps, K3 forward with K2
backward (``siren_fused``) for the PerturbNet steps; the port's ``Adam``.

The traffic's ``unit`` is one engine call (``num_epochs``, ``pn_epochs``,
``phase2_start``); the window repeats it. With ``pn_epochs`` 0 (the mean
phase) each call is ``unit`` mean steps, clipped at ``reset_epochs``, where
the weights go back to their seeded start under a fresh Adam, as a new
patient's fit would. The set-up's call is ``setup_unit``: its first three
updates of the trained network (the INR's in the mean phase, the
PerturbNet's in the alternating one) are what the check follows.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import driving, inputs as make

FOLLOWED = 3  # updates the reference follows


def _steps(unit: dict, n_acq: int) -> tuple[int, int]:
    """(INR steps, PerturbNet steps) of one engine call."""
    n, pn = unit["num_epochs"], unit.get("pn_epochs", 0)
    start = unit.get("phase2_start", n - pn)
    odd = sum(e % 2 for e in range(start, start + pn))
    return n - pn + odd, n_acq * (pn - odd)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault: str | None = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device, self.fault = torch.device(device), fault
        self.pn_phase = traffic["unit"].get("pn_epochs", 0) > 0

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from mri_super_resolution_tpu_torch import set_float32_precision
        from mri_super_resolution_tpu_torch.core.coords import fourier_encode, mgrid
        from mri_super_resolution_tpu_torch.data import combination_mean, expand_combinations
        from mri_super_resolution_tpu_torch.fit.engine import fit_alternating_pn
        from mri_super_resolution_tpu_torch.fit.optim import Adam, restart_adam
        from mri_super_resolution_tpu_torch.models import perturbnet_apply
        from mri_super_resolution_tpu_torch.ops.siren_kernel import siren_fused, siren_loss_grads
        from mri_super_resolution_tpu_torch.pipelines.superres3d import normalize_hybrid

        cfg, dev = self.cfg, self.device
        set_float32_precision()
        gen = make.generator(self.seed, dev)
        patient = make.patient_3d(gen, cfg["patient_shape"], cfg["acquisitions"],
                                  cfg["bvalues"], dev)
        dim = len(cfg["patient_shape"]) + 1
        self.B = make.fourier_matrix(gen, cfg["mapping_size"], dim, cfg["ff_scale"], dev)
        self.dims = [2 * cfg["mapping_size"]] + [cfg["hidden_dim"]] * (cfg["num_layers"] + 1) + [1]
        self.inr0 = make.siren_weights(gen, self.dims, dev, cfg["omega"])
        self.pn_dims = [self.dims[0] + 1, cfg["pn_dim"], dim]
        self.pn0 = make.lecun_weights(gen, self.pn_dims, dev)
        self.patient = patient

        # run_patient's preparation (superres3d.py: normalise, mean, combinations, encode)
        hybrid = [[v.cpu().numpy()] * 4 for v in patient]
        normed, _ = normalize_hybrid(hybrid)
        mean_img = combination_mean(normed, te=0).numpy()
        r0, r1 = cfg["roi_start"], cfg["roi_end"]
        lr_mean = mean_img[r0:r1:2, r0:r1:2]
        lr_acqs = expand_combinations(*[
            torch.as_tensor(np.asarray(normed[b][0], dtype=np.float32)[r0:r1:2, r0:r1:2],
                            device=dev) for b in range(4)])
        n_comb = lr_acqs.shape[-1]
        self.acq_pixels = lr_acqs.reshape(-1, n_comb).T.contiguous()[..., None]
        self.mean_target = torch.as_tensor(np.ascontiguousarray(lr_mean.reshape(-1, 1)),
                                           device=dev)
        self.ff = fourier_encode(mgrid(lr_mean.shape, device=dev), self.B)
        self.n_acq, self.rows = int(n_comb), int(self.ff.shape[0])

        omegas = (float(cfg["omega"]),) * (cfg["num_layers"] + 1)
        self.apply = lambda params, x: siren_fused(x, params, omegas)
        self.vag = lambda params, x, target: siren_loss_grads(x, params, target, omegas)
        self.pn_apply = perturbnet_apply
        self.fit = fit_alternating_pn
        self.new_inr_opt = lambda params: restart_adam(params, cfg["inr_lr"],
                                                       cfg["inr_restart_every"])
        self.inr_params = [p.clone() for p in self.inr0]
        self.inr_opt = self.new_inr_opt(self.inr_params)
        self.pn_opt = Adam([p.clone() for p in self.pn0], cfg["pn_lr"])

        # the first call: the warm-up, and the updates the check follows
        trained = self.pn_opt if self.pn_phase else self.inr_opt
        self.first = driving.FirstUpdates(trained, FOLLOWED, self.fault)
        trained.step = self.first
        self.outs: list = []
        apply = driving.first_calls(self.apply, FOLLOWED, self.outs) if self.pn_phase else self.apply
        unit = self.traffic["setup_unit"]
        res = self._call(apply, self.vag, unit)
        trained.step = self.first.step
        self.setup_losses = res.losses.detach().clone()
        self.done = unit["num_epochs"]
        driving.sync(dev)

    def _feed(self):
        if self.fault == "half_batch":
            h = self.rows // 2
            return self.ff[:h], self.mean_target[:h], self.acq_pixels[:, :h]
        return self.ff, self.mean_target, self.acq_pixels

    def _call(self, apply, vag, unit: dict):
        ff, target, acq = self._feed()
        return self.fit(apply, self.pn_apply, self.inr_opt, self.pn_opt, ff, target, acq,
                        self.B, num_epochs=unit["num_epochs"],
                        pn_epochs=unit.get("pn_epochs", 0), pn_eps=self.cfg["pn_eps"],
                        inr_value_and_grad=vag, phase2_start=unit.get("phase2_start"))

    # -- window ---------------------------------------------------------------
    def window(self, seconds: float, recorder) -> dict:
        unit, reset = dict(self.traffic["unit"]), self.traffic.get("reset_epochs")
        apply = recorder.wrap("apply", self.apply, driving.mlp_signature("forward"))
        vag = recorder.wrap("vag", self.vag, driving.mlp_signature("loss_grads"))
        inr_steps = pn_steps = 0
        losses = []

        def wrap_opts():
            for opt in (self.inr_opt, self.pn_opt):
                opt.step = recorder.wrap("optim", type(opt).step.__get__(opt))

        def one():
            nonlocal inr_steps, pn_steps
            call = dict(unit)
            if reset and not self.pn_phase:
                call["num_epochs"] = min(unit["num_epochs"], reset - self.done)
            losses.append(self._call(apply, vag, call).losses)
            i, p = _steps(call, self.n_acq)
            inr_steps, pn_steps = inr_steps + i, pn_steps + p
            self.done += call["num_epochs"]
            if reset and self.done >= reset:
                with torch.no_grad():
                    for p_, p0 in zip(self.inr_params, self.inr0):
                        p_.copy_(p0)
                self.inr_opt = self.new_inr_opt(self.inr_params)
                wrap_opts()
                self.done = 0

        wrap_opts()
        window_s = driving.timed_window(seconds, self.device, recorder, one)
        failed = int((~torch.isfinite(torch.cat(losses))).sum()) if losses else 0
        rows = self.rows // 2 if self.fault == "half_batch" else self.rows
        pn = [(kind, dims, rows, 1, pn_steps) for kind, dims in (
            ("forward", self.pn_dims), ("forward", [self.pn_dims[-1], self.cfg["mapping_size"]]),
            ("forward", self.dims), ("input_grad", self.dims),
            ("input_grad", [self.pn_dims[-1], self.cfg["mapping_size"]]),
            ("grads", self.pn_dims))]
        return {"window_s": window_s, "attempted": inr_steps + pn_steps, "failed": failed,
                "voxels": (inr_steps + pn_steps) * rows,
                "products": [("loss_grads", self.dims, rows, 1, inr_steps)] + pn}

    # -- check ----------------------------------------------------------------
    def observations(self) -> dict:
        obs = {"prep": {"ff": self.ff, "mean_target": self.mean_target,
                        "acq_pixels": self.acq_pixels},
               "grad": self.first.grad, "params": self.first.params}
        if self.pn_phase:
            acq = self._feed()[2]
            obs["losses"] = [float(((o - acq[a]) ** 2).mean()) for a, o in enumerate(self.outs)]
        else:
            obs["losses"] = self.setup_losses[:FOLLOWED].tolist()
        return driving.to_host(obs)

    def inputs(self) -> dict:
        return {"patient": self.patient, "B": self.B, "inr0": self.inr0, "pn0": self.pn0}

    def free(self) -> None:
        for name in ("inr_opt", "pn_opt", "inr_params", "ff", "mean_target", "acq_pixels",
                     "apply", "vag", "first", "outs"):
            self.__dict__.pop(name, None)


def expected(ref, inputs: dict, cfg: dict, traffic: dict) -> dict:
    """The reference's readings of the same steps from the same inputs."""
    prepped = ref.prep(inputs, cfg)
    pn_phase = traffic["unit"].get("pn_epochs", 0) > 0
    steps = (ref.pn_steps if pn_phase else ref.mean_steps)(inputs, cfg, prepped, FOLLOWED)
    return driving.to_host({"prep": prepped, **steps})


def compare(program: dict, reference: dict, inputs: dict, traffic: dict) -> dict:
    from portbench import compare as cmp

    pn_phase = traffic["unit"].get("pn_epochs", 0) > 0
    start = inputs["pn0"] if pn_phase else inputs["inr0"]
    out = {"prep_gap": max(cmp.array_gap(program["prep"][k], reference["prep"][k])
                           for k in ("ff", "mean_target", "acq_pixels"))}
    out.update(cmp.training(program, reference, start, stacked=False))
    return out
