"""Driver of ``fit/engine.py:infer_dense_grid`` as the 3-D pipeline resamples
a fitted INR: K3 (``siren_fused``'s forward) on the Fourier features of
each chunk of the dense grid, clamped at 0, the result a host array.

A closed loop of one client: each request is one call on the next of the
traffic's ``grids`` in turn (``run_patient``'s 2x and HR grids, then
``coronal_recon``'s), timed from its call to its result in hand. The
set-up serves each grid once (the warm-up). A sample of the window's
answers, drawn from the seed, is kept for the check.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import driving, inputs as make

KEEP_PER_GRID = 2


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault: str | None = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device, self.fault = torch.device(device), fault

    def setup(self) -> None:
        from mri_super_resolution_tpu_torch import set_float32_precision
        from mri_super_resolution_tpu_torch.fit.engine import infer_dense_grid
        from mri_super_resolution_tpu_torch.ops.siren_kernel import siren_fused

        cfg, dev = self.cfg, self.device
        set_float32_precision()
        gen = make.generator(self.seed, dev)
        dim = len(cfg["patient_shape"]) + 1
        self.B = make.fourier_matrix(gen, cfg["mapping_size"], dim, cfg["ff_scale"], dev)
        self.dims = [2 * cfg["mapping_size"]] + [cfg["hidden_dim"]] * (cfg["num_layers"] + 1) + [1]
        self.inr0 = make.siren_weights(gen, self.dims, dev, cfg["omega"])
        # a fitted INR's output spans the normalised signal: the output
        # layer's weights scaled up and its bias set (the traffic's
        # ``served_head``), so that the answers are not mostly clamped to 0
        head = self.traffic["served_head"]
        self.inr0[-2] = self.inr0[-2] * head["weight_scale"]
        self.inr0[-1] = torch.full_like(self.inr0[-1], head["bias"])
        self.params = [p.clone() for p in self.inr0]
        omegas = (float(cfg["omega"]),) * (cfg["num_layers"] + 1)
        self.apply = self._planted(lambda params, x: siren_fused(x, params, omegas))
        self.infer = infer_dense_grid
        self.grids = [tuple(g) for g in self.traffic["grids"]]
        self.rng = np.random.default_rng(self.seed % (1 << 63))
        for shape in self.grids:
            self._request(self.apply, shape)
        driving.sync(dev)

    def _planted(self, apply):
        if self.fault == "altered":
            def altered(params, x):
                out = apply(params, x).clone()
                out.view(-1)[out.argmax()] *= 1.01  # the largest answer, 1% off
                return out
            return altered
        if self.fault == "half_batch":
            def half(params, x):
                out = apply(params, x).clone()
                out[out.shape[0] // 2:] = 0.0
                return out
            return half
        return apply

    def _request(self, apply, shape):
        return self.infer(apply, self.params, shape, clamp_min=0.0, fourier_B=self.B)

    def window(self, seconds: float, recorder) -> dict:
        apply = recorder.wrap("apply", self.apply, driving.mlp_signature("forward"))
        latencies, served = [], []
        seen = [0] * len(self.grids)
        self.kept: list[tuple[int, int, np.ndarray]] = []  # (grid, request, answer)

        def one():
            g = len(latencies) % len(self.grids)
            t0 = time.perf_counter()
            out = self._request(apply, self.grids[g])
            latencies.append(1e3 * (time.perf_counter() - t0))
            served.append(out.shape[0])
            # reservoir sample of KEEP_PER_GRID answers of each grid
            seen[g] += 1
            mine = [k for k in self.kept if k[0] == g]
            if len(mine) < KEEP_PER_GRID:
                self.kept.append((g, seen[g], out))
            else:
                j = int(self.rng.integers(seen[g]))
                if j < KEEP_PER_GRID:
                    self.kept[self.kept.index(mine[j])] = (g, seen[g], out)

        window_s = driving.timed_window(seconds, self.device, recorder, one)
        enc = [self.B.shape[1], self.B.shape[0]]  # the Fourier mapping's product
        products = []
        for g, shape in enumerate(self.grids):
            n = sum(1 for i in range(len(latencies)) if i % len(self.grids) == g)
            rows = math.prod(shape)
            products += [("forward", enc, rows, 1, n), ("forward", self.dims, rows, 1, n)]
        return {"window_s": window_s, "attempted": len(latencies), "failed": 0,
                "latencies_ms": latencies, "voxels": sum(served), "products": products}

    def observations(self) -> dict:
        return {"answers": [(self.grids[g], out) for g, _, out in self.kept]}

    def inputs(self) -> dict:
        return {"B": self.B, "inr0": self.inr0}

    def free(self) -> None:
        for name in ("params", "apply"):
            self.__dict__.pop(name, None)


def expected(ref, inputs: dict, cfg: dict, traffic: dict) -> dict:
    grids = {tuple(g): ref.dense_grid(inputs, cfg, g).cpu() for g in traffic["grids"]}
    return {"grids": grids, "answers": list(grids.items())}


def compare(program: dict, reference: dict, inputs: dict, traffic: dict) -> dict:
    from portbench import compare as cmp

    if not program["answers"]:
        return {"out_gap": float("inf")}
    return {"out_gap": max(cmp.array_gap(out, reference["grids"][shape])
                           for shape, out in program["answers"])}
