"""Driver of ``pipelines/misr.py:predict_case`` as ``cli/misr_master.py
--conv_kernel`` serves a case: the network restored with
``misr.load_model`` from the checkpoint's flax-named arrays, then per
request master.py's draws of ``sample_size`` x ``channels`` of a case's
acquisitions, one batched RAMS forward (bfloat16 activations, the 34 3x3x3
32-channel convs on K6) under ``torch.inference_mode``, the clip and
round, the mean DWI and the ADC, and one copy back to the host.

A closed loop of one client: each request is one call on the next of the
cases in turn, each with its own draw seed, timed from its call to both
answers in hand. The set-up serves each case once (the warm-up, and K6's
build or load). A reservoir sample of the window's answers, drawn from the
seed, is kept for the check.

Faults the limits are calibrated against (the first two as ``driving.py``
names them; ``calibrate_bf16.py``, the CPU tests): ``half_batch`` (the second
half of a request's draws replaced by the mean of the first half, so that
the mean is taken over the rest), ``altered`` (one returned DWI voxel
moved by 1% of the answer's range) and ``stale`` (each request returns
the answer of the previous request of its case).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import driving, inputs as make
from portbench.metrics import _conv

KEEP_PER_CASE = 2
# each case's acquisitions scaled so that their median x 256 (the uint16
# range predict_case serves) is this: the checkpoint's working range, where
# 0.4-3.5% of a request's answer clips at 0 and 5-10% at 2^16
MEDIAN_UINT16 = 14_000.0


def seeded_params(cfg: dict, seed: int) -> dict:
    """Flax-named ``params/<module>/<leaf>`` arrays of a RAMS at ``cfg``'s
    widths, drawn from the seed (the CPU tests' tiny configurations; the
    cell serves the checkpoint): ``v`` glorot-uniform, ``g`` 1 + U(0, 0.2),
    ``bias`` U(+-0.05), float32."""
    rng = np.random.default_rng(seed % (1 << 63))
    f, t, s, r = cfg["filters"], cfg["channels"], cfg["scale"], cfg["r"]
    flat = {}

    def wn(name, shape):
        receptive = int(np.prod(shape[:-2]))
        limit = np.sqrt(6.0 / (receptive * (shape[-2] + shape[-1])))
        flat[f"params/{name}/v"] = rng.uniform(-limit, limit, shape).astype(np.float32)
        flat[f"params/{name}/g"] = (1.0 + 0.2 * rng.random(shape[-1])).astype(np.float32)
        flat[f"params/{name}/bias"] = (0.1 * rng.random(shape[-1]) - 0.05).astype(np.float32)

    def block(name, c, k):
        for i, shape in enumerate([k + (c, c), k + (c, c), (1,) * len(k) + (c, c // r),
                                   (1,) * len(k) + (c // r, c)]):
            wn(f"{name}/WNConv_{i}", shape)

    steps, k3 = t // 3, (3, 3, 3)
    wn("WNConv_0", k3 + (1, f))
    for i in range(cfg["N"] + steps):
        block(f"RFAB_{i}", f, k3)
    wn("WNConv_1", k3 + (f, f))
    for i in range(steps):
        wn(f"WNConv_{2 + i}", k3 + (f, f))
    wn(f"WNConv_{2 + steps}", k3 + (f, s * s))
    block("RTAB_0", t, (3, 3))
    wn(f"WNConv_{3 + steps}", (3, 3, t, s * s))
    return flat


def cases(gen, traffic: dict, device) -> list[dict]:
    """The cycle's synthetic cases, made on ``device`` from ``gen``: per
    b-value a ``(side, side, A)`` acquisition slice and its ``(side, side)``
    b0 (``inputs.case_2d``'s model), both scaled so that the acquisitions'
    median is :data:`MEDIAN_UINT16` / 256, as host float32 arrays."""
    side, n_acq = traffic["side"], int(sum(traffic["acquisitions"]))
    out = []
    for b in traffic["bvalues"]:
        b0 = make.blob(gen, (side, side), 100.0, 90.0, 5.0, device)
        b0 = b0 / b0.max()
        adc = make.smooth_field(gen, (side, side), 3.0, 0.7, 1.8, device)
        signal = b0 * torch.exp(-float(b) * adc / 1000.0)
        sigma = 0.03 * float(torch.quantile(b0.reshape(-1), 0.995))
        d = 0.6 * torch.randn(2, n_acq, generator=gen, dtype=torch.float64, device=device)
        moved = make._shift_xy(signal.expand(n_acq, side, side), d[0], d[1])
        drop = make.smooth_field(gen, (side, side), 2.0, 0.2, 0.6, device, count=n_acq)
        hit = torch.rand(n_acq, generator=gen, dtype=torch.float64, device=device) < 0.08
        moved = torch.where(hit[:, None, None], moved * drop, moved)
        dwi = make._rician(gen, moved, sigma).permute(1, 2, 0)
        level = MEDIAN_UINT16 / 256.0 / float(dwi.median())
        out.append({"b": float(b), "dwi": (level * dwi).to(torch.float32).cpu().numpy(),
                    "b0": (level * b0).to(torch.float32).cpu().numpy()})
    return out


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault: str | None = None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device, self.fault = torch.device(device), fault

    def setup(self) -> None:
        from mri_super_resolution_tpu_torch import convert, set_float32_precision
        from mri_super_resolution_tpu_torch.config import RAMSConfig
        from mri_super_resolution_tpu_torch.data import Case
        from mri_super_resolution_tpu_torch.pipelines import misr

        cfg, traffic, dev = self.cfg, self.traffic, self.device
        set_float32_precision()
        if cfg["weights"] == "checkpoint":
            with np.load(convert.RAMS_PARAMS_NPZ, allow_pickle=False) as z:
                self.params = {k: z[k] for k in z.files}  # the raw arrays, for the reference
            tree = convert.load_params_npz(convert.RAMS_PARAMS_NPZ)
        else:
            self.params = seeded_params(cfg, self.seed)
            tree = {}
            for key, arr in self.params.items():
                *path, leaf = key.split("/")
                node = tree
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = arr
        self.rams_cfg = RAMSConfig(
            scale=cfg["scale"], filters=cfg["filters"], kernel_size=cfg["kernel_size"],
            channels=cfg["channels"], r=cfg["r"], N=cfg["N"], mean=cfg["mean"], std=cfg["std"],
            compute_dtype=cfg["compute_dtype"], conv_kernel=cfg["conv_kernel"])
        self.model = misr.load_model(self.rams_cfg, convert.rams_state_dict(tree), dev)
        self.cases = cases(make.generator(self.seed, dev), traffic, dev)
        self.served = [Case(pt_id=f"synthetic-{i}", b=c["b"], cancer_loc=(0, 0),
                            contralateral_loc=(0, 0), noise=(0, 0), cancer_slice=0,
                            acquisitions=tuple(traffic["acquisitions"]), dwi=c["dwi"][:, :, None],
                            b0=c["b0"][:, :, None], erd=np.zeros_like(c["b0"][:, :, None]),
                            accept=np.ones(c["dwi"][:, :, None].shape, dtype=np.int32))
                       for i, c in enumerate(self.cases)]
        self.predict = misr.predict_case
        self.apply = self._planted(self.model)
        self.rng = np.random.default_rng(self.seed % (1 << 63))
        self.count = 0
        self.last: dict[int, tuple] = {}
        for i in range(len(self.served)):
            self._request(i)
        driving.sync(dev)

    def _planted(self, model):
        if self.fault != "half_batch":
            return model

        def half(x):
            out = model(x).clone()
            keep = out.shape[0] - out.shape[0] // 2
            out[keep:] = out[:keep].mean(dim=0)  # the mean is then that of the first half
            return out

        return half

    def _request(self, i: int):
        """One request on case ``i``: ``(draw seed, mean DWI, ADC)``."""
        seed = (self.seed % (1 << 63)) * 1_000_003 + self.count
        self.count += 1
        with torch.inference_mode():
            dwi, adc = self.predict(self.apply, self.served[i], self.rams_cfg,
                                    self.traffic["sample_size"], seed, self.device)
        if self.fault == "altered":
            dwi = dwi.copy()
            dwi.flat[int(dwi.argmax())] += 0.01 * float(dwi.max() - dwi.min())
        if self.fault == "stale":
            previous = self.last.get(i)
            self.last[i] = (dwi, adc)
            if previous is not None:
                return (seed, *previous)
        return seed, dwi, adc

    def window(self, seconds: float, recorder) -> dict:
        latencies, served = [], []
        seen = [0] * len(self.served)
        self.kept: list[tuple[int, int, int, np.ndarray, np.ndarray]] = []

        def one():
            i = len(latencies) % len(self.served)
            t0 = time.perf_counter()
            seed, dwi, adc = self._request(i)
            latencies.append(1e3 * (time.perf_counter() - t0))
            served.append(dwi.size)
            # reservoir sample of KEEP_PER_CASE answers of each case
            seen[i] += 1
            mine = [k for k in self.kept if k[0] == i]
            if len(mine) < KEEP_PER_CASE:
                self.kept.append((i, seen[i], seed, dwi, adc))
            else:
                j = int(self.rng.integers(seen[i]))
                if j < KEEP_PER_CASE:
                    self.kept[self.kept.index(mine[j])] = (i, seen[i], seed, dwi, adc)

        window_s = driving.timed_window(seconds, self.device, recorder, one)
        side = self.traffic["side"]
        convs = _conv.rams_convs(self.cfg, self.traffic["sample_size"], side, side)
        return {"window_s": window_s, "attempted": len(latencies), "failed": 0,
                "latencies_ms": latencies, "voxels": sum(served), "requests": len(latencies),
                "convs": convs}

    def observations(self) -> dict:
        return {"answers": [(i, seed, dwi, adc) for i, _, seed, dwi, adc in self.kept]}

    def inputs(self) -> dict:
        return {"params": self.params, "cases": self.cases, "device": str(self.device),
                "requests": [(i, seed) for i, _, seed, _, _ in self.kept]}

    def free(self) -> None:
        for name in ("model", "apply", "last"):
            self.__dict__.pop(name, None)


def expected(ref, inputs: dict, cfg: dict, traffic: dict, precision: str = "float32") -> dict:
    """The reference's answers to the kept requests, on the device the
    program ran on (the card in a run)."""
    device = inputs["device"]
    net = ref.network(inputs["params"], device)
    answers = []
    for i, seed in inputs["requests"]:
        case = inputs["cases"][i]
        dwi, adc = ref.predict_case(net, case["dwi"], case["b0"], case["b"], seed,
                                    cfg["channels"], traffic["sample_size"], cfg["scale"], device,
                                    precision)
        answers.append((i, seed, dwi, adc))
    return {"answers": answers}


ADC_FLOOR = 0.01  # the ADC is compared where the mean DWI is at least this share of its range


def _gaps(program: np.ndarray, reference: np.ndarray, where=None) -> tuple[float, float]:
    """``(max |p - r|, rms(p - r))`` over the voxels ``where`` (all by
    default), over the reference answer's range there (denormalize adds
    7,433.6 to every voxel, so its max would hide every gap)."""
    p, r = np.asarray(program, dtype=np.float64), np.asarray(reference, dtype=np.float64)
    if p.shape != r.shape:
        return float("inf"), float("inf")
    if where is not None:
        p, r = p[where], r[where]
    span = max(float(r.max() - r.min()), 1e-30)
    d = p - r
    return float(np.abs(d).max()) / span, float(np.sqrt(np.mean(d * d))) / span


def compare(program: dict, reference: dict, inputs: dict, traffic: dict) -> dict:
    """``dwi_gap`` and ``dwi_rms_gap`` (the mean DWI) and ``adc_gap`` (the
    ADC map), each the worst over the kept answers. The ADC is compared
    where the reference's mean DWI is at least :data:`ADC_FLOOR` of its
    range above its least: where every draw clipped to 0, the log reads
    how many did, and a rounding of one draw moves it by thousands."""
    if not program["answers"]:
        return {"dwi_gap": float("inf"), "dwi_rms_gap": float("inf"), "adc_gap": float("inf")}
    ref = {(i, seed): (dwi, adc) for i, seed, dwi, adc in reference["answers"]}
    out = {"dwi_gap": 0.0, "dwi_rms_gap": 0.0, "adc_gap": 0.0}
    for i, seed, dwi, adc in program["answers"]:
        want = ref.get((i, seed))
        if want is None:
            return {k: float("inf") for k in out}
        worst, rms = _gaps(dwi, want[0])
        out["dwi_gap"] = max(out["dwi_gap"], worst)
        out["dwi_rms_gap"] = max(out["dwi_rms_gap"], rms)
        dwi_ref = np.asarray(want[0])
        lit = dwi_ref >= dwi_ref.min() + ADC_FLOOR * (dwi_ref.max() - dwi_ref.min())
        out["adc_gap"] = max(out["adc_gap"], _gaps(adc, want[1], lit)[0])
    return out
