"""Seeded inputs of the benchmark's cells, made on the device in a few bulk
calls from one ``torch.Generator``: the synthetic 3-D patient, the 2-D
directional case, the Fourier matrix and SIREN / PerturbNet weights.

The signal models are those of the port's ``data/synthetic.py``
(``hybrid_from_b0``, ``acquisitions_from_b0``) and of ``chip_smoke.py``'s
makers (``_b0_volume``, ``_b0_blob``): a smooth blob, mono-exponential
diffusion decay over a smooth ADC field, per-acquisition in-plane sub-voxel
shifts, Rician noise and, in the 2-D case, whole-acquisition dropouts. They
are copied here, in torch, so that the yardstick stays fixed whatever the
program's own generators become. The same seed gives the same arrays on the
same device.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer below
    2**64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def _axes(shape, device) -> list[torch.Tensor]:
    lin = [torch.linspace(-1.0, 1.0, int(n), dtype=torch.float64, device=device) for n in shape]
    return list(torch.meshgrid(*lin, indexing="ij"))


def blob(gen, shape, level: float, floor: float, jitter: float, device) -> torch.Tensor:
    """``level exp(-(x^2/0.5 + y^2/0.3 + z^2)) + floor + jitter U(0, 1)`` on
    the [-1, 1] grid of ``shape`` (2-D: no z term), float64."""
    ax = _axes(shape, device)
    r = ax[0] ** 2 / 0.5 + ax[1] ** 2 / 0.3 + (ax[2] ** 2 if len(ax) > 2 else 0.0)
    noise = torch.rand(tuple(shape), generator=gen, dtype=torch.float64, device=device)
    return level * torch.exp(-r) + floor + jitter * noise


def smooth_field(gen, shape, scale: float, base: float, amp: float, device,
                 count: int | None = None) -> torch.Tensor:
    """Low-pass filtered white noise rescaled to [base, base + amp]
    (``count`` fields at once along a leading axis when given)."""
    lead = () if count is None else (count,)
    noise = torch.randn(lead + tuple(shape), generator=gen, dtype=torch.float64, device=device)
    dims = tuple(range(len(lead), len(lead) + len(shape)))
    freqs = torch.meshgrid(*[torch.fft.fftfreq(int(n), dtype=torch.float64, device=device)
                             for n in shape], indexing="ij")
    r2 = sum(f ** 2 for f in freqs)
    f = torch.fft.fftn(noise, dim=dims) * torch.exp(-r2 / (2 * (scale / min(shape)) ** 2))
    field = torch.fft.ifftn(f, dim=dims).real
    flat = field.reshape(*lead, -1) if lead else field.reshape(1, -1)
    lo = flat.min(dim=-1).values.reshape(*lead, *([1] * len(shape)))
    hi = flat.max(dim=-1).values.reshape(*lead, *([1] * len(shape)))
    return base + amp * (field - lo) / (hi - lo + 1e-12)


def _shift_xy(vol: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Fourier-shift each of the stacked volumes (n, H, W, ...) in-plane by
    its own (dx, dy), periodically."""
    H, W = vol.shape[1], vol.shape[2]
    fx = torch.fft.fftfreq(H, dtype=torch.float64, device=vol.device)
    fy = torch.fft.fftfreq(W, dtype=torch.float64, device=vol.device)
    extra = vol.dim() - 3
    phase = (fx[None, :, None] * dx[:, None, None] + fy[None, None, :] * dy[:, None, None])
    phase = torch.exp(-2j * math.pi * phase).reshape(*phase.shape, *([1] * extra))
    return torch.fft.ifft2(torch.fft.fft2(vol, dim=(1, 2)) * phase, dim=(1, 2)).real


def _rician(gen, clean: torch.Tensor, sigma: float) -> torch.Tensor:
    re = clean + sigma * torch.randn(clean.shape, generator=gen, dtype=torch.float64,
                                     device=clean.device)
    im = sigma * torch.randn(clean.shape, generator=gen, dtype=torch.float64,
                             device=clean.device)
    return torch.sqrt(re * re + im * im)


def patient_3d(gen, shape, acq_counts, bvalues, device, noise_frac: float = 0.02,
               shift_sigma: float = 0.4) -> list[torch.Tensor]:
    """The 3-D pipeline's synthetic patient at its first TE (the one
    ``run_patient`` reads): per b-value a float32 (X, Y, S) volume for b = 0
    and an (X, Y, S, A_b) stack of ``acq_counts[b]`` acquisitions else, on
    ``device``."""
    b0 = 1000.0 * (blob(gen, shape, 1.0, 0.0, 0.05, device))
    adc = smooth_field(gen, shape, 3.0, 0.7, 1.8, device)
    sigma = noise_frac * float(torch.quantile(b0.reshape(-1)[::7], 0.995))
    out = []
    for b, n in zip(bvalues, acq_counts):
        clean = b0 * torch.exp(-float(b) * adc / 1000.0)
        if float(b) == 0.0:
            out.append(_rician(gen, clean, sigma).to(torch.float32))
            continue
        d = shift_sigma * torch.randn(2, int(n), generator=gen, dtype=torch.float64,
                                      device=device)
        moved = _shift_xy(clean.expand(int(n), *clean.shape), d[0], d[1])
        out.append(_rician(gen, moved, sigma).to(torch.float32).permute(1, 2, 3, 0)
                   .contiguous())
    return out


def case_2d(gen, side: int, n_acq: int, device, b: float = 900.0, noise_frac: float = 0.03,
            shift_sigma: float = 0.6, outlier_prob: float = 0.08) -> torch.Tensor:
    """A 2-D directional case's ROI: ``n_acq`` acquisitions of a unit-scaled
    (side, side) blob slice, float32 (side, side, n_acq) on ``device``;
    about ``outlier_prob`` of them are dropouts (what AutoERD rejects)."""
    b0 = blob(gen, (side, side), 100.0, 90.0, 5.0, device)
    b0 = b0 / b0.max()
    adc = smooth_field(gen, (side, side), 3.0, 0.7, 1.8, device)
    signal = b0 * torch.exp(-b * adc / 1000.0)
    sigma = noise_frac * float(torch.quantile(b0.reshape(-1), 0.995))
    d = shift_sigma * torch.randn(2, n_acq, generator=gen, dtype=torch.float64, device=device)
    moved = _shift_xy(signal.expand(n_acq, side, side), d[0], d[1])
    drop = smooth_field(gen, (side, side), 2.0, 0.2, 0.6, device, count=n_acq)
    hit = torch.rand(n_acq, generator=gen, dtype=torch.float64, device=device) < outlier_prob
    moved = torch.where(hit[:, None, None], moved * drop, moved)
    return _rician(gen, moved, sigma).to(torch.float32).permute(1, 2, 0).contiguous()


def fourier_matrix(gen, mapping_size: int, dim: int, scale: float, device) -> torch.Tensor:
    """B ~ N(0, 1) * scale, (mapping_size, dim) float32."""
    return scale * torch.randn(mapping_size, dim, generator=gen, device=device)


def siren_weights(gen, dims, device, omega: float = 30.0, slots: int | None = None):
    """SIREN-initialised weights ``[W0, b0, ..., W_last, b_last]`` (torch
    ``nn.Linear`` layout) of the MLP ``dims[0] -> ... -> dims[-1]``: first W
    ~ U(+-1/in), the others U(+-sqrt(6/in)/omega), biases U(+-1/sqrt(in)).
    One uniform draw for all of them; ``slots`` stacks that many models
    along a leading axis. Float32 on ``device``."""
    lead = () if slots is None else (int(slots),)
    sizes = [n for i, o in zip(dims[:-1], dims[1:]) for n in (o * i, o)]
    flat = torch.rand(*lead, sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = [], 0
    for layer, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        w_bound = 1.0 / i if layer == 0 else math.sqrt(6.0 / i) / omega
        w = flat[..., at:at + o * i].reshape(*lead, o, i) * w_bound
        at += o * i
        b = flat[..., at:at + o] * (1.0 / math.sqrt(i))
        at += o
        out += [w.contiguous(), b.contiguous()]
    return out


def lecun_weights(gen, dims, device):
    """``[W0, b0, W1, b1, ...]`` with W from a normal of variance 1/in
    truncated at two standard deviations (flax's lecun_normal, as the
    PerturbNet starts) and biases U(+-1/sqrt(in)). Float32 on ``device``."""
    out = []
    for i, o in zip(dims[:-1], dims[1:]):
        std = math.sqrt(1.0 / i) / 0.87962566103423978
        w = torch.empty(o, i, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        b = (torch.rand(o, generator=gen, device=device) * 2.0 - 1.0) / math.sqrt(i)
        out += [w, b]
    return out
