"""Synthetic DWI acquisition generation.

Copy of ``mri_super_resolution_tpu/data/synthetic.py`` (numpy only; the port
imports nothing of the JAX package). Same seeds give the same arrays.

The distributed anon_data contains only mean-b0 and ERD volumes; the 4-D
``pat*_alldata.mat`` acquisition stacks the reference loader expects
(implicit-neural-representations/nn_mri.py:46-54) are not shipped. To keep
every pipeline runnable (and benchmarkable) end-to-end, this module simulates
repeated diffusion-weighted acquisitions from a mean b0 volume with the same
physical structure the real data has:

- mono-exponential diffusion decay ``S = S0 * exp(-b * ADC / 1e6)`` with a
  spatially varying ADC field,
- per-acquisition rigid sub-voxel shifts (the motion PerturbNet models,
  SRDWI.py:93-109),
- Rician noise (magnitude MR images; the Rayleigh noise-floor correction at
  INR_ERD.py:178-181 assumes exactly this),
- occasional whole-acquisition dropouts/outliers (what ERD rejects).

Also provides the toy fixtures standing in for ``toy.mat`` / ``toy2.mat``
(inr_toy.py:65-70, automate_INR.py:20-21), which are likewise absent.
"""
from __future__ import annotations

import numpy as np


def _smooth_field(rng: np.random.Generator, shape, scale: float, base: float, amp: float) -> np.ndarray:
    """Low-frequency random field via Fourier-domain low-pass of white noise."""
    noise = rng.normal(size=shape)
    f = np.fft.fftn(noise)
    freqs = np.meshgrid(*[np.fft.fftfreq(n) for n in shape], indexing="ij")
    r2 = sum(fr**2 for fr in freqs)
    f *= np.exp(-r2 / (2 * (scale / min(shape)) ** 2))
    field = np.real(np.fft.ifftn(f))
    field = (field - field.min()) / (field.max() - field.min() + 1e-12)
    return base + amp * field


def _subpixel_shift2d(img: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Fourier-shift a 2-D image by a sub-pixel offset (periodic)."""
    H, W = img.shape
    fx = np.fft.fftfreq(H)[:, None]
    fy = np.fft.fftfreq(W)[None, :]
    phase = np.exp(-2j * np.pi * (fx * dx + fy * dy))
    return np.real(np.fft.ifft2(np.fft.fft2(img) * phase))


def acquisitions_from_b0(
    b0: np.ndarray,
    num_acq: int,
    b: float = 900.0,
    seed: int = 0,
    noise_sigma_frac: float = 0.03,
    shift_sigma: float = 0.6,
    outlier_prob: float = 0.08,
) -> np.ndarray:
    """Simulate a ``(H, W, S, A)`` acquisition stack from a ``(H, W, S)`` b0.

    Each acquisition sees diffusion decay with a shared smooth ADC field, a
    random rigid in-plane sub-voxel shift, Rician noise at ``noise_sigma_frac``
    of the volume's robust max, and with probability ``outlier_prob`` a strong
    signal-dropout multiplier (the artifact class ERD is built to reject).
    """
    rng = np.random.default_rng(seed)
    H, W, S = b0.shape
    adc = _smooth_field(rng, (H, W, S), scale=3.0, base=0.7, amp=1.8)  # 1e-3 mm^2/s
    signal = b0 * np.exp(-b * adc / 1e6 * 1000.0)  # b*ADC/1000 with ADC in 1e-3 units
    sigma = noise_sigma_frac * np.percentile(b0, 99.5)

    out = np.empty((H, W, S, num_acq), dtype=np.float32)
    for a in range(num_acq):
        dx, dy = rng.normal(0.0, shift_sigma, size=2)
        moved = np.stack(
            [_subpixel_shift2d(signal[:, :, s], dx, dy) for s in range(S)], axis=-1
        )
        if rng.uniform() < outlier_prob:
            drop = _smooth_field(rng, (H, W, S), scale=2.0, base=0.2, amp=0.6)
            moved = moved * drop
        re = moved + rng.normal(0.0, sigma, size=moved.shape)
        im = rng.normal(0.0, sigma, size=moved.shape)
        out[..., a] = np.sqrt(re**2 + im**2).astype(np.float32)
    return out


def hybrid_from_b0(
    b0: np.ndarray,
    b_values=(0.0, 150.0, 1000.0, 1500.0),
    te_values=(57.0, 70.0, 150.0, 200.0),
    acq_counts=(1, 3, 5, 5),
    seed: int = 0,
    noise_sigma_frac: float = 0.02,
    shift_sigma: float = 0.4,
    return_clean: bool = False,
    dedup_te: bool = False,
) -> list[list[np.ndarray]]:
    """Synthesize the nested ``hybrid_raw[b][te]`` structure of master.mat
    (superresDWI.py:40-55): per (b, TE), a volume with ``acq_counts[b]``
    repeated acquisitions (b=0 entry is a single volume without the trailing
    acquisition axis, matching ``calculate_combinations``'s b0 handling,
    SRDWI.py:145-147).

    Signal model: S = b0 * exp(-b*ADC/1e3 [ADC in 1e-3 mm^2/s]) * exp(-TE/T2)
    with smooth ADC/T2 fields, plus Rician noise.

    With ``return_clean=True`` returns ``(hybrid_raw, clean)`` where
    ``clean[b][te]`` is the underlying noise-free, motion-free ``(H, W, S)``
    signal volume — the exact zero-noise ground truth the split-acquisition
    quality protocol's held-out mean approaches (up to the Rician noise
    floor and the sub-pixel motion blur, which the round-5 ladder analysis
    quantifies, results/round5_quality/).

    ``dedup_te=True`` synthesizes only the TE0 entry per b and aliases the
    remaining TE slots to the same array. The 3-D pipeline consumes only
    ``hybrid_raw[b][0]`` (superres3d.run_patient / superresDWI.py:52-82 use
    a fixed TE), so this is behaviorally identical there at 1/4 the
    synthesis cost; do NOT use it for hybrid/PIA consumers that fit the TE
    axis. The RNG stream differs from the default path.
    """
    rng = np.random.default_rng(seed)
    H, W, S = b0.shape
    adc = _smooth_field(rng, (H, W, S), scale=3.0, base=0.7, amp=1.8)
    t2 = _smooth_field(rng, (H, W, S), scale=3.0, base=50.0, amp=400.0)
    sigma = noise_sigma_frac * np.percentile(b0, 99.5)

    out: list[list[np.ndarray]] = []
    clean_out: list[list[np.ndarray]] = []
    for bi, b in enumerate(b_values):
        row: list[np.ndarray] = []
        clean_row: list[np.ndarray] = []
        decay_b = np.exp(-b * adc / 1000.0)
        for te in te_values:
            if dedup_te and len(row):
                row.append(row[0])
                clean_row.append(clean_row[0])
                continue
            clean = b0 * decay_b * np.exp(-(te - te_values[0]) / t2)
            clean_row.append(clean.astype(np.float32))
            if bi == 0:
                re = clean + rng.normal(0.0, sigma, clean.shape)
                im = rng.normal(0.0, sigma, clean.shape)
                row.append(np.sqrt(re**2 + im**2).astype(np.float32))
            else:
                acqs = np.empty((H, W, S, acq_counts[bi]), dtype=np.float32)
                for a in range(acq_counts[bi]):
                    # draw shift even at sigma=0 so the RNG stream (and thus
                    # every downstream noise draw) is identical across
                    # shift_sigma values — the round-5 zero-motion causal arm
                    # must differ from the default ONLY in the motion
                    dx, dy = rng.normal(0.0, shift_sigma, size=2)
                    if shift_sigma > 0.0:
                        moved = np.stack(
                            [_subpixel_shift2d(clean[:, :, s], dx, dy)
                             for s in range(S)],
                            axis=-1,
                        )
                    else:
                        moved = clean
                    re = moved + rng.normal(0.0, sigma, moved.shape)
                    im = rng.normal(0.0, sigma, moved.shape)
                    acqs[..., a] = np.sqrt(re**2 + im**2)
                row.append(acqs)
        out.append(row)
        clean_out.append(clean_row)
    if return_clean:
        return out, clean_out
    return out


def hybrid_from_tissue(
    b0: np.ndarray,
    b_values=(0.0, 150.0, 1000.0, 1500.0),
    te_values=(57.0, 70.0, 150.0, 200.0),
    acq_counts=(1, 3, 5, 5),
    seed: int = 0,
    noise_sigma_frac: float = 0.02,
    shift_sigma: float = 0.4,
) -> tuple[list[list[np.ndarray]], dict[str, np.ndarray]]:
    """Three-compartment hybrid synthesis with known ground-truth maps.

    Unlike :func:`hybrid_from_b0` (mono-exponential — a substrate on which
    the 3-compartment decomposition is NON-identifiable, see
    results/round3_pia/hybrid_ab.json), this generator draws smooth
    per-compartment D/T2 fields inside the physiological priors the fitters
    assume (PIA.py:171-213 ranges) and simplex volume fractions, and
    synthesizes

        S(b, TE) = b0 * sum_c v_c exp(-b/1000 D_c) exp(-(TE - TE0)/T2_c)

    TE decay is RELATIVE to TE0, matching the reference convention
    (PIA.py:257 ``normTE = [0, 13, 93, 143]``): after the pipeline's
    (b0, TE0) normalization (superresHybrid.py:130-133) the signal is
    exactly in the fitters' model class with the true simplex ``v`` — so
    parameter recovery through the full pipeline is well-posed.

    Returns ``(hybrid_raw, gt)`` with ``gt`` holding ``D``/``T2``
    (um^2/ms, ms) and ``v`` fields of shape ``(H, W, S, 3)``
    (epithelium, stroma, lumen).
    """
    rng = np.random.default_rng(seed)
    H, W, S = b0.shape
    shape = (H, W, S)
    # per-compartment smooth fields inside the priors (PIA.py ranges)
    D = np.stack(
        [
            _smooth_field(rng, shape, 3.0, 0.3, 0.4),  # epithelium 0.3-0.7
            _smooth_field(rng, shape, 3.0, 0.7, 1.0),  # stroma 0.7-1.7
            _smooth_field(rng, shape, 3.0, 2.7, 0.3),  # lumen 2.7-3.0
        ],
        axis=-1,
    )
    T2 = np.stack(
        [
            _smooth_field(rng, shape, 3.0, 20.0, 50.0),  # 20-70
            _smooth_field(rng, shape, 3.0, 40.0, 60.0),  # 40-100
            _smooth_field(rng, shape, 3.0, 500.0, 500.0),  # 500-1000
        ],
        axis=-1,
    )
    logits = np.stack(
        [_smooth_field(rng, shape, 3.0, 0.0, 3.0) for _ in range(3)], axis=-1
    )
    e = np.exp(logits - logits.max(-1, keepdims=True))
    v = e / e.sum(-1, keepdims=True)

    sigma = noise_sigma_frac * np.percentile(b0, 99.5)
    te0 = te_values[0]
    out: list[list[np.ndarray]] = []
    for bi, b in enumerate(b_values):
        row: list[np.ndarray] = []
        decay_b = np.exp(-b / 1000.0 * D)  # (H, W, S, 3)
        for te in te_values:
            clean = b0 * np.sum(
                v * decay_b * np.exp(-(te - te0) / T2), axis=-1
            )
            if bi == 0:
                re = clean + rng.normal(0.0, sigma, clean.shape)
                im = rng.normal(0.0, sigma, clean.shape)
                row.append(np.sqrt(re**2 + im**2).astype(np.float32))
            else:
                acqs = np.empty((H, W, S, acq_counts[bi]), dtype=np.float32)
                for a in range(acq_counts[bi]):
                    if shift_sigma > 0:
                        dx, dy = rng.normal(0.0, shift_sigma, size=2)
                        moved = np.stack(
                            [_subpixel_shift2d(clean[:, :, s], dx, dy)
                             for s in range(S)],
                            axis=-1,
                        )
                    else:
                        moved = clean
                    re = moved + rng.normal(0.0, sigma, moved.shape)
                    im = rng.normal(0.0, sigma, moved.shape)
                    acqs[..., a] = np.sqrt(re**2 + im**2)
                row.append(acqs)
        out.append(row)
    return out, {"D": D, "T2": T2, "v": v}


def toy_image(side: int = 180, seed: int = 0) -> np.ndarray:
    """A structured toy target (rings + gradient), stand-in for toy.mat."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side] / side
    img = (
        0.5
        + 0.3 * np.sin(14 * np.pi * ((x - 0.5) ** 2 + (y - 0.45) ** 2))
        + 0.2 * x
    )
    img += 0.02 * rng.normal(size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def toy_perturbed_acquisitions(
    side: int = 128, num_acq: int = 20, seed: int = 0, shift_sigma: float = 1.0
) -> np.ndarray:
    """``(side, side, A)`` shifted noisy copies of the toy image
    (the ``pertubed_acq`` array of toy2.mat, automate_INR.py:20-21)."""
    rng = np.random.default_rng(seed)
    base = toy_image(side, seed)
    out = np.empty((side, side, num_acq), dtype=np.float32)
    for a in range(num_acq):
        dx, dy = rng.normal(0.0, shift_sigma, size=2)
        img = _subpixel_shift2d(base, dx, dy)
        out[..., a] = img + 0.01 * rng.normal(size=img.shape)
    return out
