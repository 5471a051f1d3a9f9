"""MISR dataset preprocessing: registration, selection, patching, baselines.

Copy of ``mri_super_resolution_tpu/data/preprocessing.py`` (reference:
multi-image-super-resolution/utils/preprocessing.py:19-294): register each
stack to its clearest frame by masked normalised cross-correlation, select
the best T frames by clearance, temporal-permutation augmentation, patch
extraction, all host-side numpy; and the bicubic baseline, which resizes
with the port's ``core/interp.py:rescale(order=3)`` (``jax.image.resize``'s
Keys cubic, a = -0.5, weights renormalised at the border).
"""
from __future__ import annotations

import numpy as np


def _masked_translation(
    ref: np.ndarray,
    img: np.ndarray,
    mask: np.ndarray,
    max_shift: int = 8,
    ref_mask: np.ndarray | None = None,
    overlap_ratio: float = 0.3,
) -> tuple[int, int]:
    """Integer translation maximising Padfield's masked NORMALIZED
    cross-correlation — the algorithm behind skimage's
    ``masked_register_translation`` used at preprocessing.py:155-166 (which
    passes one quality map for both images; ``ref_mask`` defaults to
    ``mask`` accordingly).

    Plain unnormalized masked correlation is biased toward shifts that
    overlap high-energy regions (the peak is weighted by image intensity
    inside the valid mask), so a frame with a large cloud-masked area can
    register to the wrong offset; normalizing each lag by its own overlap
    statistics (mean/variance over the jointly-valid pixels) removes the
    bias. Lags whose overlap is below ``overlap_ratio`` of the maximum are
    excluded, as in skimage.
    """
    M1 = np.asarray(mask if ref_mask is None else ref_mask, dtype=float)
    M2 = np.asarray(mask, dtype=float)
    f = np.where(M1 > 0, ref, 0.0).astype(float)
    g = np.where(M2 > 0, img, 0.0).astype(float)

    F1, F2 = np.fft.fft2(f), np.fft.fft2(g)
    M1f, M2f = np.fft.fft2(M1), np.fft.fft2(M2)

    def xcorr(A, B):
        return np.real(np.fft.ifft2(A * np.conj(B)))

    eps = np.finfo(float).eps
    overlap = xcorr(M1f, M2f)  # valid-pixel count at each lag
    n = np.maximum(np.round(overlap), eps)
    s1 = xcorr(F1, M2f)  # sum of ref over the overlap
    s2 = xcorr(M1f, F2)  # sum of img over the overlap
    num = xcorr(F1, F2) - s1 * s2 / n
    d1 = xcorr(np.fft.fft2(f * f), M2f) - s1 * s1 / n
    d2 = xcorr(M1f, np.fft.fft2(g * g)) - s2 * s2 / n
    denom = np.sqrt(np.maximum(d1, 0.0) * np.maximum(d2, 0.0))
    ncc = np.where(denom > eps ** 0.5, num / np.maximum(denom, eps), 0.0)
    ncc = np.clip(ncc, -1.0, 1.0)
    ncc = np.where(n >= overlap_ratio * n.max(), ncc, -1.0)

    ncc = np.fft.fftshift(ncc)
    c = np.array(ncc.shape) // 2
    window = ncc[
        c[0] - max_shift : c[0] + max_shift + 1, c[1] - max_shift : c[1] + max_shift + 1
    ]
    dy, dx = np.unravel_index(np.argmax(window), window.shape)
    return dy - max_shift, dx - max_shift


def _shift(img: np.ndarray, s: tuple[int, int], mode: str = "reflect", cval=0) -> np.ndarray:
    """Integer shift with edge handling (scipy.ndimage.shift for int offsets)."""
    out = img
    dy, dx = int(s[0]), int(s[1])
    if dy or dx:
        pad_mode = "reflect" if mode == "reflect" else "constant"
        kw = {} if pad_mode == "reflect" else {"constant_values": cval}
        out = np.pad(out, ((abs(dy),) * 2, (abs(dx),) * 2), mode=pad_mode, **kw)
        H, W = img.shape
        out = out[abs(dy) - dy : abs(dy) - dy + H, abs(dx) - dx : abs(dx) - dx + W]
    return out


def register_imgset(imgset: np.ndarray, mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Register (H, W, T) to the clearest frame (preprocessing.py:142-166).

    Note the reference returns the *unregistered* images with registered
    masks (``return imgset, mask_reg`` — preprocessing.py:166, a quirk).
    Here both registered arrays are returned; pass ``reference_behavior=True``
    via :func:`register_dataset` if byte-parity with the quirk is needed.
    """
    ref = imgset[..., np.argmax(np.mean(mask, axis=(0, 1)))]
    img_reg = np.empty_like(imgset, dtype=float)
    mask_reg = np.empty_like(mask, dtype=float)
    for i in range(imgset.shape[-1]):
        s = _masked_translation(ref, imgset[..., i], mask[..., i])
        img_reg[..., i] = _shift(imgset[..., i], s, mode="reflect")
        mask_reg[..., i] = _shift(mask[..., i].astype(float), s, mode="constant", cval=0)
    return img_reg, mask_reg


def register_dataset(X, masks, reference_behavior: bool = False):
    """Register every imgset (preprocessing.py:119-137)."""
    X_reg, m_reg = [], []
    for img, m in zip(X, masks):
        ir, mr = register_imgset(img, m)
        X_reg.append(img if reference_behavior else ir)
        m_reg.append(mr)
    return X_reg, m_reg


def select_T_images(X, masks, T: int = 9, thr: float = 0.85, remove_bad: bool = True, seed: int = 0):
    """Keep the clearest T frames per imgset (preprocessing.py:171-216)."""
    rng = np.random.default_rng(seed)
    X_sel, removed = [], []
    for i, (imgset, m) in enumerate(zip(X, masks)):
        clearance = np.mean(m, axis=(0, 1))
        keep = clearance > thr
        if not keep.any():
            if remove_bad:
                removed.append(i)
                continue
            best = int(np.argmax(clearance))
            keep = np.zeros_like(keep)
            keep[best] = True
        clear_imgs = imgset[..., keep]
        clear_vals = clearance[keep]
        order = list(np.argsort(clear_vals)[::-1])
        while len(order) < T:
            order.append(int(rng.choice(order)))
        X_sel.append(clear_imgs[..., order[:T]])
    return np.asarray(X_sel), removed


def augment_imgset(X_imgset: np.ndarray, y_imgset, y_mask, n_augment: int = 7, seed: int = 0):
    """Temporal-permutation augmentation x n (preprocessing.py:91-110)."""
    rng = np.random.default_rng(seed)
    T = X_imgset.shape[-1]
    outs = [X_imgset]
    for _ in range(n_augment - 1):
        outs.append(X_imgset[..., rng.permutation(T)])
    return (
        np.stack(outs),
        np.stack([y_imgset] * n_augment),
        np.stack([y_mask] * n_augment),
    )


def gen_sub(array: np.ndarray, d: int, s: int) -> np.ndarray:
    """Patch extraction with stride (preprocessing.py:219-266).

    (L, D0, D0, C) -> (L*n^2, d, d, C) with n = (D0-d)/s + 1.
    """
    if array.ndim != 4:
        raise ValueError("Wrong array shape.")
    d0 = array.shape[1]
    n = (d0 - d) / s + 1
    if int(n) != n:
        raise ValueError("d, s and n should be integer values.")
    n = int(n)
    out = np.empty((len(array) * n * n, d, d, array.shape[-1]), dtype=array.dtype)
    for l, X in enumerate(array):
        for i in range(n):
            for j in range(n):
                out[l * n * n + n * i + j] = X[i * s : i * s + d, j * s : j * s + d]
    return out


def bicubic(X: np.ndarray, scale: int = 3) -> np.ndarray:
    """Bicubic upscale baseline (preprocessing.py:269-294): (N, h, w, C) or
    (h, w, C) -> (N, h scale, w scale, C) float64, each channel resized in
    float32 as the JAX package does."""
    import torch

    from mri_super_resolution_tpu_torch.core.interp import rescale as _rescale

    if X.ndim == 3:
        X = X[None]
    if X.ndim != 4:
        raise ValueError("Wrong array shape.")
    lr = torch.as_tensor(np.moveaxis(np.asarray(X, dtype=np.float32), -1, 1))
    return np.moveaxis(_rescale(lr, scale, order=3).double().numpy(), 1, -1)
