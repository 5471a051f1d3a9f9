"""Experiment-CSV analysis and visualisation.

Copy of ``mri_super_resolution_tpu/utils/analysis.py`` (:17-101; reference
analyze_results.ipynb cells 2-8 and observe_epochs.m): pandas aggregation
of the contrast CSVs, seaborn barplots by image type, and a PNG filmstrip
and GIF of the reconstruction snapshots that ``cli/automate_inr.py`` saves.
pandas, matplotlib and seaborn are imported inside the functions, so the
package imports without them; no torch.
"""
from __future__ import annotations

import os

import numpy as np


def load_contrast_csv(path: str):
    """Load a master.py-schema CSV into a tidy DataFrame."""
    import pandas as pd

    return pd.read_csv(path)


def summarize_contrast(df, metric: str = "CNR"):
    """Mean, std and count of a metric per image type (analyze_results
    cells 3-5)."""
    sub = df[df["metric"] == metric]
    return sub.groupby("image")["performance"].agg(["mean", "std", "count"])


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def barplot_metric(df, metric: str, out_path: str, direction: str | None = None):
    """Seaborn barplot of ``metric`` by image type across patients."""
    plt = _pyplot()
    import seaborn as sns

    sub = df[df["metric"] == metric]
    if direction is not None:
        sub = sub[sub["direction"] == direction]
    fig, ax = plt.subplots(figsize=(10, 5))
    sns.barplot(data=sub, x="image", y="performance", errorbar="sd", ax=ax)
    ax.set_title(f"{metric}" + (f" ({direction})" if direction else ""))
    ax.tick_params(axis="x", rotation=30)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def epoch_filmstrip(snapshots: np.ndarray, mean_image: np.ndarray, out_path: str,
                    max_frames: int = 12):
    """observe_epochs.m: the (H, W, T) reconstruction snapshots, at most
    ``max_frames`` of them evenly spaced, beside the mean image."""
    plt = _pyplot()
    T = snapshots.shape[-1]
    idx = np.linspace(0, T - 1, min(max_frames, T)).astype(int)
    cols = len(idx) + 1
    fig, axes = plt.subplots(1, cols, figsize=(3 * cols, 3))
    for a, t in zip(axes[:-1], idx):
        a.imshow(snapshots[:, :, t], cmap="gray")
        a.set_title(f"epoch snap {t}")
        a.axis("off")
    axes[-1].imshow(mean_image, cmap="gray")
    axes[-1].set_title("mean image")
    axes[-1].axis("off")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def epoch_gif(snapshots: np.ndarray, out_path: str, fps: int = 4):
    """Animated GIF of the snapshots (observe_epochs.m's movie)."""
    plt = _pyplot()
    from matplotlib import animation

    fig, ax = plt.subplots()
    im = ax.imshow(snapshots[:, :, 0], cmap="gray")
    ax.axis("off")

    def update(t):
        im.set_data(snapshots[:, :, t])
        ax.set_title(f"snapshot {t}")
        return [im]

    anim = animation.FuncAnimation(fig, update, frames=snapshots.shape[-1])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path
