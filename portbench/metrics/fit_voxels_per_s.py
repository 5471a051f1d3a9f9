"""Voxels a second the fits update: every optimizer update completed in the
window, counted as rows x models it updates, over the window's seconds
(host clock, fenced by ``torch.cuda.synchronize``)."""


def read(run):
    w = run["window"]
    return w["voxels"] / w["window_s"] if w.get("voxels") else None
