"""Voxels a second the 2-D ensemble's fit updates: every batched update
completed in the window, counted as rows x the directions it updates, over
the window's seconds (host clock, fenced by ``torch.cuda.synchronize``).
The ensemble's own metric, beside ``fit_voxels_per_s``: its pace is the
host's, whose runs spread far wider than the device-bound fits'."""


def read(run):
    w = run["window"]
    return w["voxels"] / w["window_s"] if w.get("voxels") else None
