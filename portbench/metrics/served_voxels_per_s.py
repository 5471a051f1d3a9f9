"""Voxels a second served: every voxel the window's requests returned,
over the window's seconds (host clock; each request ends with its result
on the host)."""


def read(run):
    w = run["window"]
    return w["voxels"] / w["window_s"] if w.get("latencies_ms") else None
