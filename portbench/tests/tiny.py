"""Tiny sizes of each cell for the CPU tests: the same files, drivers and
references, at widths and grids a test run holds (on the CPU the program
runs its kernels' plain PyTorch versions)."""
SR3D = {"patient_shape": [16, 16, 4], "acquisitions": [1, 2, 2, 1], "roi_start": 4,
        "roi_end": 12, "mapping_size": 8, "hidden_dim": 32, "num_layers": 1, "pn_dim": 8}
OVERRIDES = {
    "sr3d_ref.fit": {"config": SR3D,
                     "traffic": {"unit": {"num_epochs": 5, "pn_epochs": 0},
                                 "reset_epochs": 12}},
    "sr3d_ref.pn": {"config": SR3D,
                    "traffic": {"unit": {"num_epochs": 2, "pn_epochs": 2, "phase2_start": 2490}}},
    "sr3d_ref.infer": {"config": SR3D,
                       "traffic": {"grids": [[8, 8, 4, 4], [4, 4, 4, 4], [8, 8, 8, 1]]}},
    "ens2d_ref.fit": {"config": {"roi_begin": 0, "roi_end": 8, "acquisitions": [3, 3, 3],
                                 "hidden_features": 16, "hidden_layers": 2, "total_steps": 4,
                                 "seg": 2, "scale": 2},
                      "traffic": {"chunks_per_fit": 2}},
}


def bench() -> dict:
    """``BENCHMARK.json`` with the 2-D ensemble's entries
    (``ens2d_entries.json``) added where it lacks them: the cell is proven
    correct and its files are here, but its host-bound runs spread too
    widely for any bound the benchmark allows (PERF.md)."""
    import json
    from pathlib import Path

    here = Path(__file__).resolve().parent
    out = json.loads((here.parents[1] / "BENCHMARK.json").read_text())
    for group, entries in json.loads((here / "ens2d_entries.json").read_text()).items():
        names = {e["name"] for e in out[group]}
        out[group] += [e for e in entries if e["name"] not in names]
    return out
