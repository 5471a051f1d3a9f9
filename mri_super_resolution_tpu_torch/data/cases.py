"""Patient case registry and .mat loading.

Copy of ``mri_super_resolution_tpu/data/cases.py`` (numpy only): ``Case``
(one patient: 4-D DWI ``(H, W, S, A)``, mean b0 ``(H, W, S)``, ERD ADC map,
annotated pixels, cancer slice, per-direction acquisition counts),
``CASE_TABLE``, ``available_patients`` and ``load_cases``. The data
directory holds ``pat*_mean_b0.mat`` and ``pat*_ERD.mat``; a missing
``pat*_alldata.mat`` is synthesised from the mean b0 with the patient number
as seed (``synthetic.acquisitions_from_b0``), so the same files give the same
arrays as the JAX package. The data directory defaults to
``$MRI_SR_DATA_DIR``, else ``anon_data``, read at each call. ``load_cases``
submits every case's files to the C++ prefetch pool
(``data/native_io.py``) when the library is available, and each variable
the pool did not decode is read with ``load_mat(prefer_native=True)``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from mri_super_resolution_tpu_torch.data import synthetic
from mri_super_resolution_tpu_torch.data.io import load_mat


def default_data_dir() -> str:
    return os.environ.get("MRI_SR_DATA_DIR", "anon_data")


@dataclasses.dataclass
class Case:
    """One patient: volumes + annotation, as host numpy arrays."""

    pt_id: str
    b: float | tuple
    cancer_loc: tuple[int, int]
    contralateral_loc: tuple[int, int]
    noise: tuple[int, int]
    cancer_slice: int
    acquisitions: tuple[int, ...]  # acquisition counts per gradient direction
    dwi: np.ndarray  # (H, W, S, A)
    b0: np.ndarray  # (H, W, S)
    erd: np.ndarray  # (H, W, S)
    accept: np.ndarray  # (H, W, S, A) int mask
    synthetic_dwi: bool = False

    @property
    def pt_no(self) -> str:
        return self.pt_id.split("-")[-1]

    @classmethod
    def load(
        cls,
        pt_id: str,
        b: float,
        cancer_loc: tuple[int, int],
        contralateral_loc: tuple[int, int],
        noise: tuple[int, int],
        cancer_slice: int,
        acquisitions: Sequence[int],
        data_dir: str | None = None,
        require_real: bool = False,
        preloaded: dict | None = None,
    ) -> "Case":
        """``preloaded``: ``{path: {variable: array}}`` decoded by the
        prefetch pool (:func:`load_cases`); a variable missing there is read
        with ``load_mat(prefer_native=True)``."""
        data_dir = data_dir or default_data_dir()

        def var(path, name):
            if preloaded is not None and name in preloaded.get(path, {}):
                return preloaded[path][name]
            return load_mat(path, name, prefer_native=True)

        pt_no = pt_id.split("-")[-1]
        b0 = np.asarray(var(os.path.join(data_dir, f"pat{pt_no}_mean_b0.mat"),
                            "data_mean_b0"), dtype=np.float32)
        erd = np.asarray(var(os.path.join(data_dir, f"pat{pt_no}_ERD.mat"),
                             "ADC_alldata_mm_ERD"), dtype=np.float32)
        alldata_path = os.path.join(data_dir, f"pat{pt_no}_alldata.mat")
        synthetic_dwi = False
        if os.path.exists(alldata_path):
            dwi = np.asarray(var(alldata_path, "data"), dtype=np.float32)
        else:
            if require_real:
                raise FileNotFoundError(alldata_path)
            dwi = synthetic.acquisitions_from_b0(
                b0, num_acq=int(sum(acquisitions)), b=float(b), seed=int(pt_no))
            synthetic_dwi = True
        return cls(
            pt_id=pt_id,
            b=b,
            cancer_loc=tuple(cancer_loc),
            contralateral_loc=tuple(contralateral_loc),
            noise=tuple(noise),
            cancer_slice=int(cancer_slice),
            acquisitions=tuple(int(a) for a in acquisitions),
            dwi=dwi,
            b0=b0,
            erd=erd,
            accept=np.ones(dwi.shape, dtype=np.int32),
            synthetic_dwi=synthetic_dwi,
        )


# Case annotation table (the JAX package's data/cases.py:130-141, from the
# soft-ERD study's registry, INR_ERD.py:310-322).
CASE_TABLE = (
    dict(pt_id="18-1681-07", b=900.0, cancer_loc=(67, 73), contralateral_loc=(63, 57), noise=(80, 65), cancer_slice=11, acquisitions=(9, 9, 9)),
    dict(pt_id="18-1681-08", b=900.0, cancer_loc=(80, 74), contralateral_loc=(77, 54), noise=(97, 65), cancer_slice=10, acquisitions=(9, 9, 9)),
    dict(pt_id="18-1681-09", b=900.0, cancer_loc=(62, 64), contralateral_loc=(56, 70), noise=(76, 62), cancer_slice=15, acquisitions=(9, 9, 9)),
    dict(pt_id="18-1681-30", b=900.0, cancer_loc=(67, 54), contralateral_loc=(66, 78), noise=(84, 64), cancer_slice=17, acquisitions=(9, 9, 9)),
    dict(pt_id="18-1681-37", b=900.0, cancer_loc=(68, 76), contralateral_loc=(71, 59), noise=(80, 67), cancer_slice=10, acquisitions=(9, 9, 9)),
    dict(pt_id="17-1694-82", b=1500.0, cancer_loc=(56, 52), contralateral_loc=(56, 74), noise=(80, 60), cancer_slice=16, acquisitions=(9, 9, 9)),
    dict(pt_id="18-1681-41", b=1500.0, cancer_loc=(69, 57), contralateral_loc=(69, 69), noise=(86, 65), cancer_slice=8, acquisitions=(9, 9, 9)),
    dict(pt_id="18-1694-76", b=1500.0, cancer_loc=(73, 69), contralateral_loc=(73, 52), noise=(90, 64), cancer_slice=16, acquisitions=(9, 9, 9)),
    dict(pt_id="18-1681-45", b=1500.0, cancer_loc=(71, 68), contralateral_loc=(65, 74), noise=(87, 62), cancer_slice=13, acquisitions=(9, 9, 9)),
    dict(pt_id="18-1694-78", b=1500.0, cancer_loc=(62, 76), contralateral_loc=(63, 53), noise=(78, 60), cancer_slice=20, acquisitions=(9, 9, 9)),
)


def available_patients(data_dir: str | None = None) -> list[dict]:
    """Rows of CASE_TABLE whose mean_b0 file exists under ``data_dir``."""
    data_dir = data_dir or default_data_dir()
    return [row for row in CASE_TABLE
            if os.path.exists(os.path.join(
                data_dir, f"pat{row['pt_id'].split('-')[-1]}_mean_b0.mat"))]


def _prefetch(paths: list[str]) -> dict | None:
    """Every file of ``paths`` decoded on the C++ pool, or ``None`` without
    the library; a file the pool fails on is left out (read with scipy)."""
    from mri_super_resolution_tpu_torch.data import native_io

    if not native_io.available():
        return None
    pf = native_io.Prefetcher()
    handles = [(p, pf.submit(p)) for p in paths]
    out = {}
    for p, h in handles:
        try:
            out[p] = pf.get(h)
        except (RuntimeError, TimeoutError):
            pass
    return out


def load_cases(data_dir: str | None = None, limit: int | None = None) -> list[Case]:
    """Load every available case, at most ``limit``; every case's files
    are submitted to the prefetch pool up front, so decoding overlaps the
    assembly of earlier cases."""
    data_dir = data_dir or default_data_dir()
    rows = available_patients(data_dir)
    if limit is not None:
        rows = rows[:limit]
    paths = [os.path.join(data_dir, f"pat{row['pt_id'].split('-')[-1]}_{stem}.mat")
             for row in rows for stem in ("mean_b0", "ERD", "alldata")]
    preloaded = _prefetch([p for p in paths if os.path.exists(p)])
    return [Case.load(data_dir=data_dir, preloaded=preloaded, **row) for row in rows]
