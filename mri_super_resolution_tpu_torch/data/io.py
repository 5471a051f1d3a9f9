"""File IO: MATLAB volumes in, DICOM and CSV artifacts out.

Copy of the parts of ``mri_super_resolution_tpu/data/io.py`` the pipelines
use (numpy only): ``load_mat`` (v5 through scipy, v7.3 through h5py),
``save_mat`` (:105-109), ``save_dicom`` and ``MetricsCSV`` with
``CONTRAST_HEADER``, ``SSIM_HEADER`` and ``CNR_SNR_HEADER`` (:299-301). The C++
reader route (``prefer_native``) is not ported yet.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable

import numpy as np


def _from_h5(obj, f):
    """Convert one MATLAB v7.3 HDF5 node to mat73-like Python values.

    MATLAB stores arrays column-major (we transpose back), cell arrays as
    datasets of HDF5 object references into ``/#refs#`` (resolved recursively
    into an object ndarray, so ``data['hybrid_raw'][b][te]`` works exactly as
    it does on scipy-loaded v5 files — superresDWI.py:45-55), char arrays as
    uint16 codepoints, and struct (arrays) as groups."""
    import h5py

    if isinstance(obj, h5py.Group):
        return {k: _from_h5(obj[k], f) for k in obj.keys()}
    if obj.dtype.kind == "O":  # cell array: references into #refs#
        arr = np.asarray(obj)
        out = np.empty(arr.shape[::-1], dtype=object)
        it = np.nditer(arr, flags=["multi_index", "refs_ok"])
        for ref in it:
            out[it.multi_index[::-1]] = _from_h5(f[ref.item()], f)
        return out
    data = np.asarray(obj)
    if obj.attrs.get("MATLAB_class") in (b"char", "char"):
        return "".join(map(chr, data.T.reshape(-1)))
    return data.T


def load_mat(path: str, key: str | None = None):
    """Load a MATLAB file; v5 via scipy, v7.3 (HDF5) via h5py.

    Covers every schema the reference loads (nn_mri.py:46-54,
    INR_ERD.py:89-95, superresHybrid.py:44-50): plain numeric arrays, cell
    arrays (v5 object ndarrays / v7.3 reference datasets), char arrays and
    structs. Unknown layouts raise with the offending key named."""
    import scipy.io as sio

    try:
        data = sio.loadmat(path)
        data = {k: v for k, v in data.items() if not k.startswith("__")}
    except NotImplementedError:
        import h5py

        data = {}
        with h5py.File(path, "r") as f:
            for k in f.keys():
                if k == "#refs#":
                    continue
                try:
                    data[k] = _from_h5(f[k], f)
                except Exception as e:  # precise message beats a deep trace
                    raise ValueError(
                        f"{path}: cannot decode MATLAB v7.3 entry {k!r} "
                        f"({type(e).__name__}: {e})") from e
    if key is not None:
        if key not in data:
            raise KeyError(
                f"{path}: variable {key!r} not found; file contains "
                f"{sorted(data)}"
            )
        return data[key]
    return data


def save_mat(path: str, arrays: dict) -> None:
    """Write ``arrays`` as a MATLAB v5 file with scipy."""
    import scipy.io as sio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sio.savemat(path, arrays)


# --------------------------------------------------------------------------
# Minimal DICOM writer
# --------------------------------------------------------------------------

_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
_SC_IMAGE_STORAGE = "1.2.840.10008.5.1.4.1.1.7"
_ROOT_UID = "2.25"  # UUID-derived numeric root


def _uid(seed: bytes) -> str:
    """Deterministic numeric UID from content bytes."""
    h = zlib.crc32(seed) & 0xFFFFFFFF
    h2 = zlib.adler32(seed) & 0xFFFFFFFF
    return f"{_ROOT_UID}.{h}.{h2}"


def _elem(group: int, elem: int, vr: str, value: bytes) -> bytes:
    if len(value) % 2:
        # DICOM PS3.5 6.2: text VRs pad with SPACE, UI/binary with NUL
        value += b"\x00" if vr in ("UI", "OB", "UN") else b" "
    if vr in ("OB", "OW", "SQ", "UN", "UT"):
        return struct.pack("<HH2sHI", group, elem, vr.encode(), 0, len(value)) + value
    return struct.pack("<HH2sH", group, elem, vr.encode(), len(value)) + value


def _str_elem(group: int, elem: int, vr: str, s: str) -> bytes:
    b = s.encode("ascii")
    if len(b) % 2:
        b += b"\x00" if vr == "UI" else b" "
    return _elem(group, elem, vr, b)


def save_dicom(img: np.ndarray, filename: str, series_desc: str = "mri-sr-tpu") -> None:
    """Write a 2-D image as an int16 single-frame DICOM file.

    Matches the reference contract (nn_mri.py:19-27): the array is cast to
    int16 and stored as one slice; negative values are preserved (signed
    pixel representation).
    """
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    arr = np.asarray(img).astype(np.int16)
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D image, got shape {arr.shape}")
    rows, cols = arr.shape
    pixel_bytes = arr.astype("<i2").tobytes()

    sop_uid = _uid(pixel_bytes + filename.encode())
    series_uid = _uid(os.path.dirname(filename).encode() + b"series")
    study_uid = _uid(os.path.dirname(filename).encode() + b"study")

    ds = b"".join(
        [
            _str_elem(0x0008, 0x0016, "UI", _SC_IMAGE_STORAGE),
            _str_elem(0x0008, 0x0018, "UI", sop_uid),
            _str_elem(0x0008, 0x0060, "CS", "OT"),
            _str_elem(0x0008, 0x103E, "LO", series_desc),
            _str_elem(0x0010, 0x0010, "PN", "ANON"),
            _str_elem(0x0010, 0x0020, "LO", "ANON"),
            _str_elem(0x0020, 0x000D, "UI", study_uid),
            _str_elem(0x0020, 0x000E, "UI", series_uid),
            _elem(0x0028, 0x0002, "US", struct.pack("<H", 1)),  # samples/pixel
            _str_elem(0x0028, 0x0004, "CS", "MONOCHROME2"),
            _elem(0x0028, 0x0010, "US", struct.pack("<H", rows)),
            _elem(0x0028, 0x0011, "US", struct.pack("<H", cols)),
            _elem(0x0028, 0x0100, "US", struct.pack("<H", 16)),  # bits allocated
            _elem(0x0028, 0x0101, "US", struct.pack("<H", 16)),  # bits stored
            _elem(0x0028, 0x0102, "US", struct.pack("<H", 15)),  # high bit
            _elem(0x0028, 0x0103, "US", struct.pack("<H", 1)),  # signed
            _elem(0x7FE0, 0x0010, "OW", pixel_bytes),
        ]
    )

    meta_body = b"".join(
        [
            _elem(0x0002, 0x0001, "OB", b"\x00\x01"),
            _str_elem(0x0002, 0x0002, "UI", _SC_IMAGE_STORAGE),
            _str_elem(0x0002, 0x0003, "UI", sop_uid),
            _str_elem(0x0002, 0x0010, "UI", _EXPLICIT_VR_LE),
            _str_elem(0x0002, 0x0012, "UI", f"{_ROOT_UID}.1.1"),
        ]
    )
    group_len = _elem(0x0002, 0x0000, "UL", struct.pack("<I", len(meta_body)))

    with open(filename, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM")
        f.write(group_len + meta_body)
        f.write(ds)


# --------------------------------------------------------------------------
# Metric CSV emission
# --------------------------------------------------------------------------

class MetricsCSV:
    """Append-mode CSV writer with a fixed header (the reference's per-run
    metric files)."""

    def __init__(self, path: str, header: Iterable[str]):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(",".join(header) + "\n")

    def append(self, *row) -> None:
        with open(self.path, "a") as f:
            f.write(",".join(str(x) for x in row) + "\n")


CONTRAST_HEADER = ("seed", "patient", "direction", "image", "metric", "performance")
SSIM_HEADER = ("Pt_id", "b-value", "slice", "SSIM-spline", "SSIM-SR")
CNR_SNR_HEADER = ("seed", "SNR_c", "SNR_b", "S_c", "S_b", "CR", "pt", "img", "pre_post")
