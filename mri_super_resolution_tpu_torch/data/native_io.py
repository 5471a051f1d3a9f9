"""ctypes bindings for the C++ IO runtime ``native/mri_io.cpp``.

Counterpart of ``mri_super_resolution_tpu/data/native_io.py``: a reader of
MATLAB v5 files (numeric, cell, struct and char arrays, zlib-compressed
elements) and a background prefetch pool, in place of the reference's
blocking per-call scipy loads (nn_mri.py:46-54).

The library is compiled with ``g++`` at first use from the repository's
``native/mri_io.cpp`` into the port's build directory (``ops/_build.py``'s
``build/``, or ``$MRI_SR_TORCH_BUILD_DIR``), under a name hashed from the
source and the flags, never into ``native/``. It is compiled to a temporary
name and moved into place, so two processes may build at once. When the
toolchain or zlib is missing, :func:`available` is False and
``data/io.py:load_mat(prefer_native=True)`` reads with scipy, as the JAX
package's host IO does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from mri_super_resolution_tpu_torch.ops._build import build_dir

SRC = Path(__file__).resolve().parents[2] / "native" / "mri_io.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lz", "-lpthread")

_lock = threading.Lock()
_lib = None
_load_failed = False


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS + LINK_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"libmri_io-{digest}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), *LINK_FLAGS],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _bind(lib) -> None:
    lib.mri_load.argtypes = [ctypes.c_char_p]
    lib.mri_load.restype = ctypes.c_int64
    lib.mri_prefetch.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.mri_prefetch.restype = ctypes.c_int64
    lib.mri_ready.argtypes = [ctypes.c_int64]
    lib.mri_ready.restype = ctypes.c_int
    lib.mri_num_arrays.argtypes = [ctypes.c_int64]
    lib.mri_num_arrays.restype = ctypes.c_int
    lib.mri_array_name.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.mri_array_name.restype = ctypes.c_int
    lib.mri_array_ndim.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.mri_array_ndim.restype = ctypes.c_int
    lib.mri_array_dims.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
    lib.mri_array_dims.restype = ctypes.c_int
    lib.mri_array_data.argtypes = [ctypes.c_int64, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.mri_array_data.restype = ctypes.c_int64
    lib.mri_release.argtypes = [ctypes.c_int64]
    lib.mri_release.restype = None
    lib.mri_notes.argtypes = [ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    lib.mri_notes.restype = ctypes.c_int


def get_lib():
    """The loaded library, building it first if needed; ``None`` when it
    cannot be built or loaded."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        out = _target()
        if not out.exists() and not _build(out):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            _load_failed = True
            return None
        _bind(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _extract(lib, handle) -> dict[str, np.ndarray]:
    out = {}
    for i in range(lib.mri_num_arrays(handle)):
        buf = ctypes.create_string_buffer(256)
        lib.mri_array_name(handle, i, buf, 256)
        ndim = lib.mri_array_ndim(handle, i)
        dims = (ctypes.c_int64 * ndim)()
        lib.mri_array_dims(handle, i, dims)
        shape = tuple(int(d) for d in dims)
        count = int(np.prod(shape))
        data = np.empty(count, dtype=np.float64)
        got = lib.mri_array_data(handle, i, data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                                 count)
        if got != count:
            continue
        out[buf.value.decode()] = data.reshape(shape, order="F")  # MATLAB is column-major
    return out


def _assemble_cell(arrays: dict, marker: str) -> None:
    """``name#cell`` carries the cell dims and ``name#<i>`` the cells in
    column-major order: an object ndarray indexable ``[b][te]`` as scipy's
    v5 load gives (superresHybrid.py:50-55)."""
    name = marker[:-len("#cell")]
    dims = tuple(int(d) for d in arrays.pop(marker).reshape(-1))
    cell = np.empty(dims, dtype=object)
    for i in range(cell.size):
        cell[np.unravel_index(i, dims, order="F")] = arrays.pop(f"{name}#{i}", None)
    arrays[name] = cell


def _assemble_struct(arrays: dict, marker: str) -> None:
    """``name#struct`` carries the struct dims and ``name.<field>#<e>`` each
    element's field values, elements column-major: a structured ndarray of
    object fields, as scipy's default struct load gives
    (``rec['field'][0, 0]``)."""
    name = marker[:-len("#struct")]
    dims = tuple(int(d) for d in arrays.pop(marker).reshape(-1))
    prefix = name + "."
    fields: list[str] = []
    for k in list(arrays):
        if k.startswith(prefix) and "#" in k[len(prefix):]:
            f = k[len(prefix):].rsplit("#", 1)[0]
            if "#" not in f and "." not in f and f not in fields:
                fields.append(f)
    if not fields:
        arrays[name] = np.empty(dims, dtype=object)
        return
    rec = np.empty(dims, dtype=[(f, object) for f in fields])
    for e in range(int(np.prod(dims))):
        idx = np.unravel_index(e, dims, order="F")
        for f in fields:
            rec[f][idx] = arrays.pop(f"{prefix}{f}#{e}", None)
    arrays[name] = rec


def _reassemble(arrays: dict) -> dict:
    """Rebuild MATLAB containers from the reader's flat encoding: char
    arrays (``name#char`` code points; a row vector becomes a ``str``), then
    cell and struct markers, deepest first, so an inner container is
    assembled into its entry before the outer marker takes it."""
    for k in [k for k in arrays if k.endswith("#char")]:
        codes = arrays.pop(k)
        if codes.ndim == 2 and codes.shape[0] <= 1:
            arrays[k[:-len("#char")]] = "".join(chr(int(c)) for c in codes.reshape(-1))
        else:
            arrays[k[:-len("#char")]] = codes
    markers = sorted((k for k in arrays if k.endswith(("#cell", "#struct"))),
                     key=lambda k: k.count("#"), reverse=True)
    for marker in markers:
        (_assemble_cell if marker.endswith("#cell") else _assemble_struct)(arrays, marker)
    return arrays


def _notes(lib, handle) -> str:
    buf = ctypes.create_string_buffer(4096)
    lib.mri_notes(handle, buf, 4096)
    return buf.value.decode(errors="replace")


def load_mat_native(path: str, key: str | None = None):
    """Read a v5 file with the C++ reader; raises RuntimeError when the
    library is unavailable or cannot parse the file, naming the reader's
    skip note for a variable it did not decode."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native IO unavailable")
    handle = lib.mri_load(os.fsencode(path))
    if handle == 0:
        raise RuntimeError(f"native loader failed for {path}")
    try:
        arrays = _reassemble(_extract(lib, handle))
        notes = _notes(lib, handle)
    finally:
        lib.mri_release(handle)
    if key is None:
        return arrays
    if key not in arrays:
        hint = f" (native reader notes: {notes})" if notes else ""
        raise RuntimeError(f"{path}: variable {key!r} not decoded{hint}")
    return arrays[key]


class Prefetcher:
    """Background decoding of whole files on the library's thread pool::

        pf = Prefetcher(num_threads=4)
        handles = [pf.submit(p) for p in paths]
        arrays = pf.get(handles[0])  # blocks until that file is decoded
    """

    def __init__(self, num_threads: int = 4):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native IO unavailable")
        self.num_threads = num_threads

    def submit(self, path: str) -> int:
        return int(self.lib.mri_prefetch(os.fsencode(path), self.num_threads))

    def ready(self, handle: int) -> bool:
        return self.lib.mri_ready(handle) == 1

    def get(self, handle: int, timeout: float = 60.0) -> dict[str, np.ndarray]:
        t0 = time.monotonic()
        try:
            while True:
                state = self.lib.mri_ready(handle)
                if state == 1:
                    break
                if state < 0:
                    raise RuntimeError(f"prefetch failed (state {state})")
                if time.monotonic() - t0 > timeout:
                    raise TimeoutError("prefetch timed out")
                time.sleep(0.002)
            return _reassemble(_extract(self.lib, handle))
        finally:
            # released on every exit: a timed-out handle would pin its volume
            self.lib.mri_release(handle)
