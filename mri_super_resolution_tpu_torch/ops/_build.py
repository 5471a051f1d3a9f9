"""Build and load the hand-written CUDA kernels of ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/lib<name>-<hash>.so`` (the hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source rebuilds), then
loaded with ``ctypes``. Nothing is built or loaded when a module is
imported; the first wrapper that launches a kernel on a CUDA tensor calls
:func:`library`.

The build directory is ``build/`` at the repository root, or
``$MRI_SR_TORCH_BUILD_DIR`` when set.

Also here: what every wrapper does around a launch (:func:`check_tensors`,
:func:`ptr_array`, :func:`stream_ptr`, :func:`raise_on`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the shared GEMM (csrc/common.cuh) puts 128-row tiles on gridDim.y (at most 65535)
MAX_ROWS = 65535 * 128

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# per source: seconds nvcc took in this process (0.0 when the .so was cached)
# and the compiler's resource report (-Xptxas -v: registers, spills)
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOG: dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("MRI_SR_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[2] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from csrc/ "
                       "at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names: tuple[str, ...]) -> None:
    """Compile every source in ``names`` that is not built yet, one ``nvcc``
    process per source, all started together."""
    pending = []
    for name in names:
        out = _target(name)
        if out.exists():
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        pending.append((name, out, tmp, proc, time.perf_counter()))
    for name, out, tmp, proc, t0 in pending:
        stdout, stderr = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = stdout + stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{stdout}{stderr}")
        os.replace(tmp, out)


def library(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if needed; ``declare`` sets
    the argtypes/restype of its functions once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            declare(lib)
            _LIBS[name] = lib
        return lib


def check_tensors(kind: str, x: torch.Tensor, tensors: Sequence[torch.Tensor],
                  dtypes: Sequence[torch.dtype]) -> str:
    """Validate what the ``kind`` kernels take: every tensor of one of
    ``dtypes``, all on ``x``'s device, contiguous, at most :data:`MAX_ROWS`
    rows; returns the device type (``"cpu"`` selects the plain version)."""
    dev = x.device
    for t in (x, *tensors):
        if t.dtype not in dtypes:
            raise TypeError(f"{kind} kernels take {' or '.join(map(str, dtypes))}; "
                            f"got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}; got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kind} kernels take contiguous tensors")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"{x.shape[0]} rows exceed the kernel grid's {MAX_ROWS}")
    return dev.type


def ptr_array(tensors) -> ctypes.c_void_p:
    """A C array of the tensors' device pointers (NULL for None), as one
    pointer argument; the result keeps the array alive."""
    arr = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    return ctypes.cast(arr, ctypes.c_void_p)


def stream_ptr() -> int:
    """PyTorch's current CUDA stream, where every launch goes."""
    return torch.cuda.current_stream().cuda_stream


def raise_on(rc: int, what: str) -> None:
    """Raise for a non-zero cudaError returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
