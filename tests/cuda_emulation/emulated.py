"""Build one CUDA source of the port (``csrc/<name>.cu``) with g++ against the
CPU emulation of the CUDA execution model in ``cuda_runtime.h`` beside this
file, and load it with ctypes, so that the ``tests/test_torch_cuda_emulated_*``
files can run the kernels through the same ctypes launch code the wrappers
use on the card."""
import ctypes
import os
import platform
import shutil
import subprocess

import pytest

from mri_super_resolution_tpu_torch.ops import _build

HERE = os.path.dirname(os.path.abspath(__file__))


def emulated_library(tmp_path_factory, name: str, declare) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with g++ against the emulation header, its
    entry points declared by ``declare``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to build the CPU emulation")
    if platform.machine() not in ("x86_64", "AMD64"):
        pytest.skip("the emulation switches its fibers with x86-64 assembly")
    d = tmp_path_factory.mktemp(f"{name}_emu")
    src = d / "emu.cpp"
    src.write_text(f'#include "{os.path.join(HERE, "cuda_runtime.h")}"\n'
                   f'#include "{_build.CSRC / f"{name}.cu"}"\n')
    out = d / f"lib{name}_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w", "-I", HERE,
                    "-o", str(out), str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    declare(lib)
    return lib
