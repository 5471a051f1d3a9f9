"""PyTorch/CUDA port of ``mri_super_resolution_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(``config``, ``core``, ``data``, ``models``, ``fit``, ``ops``, ``pipelines``,
``cli``) and imports nothing from it, nor JAX. Importing it builds and loads
no kernel: ``ops/_build.py`` compiles ``csrc/*.cu`` at first launch.

Entry points take ``device="cuda"`` by default and raise when no card is
present; ``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and absent
    (nothing falls back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_float32_precision() -> None:
    """Pin true float32 products on the card (no TF32), as the JAX reference
    pins precision='highest' for the Fourier projection."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
