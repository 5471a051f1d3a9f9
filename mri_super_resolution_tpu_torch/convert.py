"""Parameters of the JAX package -> the port's modules.

The JAX package keeps flax param trees; handed over as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), they become ``state_dict``s of
the port's :class:`~mri_super_resolution_tpu_torch.models.Siren` and
:class:`~mri_super_resolution_tpu_torch.models.PerturbNet`. flax
``Dense.kernel`` is (in, out); torch ``Linear.weight`` is (out, in). The
SIREN trunk order is ``SineLayer_0..n`` then ``Dense_0``
(``ops/pallas/siren_kernel.py:606-625`` of the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch


def _numbered(p: dict, prefix: str) -> list[str]:
    return sorted((k for k in p if k.startswith(prefix)),
                  key=lambda k: int(k.split("_")[1]))


def _tensor(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32))


def siren_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``Siren`` params -> ``Siren.state_dict()`` keys."""
    p = params["params"]
    sd = {}
    sine = _numbered(p, "SineLayer_")
    for i, k in enumerate(sine):
        d = p[k]["Dense_0"]
        sd[f"net.{i}.linear.weight"] = _tensor(d["kernel"]).T.contiguous()
        sd[f"net.{i}.linear.bias"] = _tensor(d["bias"])
    d = p["Dense_0"]
    sd[f"net.{len(sine)}.weight"] = _tensor(d["kernel"]).T.contiguous()
    sd[f"net.{len(sine)}.bias"] = _tensor(d["bias"])
    return sd


def perturbnet_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``PerturbNet`` params -> ``PerturbNet.state_dict()`` keys."""
    p = params["params"]
    return {
        "fc0.weight": _tensor(p["Dense_0"]["kernel"]).T.contiguous(),
        "fc0.bias": _tensor(p["Dense_0"]["bias"]),
        "fc1.weight": _tensor(p["Dense_1"]["kernel"]).T.contiguous(),
        "fc1.bias": _tensor(p["Dense_1"]["bias"]),
    }


def siren_weights(params: dict) -> list[torch.Tensor]:
    """flax ``Siren`` params -> the kernels' flat list ``[W0, b0, ...]``."""
    sd = siren_state_dict(params)
    return list(sd.values())
