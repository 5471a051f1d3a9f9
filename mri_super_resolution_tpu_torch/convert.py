"""Parameters of the JAX package -> the port's modules.

The JAX package keeps flax param trees; handed over as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), they become ``state_dict``s of
the port's :class:`~mri_super_resolution_tpu_torch.models.Siren`,
:class:`~mri_super_resolution_tpu_torch.models.Wire` and
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


def wire_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``Wire`` params -> ``Wire.state_dict()`` keys (the final layer's
    unused ``bias_i`` included). Layer order ``ComplexGaborLayer_0..n`` then
    ``final``, as ``wire_weights_from_flax`` of the JAX package reads it."""
    p = params["params"]
    sd = {}
    for i, k in enumerate(_numbered(p, "ComplexGaborLayer_")):
        g = p[k]
        sd[f"layers.{i}.omega_0"] = _tensor(g["omega_0"])
        sd[f"layers.{i}.sigma_0"] = _tensor(g["sigma_0"])
        if i == 0:
            for name, d in (("linear", g["Dense_0"]), ("scale_orth", g["Dense_1"])):
                sd[f"layers.0.{name}.weight"] = _tensor(d["kernel"]).T.contiguous()
                sd[f"layers.0.{name}.bias"] = _tensor(d["bias"])
        else:
            for name in ("linear", "scale_orth"):
                _complex_dense(sd, f"layers.{i}.{name}", g[name])
    _complex_dense(sd, "final", p["final"])
    return sd


def _complex_dense(sd: dict, prefix: str, d: dict) -> None:
    sd[f"{prefix}.weight_r"] = _tensor(d["kernel_r"]).T.contiguous()
    sd[f"{prefix}.weight_i"] = _tensor(d["kernel_i"]).T.contiguous()
    sd[f"{prefix}.bias_r"] = _tensor(d["bias_r"])
    sd[f"{prefix}.bias_i"] = _tensor(d["bias_i"])


def wire_weights(params: dict) -> tuple[list[torch.Tensor], torch.Tensor]:
    """flax ``Wire`` params -> the WIRE kernels' flat weight list (torch
    layout) and the ``(n_layers, 2)`` omega/sigma tensor, the counterparts
    of ``wire_weights_from_flax``'s two results."""
    sd = wire_state_dict(params)
    n_layers = len(_numbered(params["params"], "ComplexGaborLayer_"))
    flat = [sd[f"layers.0.{n}.{t}"] for n in ("linear", "scale_orth")
            for t in ("weight", "bias")]
    for i in range(1, n_layers):
        flat += [sd[f"layers.{i}.{n}.{t}"] for n in ("linear", "scale_orth")
                 for t in ("weight_r", "weight_i", "bias_r", "bias_i")]
    flat += [sd["final.weight_r"], sd["final.weight_i"], sd["final.bias_r"]]
    oms = torch.stack([torch.cat([sd[f"layers.{i}.omega_0"], sd[f"layers.{i}.sigma_0"]])
                       for i in range(n_layers)])
    return flat, oms
