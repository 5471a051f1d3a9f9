"""Parameters of the JAX package -> the port's modules.

The JAX package keeps flax param trees; handed over as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), they become ``state_dict``s of
the port's :class:`~mri_super_resolution_tpu_torch.models.Siren`,
:class:`~mri_super_resolution_tpu_torch.models.SirenERD`,
:class:`~mri_super_resolution_tpu_torch.models.SirenToy`,
:class:`~mri_super_resolution_tpu_torch.models.Wire`,
:class:`~mri_super_resolution_tpu_torch.models.PerturbNet`,
:class:`~mri_super_resolution_tpu_torch.models.GridINR` (and ``GridINR2D``)
and :class:`~mri_super_resolution_tpu_torch.models.PIA`. flax
``Dense.kernel`` is (in, out); torch ``Linear.weight`` is (out, in). The
SIREN trunk order is ``SineLayer_0..n`` then ``Dense_0``
(``ops/pallas/siren_kernel.py:606-625`` of the JAX package).

RAMS params cross as a numpy ``.npz`` (:func:`save_params_npz`,
:func:`load_params_npz`): one array per leaf under its flat path
(``params/RFAB_0/WNConv_0/v``), read back as the same nested dict, which
:func:`rams_state_dict` maps to the port's :class:`RAMS`. The committed
checkpoint at the reference architecture is :data:`RAMS_PARAMS_NPZ`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

# the RAMS serving checkpoint (filters 32, N 12, T 9, scale 3), converted
# from the JAX package's orbax checkpoint artifacts/rams_dwi_params
RAMS_PARAMS_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "artifacts", "rams_dwi_params.npz")


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


def siren_stack_weights(params_stack: dict) -> list[list[torch.Tensor]]:
    """A flax ``Siren`` params tree whose leaves carry a leading axis of D
    models (the 2-D ensemble's vmapped direction stack) -> D kernel weight
    lists, one per direction."""
    def pick(tree, d):
        return {k: pick(v, d) if isinstance(v, dict) else np.asarray(v)[d]
                for k, v in tree.items()}

    leaf = params_stack
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [siren_weights(pick(params_stack, d)) for d in range(np.asarray(leaf).shape[0])]


def siren_batched_weights(params_stack: dict) -> list[torch.Tensor]:
    """A flax ``Siren`` params tree whose leaves carry a leading axis of D
    models (``jax.vmap(model.init)`` of the 2-D ensemble's directions, or
    the hybrid fit's ``tree_map(stack)`` of its four TEs) -> the batched
    kernels' stacked list ``[W0, b0, ...]``, each W (D, out, in) and b (D,
    out) (``ops/siren_kernel.siren_loss_grads_batched``)."""
    return [torch.stack(ws) for ws in zip(*siren_stack_weights(params_stack))]


def siren_erd_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``SirenERD`` params -> ``SirenERD.state_dict()`` keys: the
    ``perturb`` branch (when present), ``SineLayer_0..n``, then ``Dense_0``
    (the ReLU head) and ``Dense_1`` (the ReLU output)."""
    p = params["params"]
    sd = {}
    if "perturb" in p:
        for i in range(2):
            d = p["perturb"][f"Dense_{i}"]
            sd[f"perturb.fc{i}.weight"] = _tensor(d["kernel"]).T.contiguous()
            sd[f"perturb.fc{i}.bias"] = _tensor(d["bias"])
    for i, k in enumerate(_numbered(p, "SineLayer_")):
        d = p[k]["Dense_0"]
        sd[f"sines.{i}.linear.weight"] = _tensor(d["kernel"]).T.contiguous()
        sd[f"sines.{i}.linear.bias"] = _tensor(d["bias"])
    for name, k in (("head", "Dense_0"), ("final", "Dense_1")):
        sd[f"{name}.weight"] = _tensor(p[k]["kernel"]).T.contiguous()
        sd[f"{name}.bias"] = _tensor(p[k]["bias"])
    return sd


def siren_toy_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``SirenToy`` params -> ``SirenToy.state_dict()`` keys: the
    ``Siren`` trunk and, when present, the ``perturb`` branch."""
    sd = siren_state_dict(params)
    if "perturb" in params["params"]:
        for i in range(2):
            d = params["params"]["perturb"][f"Dense_{i}"]
            sd[f"perturb.fc{i}.weight"] = _tensor(d["kernel"]).T.contiguous()
            sd[f"perturb.fc{i}.bias"] = _tensor(d["bias"])
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


def _dense(sd: dict, prefix: str, d: dict) -> None:
    sd[f"{prefix}.weight"] = _tensor(d["kernel"]).T.contiguous()
    sd[f"{prefix}.bias"] = _tensor(d["bias"])


def grid_inr_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax ``GridINR`` or ``GridINR2D`` params -> the port module's
    ``state_dict()`` keys: ``grid_{l}`` as they are, ``b_embedding`` (3-D
    only), and the head's ``Dense_0..2``."""
    p = params["params"]
    sd = {f"grids.{i}": _tensor(p[k]) for i, k in enumerate(_numbered(p, "grid_"))}
    if "b_embedding" in p:
        sd["b_embedding"] = _tensor(p["b_embedding"])
    for i in range(3):
        _dense(sd, f"head.{i}", p[f"Dense_{i}"])
    return sd


def pia_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax ``PIA`` params -> ``PIA.state_dict()`` keys: the encoder's
    ``enc_{i}`` and each head's ``{D,T2,v}_h{i}`` and ``{D,T2,v}_out``."""
    p = params["params"]
    sd = {}
    for i, k in enumerate(_numbered(p, "enc_")):
        _dense(sd, f"enc.{i}", p[k])
    for name in ("D", "T2", "v"):
        hidden = sorted((k for k in p if k.startswith(f"{name}_h")),
                        key=lambda k: int(k[len(name) + 2:]))
        for i, k in enumerate(hidden):
            _dense(sd, f"heads.{name}.{i}", p[k])
        _dense(sd, f"heads.{name}.{len(hidden)}", p[f"{name}_out"])
    return sd


def save_params_npz(tree: dict, path: str) -> None:
    """Write a nested dict of arrays as one ``.npz`` entry per leaf, keyed by
    its ``/``-joined path."""
    flat = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def load_params_npz(path: str) -> dict:
    """The nested dict of numpy arrays that :func:`save_params_npz` wrote."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def _wn(sd: dict, prefix: str, d: dict) -> None:
    for name in ("v", "g", "bias"):
        sd[f"{prefix}.{name}"] = _tensor(d[name])


def _attention_block(sd: dict, prefix: str, d: dict) -> None:
    """RFAB / RTAB: ``WNConv_0..3`` are conv0, conv1, att0, att1."""
    for i, name in enumerate(("conv0", "conv1", "att0", "att1")):
        _wn(sd, f"{prefix}.{name}", d[f"WNConv_{i}"])


def rams_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """flax ``RAMS`` params -> ``RAMS.state_dict()`` keys. flax numbers the
    blocks in call order: ``WNConv_0`` (head), ``RFAB_0..N-1``, ``WNConv_1``
    (body conv), then per temporal step ``RFAB_{N+i}`` and ``WNConv_{2+i}``,
    ``WNConv_{2+k}`` (to scale^2), ``RTAB_0``, ``WNConv_{3+k}`` (global
    conv), with k = T // 3 steps."""
    p = params["params"]
    k = len(_numbered(p, "WNConv_")) - 4
    n = len(_numbered(p, "RFAB_")) - k
    sd: dict[str, torch.Tensor] = {}
    _wn(sd, "head", p["WNConv_0"])
    for i in range(n):
        _attention_block(sd, f"rfabs.{i}", p[f"RFAB_{i}"])
    _wn(sd, "body_conv", p["WNConv_1"])
    for i in range(k):
        _attention_block(sd, f"reduce_rfabs.{i}", p[f"RFAB_{n + i}"])
        _wn(sd, f"reduce_convs.{i}", p[f"WNConv_{2 + i}"])
    _wn(sd, "to_scale", p[f"WNConv_{2 + k}"])
    _attention_block(sd, "rtab", p["RTAB_0"])
    _wn(sd, "global_conv", p[f"WNConv_{3 + k}"])
    return sd
