"""Serving: self-contained inference artifacts through ``torch.export``.

Counterpart of ``mri_super_resolution_tpu/serve.py`` (``export_fn``,
``export_inr`` :96, ``export_rams`` :139, ``export_pia`` :180,
``export_grid_inr`` :224, ``Served`` and ``load`` :336), which writes
``jax.export`` StableHLO modules. Here an artifact is a directory::

    <out>/
      program_cuda.pt2   # torch.export.save of the ExportedProgram (card)
      program_cpu.pt2    # the same function exported on the CPU
      manifest.json      # kind, platforms, input/output shapes, torch version

Each program holds the traced graph and, as its constants, the fitted
parameters (and an INR's Fourier matrix B): serving needs neither this
package's model code nor a checkpoint. The batch axis is symbolic
(``torch.export.Dim``), so one artifact serves any batch: ``n`` coordinates
of an INR, ``n`` signal vectors of PIA, ``b`` RAMS inputs at the static
(H, W) of the export, and every axis length of a GridINR's three
coordinate vectors. The manifest records them by name.

Export on a CUDA device writes a ``cuda`` and a ``cpu`` program; export on
the CPU writes ``cpu`` only. :func:`load` picks the program of the device
it is asked for and refuses a device type the artifact lacks; it never
moves a program to another device.

The programs hold the plain modules, as the JAX artifacts hold plain XLA:
the INRs' PyTorch forward (not K3 or K5), the RAMS built with
``conv_kernel=False`` (the library convolutions, in its compute type), and
no ctypes kernel. ``load`` pins true float32 products on the card
(``set_float32_precision``), as every entry point does, so that served and
live agree. An artifact is promised to load only under the torch version
that wrote it (``torch_version`` in the manifest).
"""
from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass
from typing import Sequence

import sympy
import torch
import torch.nn.functional as F
from torch import nn

from mri_super_resolution_tpu_torch import resolve_device, set_float32_precision
from mri_super_resolution_tpu_torch.core.coords import fourier_encode
from mri_super_resolution_tpu_torch.models.grid_inr import _HEAD, _b_slots, _mlp_head

_MANIFEST_FILE = "manifest.json"


def _program_file(platform: str) -> str:
    return f"program_{platform}.pt2"


def _default_platforms(device: torch.device) -> tuple[str, ...]:
    return ("cpu",) if device.type == "cpu" else (device.type, "cpu")


def _avals(program: torch.export.ExportedProgram, dim_names) -> tuple[list, list]:
    """The program's input and output shapes and dtypes, each symbolic size
    written with the name of the input dim it stands for."""
    nodes = {n.name: n for n in program.graph.nodes}
    sig = program.graph_signature
    ins = [nodes[name].meta["val"] for name in sig.user_inputs]
    rename = {}
    for val, names in zip(ins, dim_names):
        for size, name in zip(val.shape, names):
            if isinstance(size, torch.SymInt) and name is not None:
                rename[size.node.expr] = sympy.Symbol(name)

    def spec(val):
        shape = [str(s.node.expr.xreplace(rename)) if isinstance(s, torch.SymInt) else str(s)
                 for s in val.shape]
        return {"shape": shape, "dtype": str(val.dtype).removeprefix("torch.")}

    outs = [nodes[name].meta["val"] for name in sig.user_outputs]
    return [spec(v) for v in ins], [spec(v) for v in outs]


def export_fn(module: nn.Module, example_args: Sequence[torch.Tensor], dims, out_dir: str,
              *, kind: str, device: str | torch.device = "cuda",
              extra_manifest: dict | None = None) -> dict:
    """Export ``module`` at ``example_args`` once per platform of ``device``
    and write the artifact directory; returns the manifest.

    ``dims`` gives, for each argument, a name per axis: a string for a
    symbolic axis (one ``torch.export.Dim`` per name), None for a static
    one. ``module``'s parameters and buffers become the program's constants;
    it is copied to each platform, not moved."""
    dev = resolve_device(device)
    platforms = _default_platforms(dev)
    symbols = {name: torch.export.Dim(name) for names in dims for name in names if name}
    dynamic_shapes = tuple({i: symbols[name] for i, name in enumerate(names) if name}
                           for names in dims)
    os.makedirs(out_dir, exist_ok=True)
    avals = None
    for platform in platforms:
        m = copy.deepcopy(module).to(platform).eval().requires_grad_(False)
        args = tuple(a.to(platform) for a in example_args)
        program = torch.export.export(m, args, dynamic_shapes=dynamic_shapes)
        torch.export.save(program, os.path.join(out_dir, _program_file(platform)))
        avals = avals or _avals(program, dims)
    manifest = {
        "kind": kind,
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "in_avals": avals[0],
        "out_avals": avals[1],
    }
    manifest.update(extra_manifest or {})
    with open(os.path.join(out_dir, _MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class _INRProgram(nn.Module):
    """Raw coordinates -> the INR's output, the Fourier encoding inside."""

    def __init__(self, model: nn.Module, fourier_B: torch.Tensor | None):
        super().__init__()
        self.model = model
        self.register_buffer("B", fourier_B)

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        return self.model(fourier_encode(coords, self.B))


def export_inr(model: nn.Module, coord_dim: int, out_dir: str, *,
               fourier_B: torch.Tensor | None = None, out_features: int = 1,
               device: str | torch.device = "cuda", model_desc: str = "",
               extra_manifest: dict | None = None) -> dict:
    """Export a fitted coordinate INR (``model(encoded coords) -> (n,
    out)``) as ``coords (n, coord_dim) float32 -> (n, out)``, ``n``
    symbolic. ``fourier_B`` (when the fit used Fourier features) is baked in
    beside the parameters, so the artifact consumes RAW coordinates."""
    dev = resolve_device(device)
    B = None if fourier_B is None else torch.as_tensor(fourier_B, dtype=torch.float32)
    example = torch.zeros(5, coord_dim, device=dev)
    manifest = {
        "coord_dim": coord_dim,
        "out_features": out_features,
        "fourier_features": None if B is None else list(B.shape),
        "model": model_desc,
    }
    manifest.update(extra_manifest or {})
    return export_fn(_INRProgram(model, B), [example], [("n", None)], out_dir, kind="inr",
                     device=dev, extra_manifest=manifest)


def export_rams(model: nn.Module, out_dir: str, *, height: int, width: int,
                channels: int = 9, scale: int = 3, device: str | torch.device = "cuda",
                model_desc: str = "") -> dict:
    """Export a trained RAMS as ``(b, H, W, T) float32 -> (b, sH, sW, 1)``:
    H and W static (the padding and depth_to_space shapes bake in), the
    batch ``b`` symbolic, so one artifact serves the 25-draw ensemble
    (multi-image-super-resolution/master.py:45-52) or any other batch. The
    model must run the library convolutions (``conv_kernel=False``)."""
    if any(getattr(m, "use_k6", False) for m in model.modules()):
        raise ValueError("export_rams: build the RAMS with conv_kernel=False; an artifact "
                         "holds the library convolutions, not the K6 kernel")
    dev = resolve_device(device)
    example = torch.zeros(2, height, width, channels, device=dev)
    return export_fn(model, [example], [("b", None, None, None)], out_dir, kind="rams",
                     device=dev, extra_manifest={"height": height, "width": width,
                                                 "channels": channels, "scale": scale,
                                                 "model": model_desc})


class _PIAProgram(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, signals: torch.Tensor):
        return self.model.encode(signals)


def export_pia(model: nn.Module, out_dir: str, *, number_of_signals: int = 16,
               device: str | torch.device = "cuda", model_desc: str = "",
               extra_manifest: dict | None = None) -> dict:
    """Export a trained PIA encoder as ``signals (n, S) -> (D, T2, v)``, each
    (n, 3), ``n`` symbolic: the amortized tissue fitter
    (``superres_hybrid --tissue_fit pia``) as a serving artifact, its input
    scaling and the tanh/softmax priors inside."""
    dev = resolve_device(device)
    example = torch.full((5, number_of_signals), 1000.0, device=dev)
    manifest = {
        "number_of_signals": number_of_signals,
        "outputs": ["D (n,3)", "T2 (n,3)", "v (n,3)"],
        "model": model_desc,
    }
    manifest.update(extra_manifest or {})
    return export_fn(_PIAProgram(model), [example], [("n", None)], out_dir, kind="pia",
                     device=dev, extra_manifest=manifest)


def _axis_mat(c: torch.Tensor, R: int) -> torch.Tensor:
    """(n, R) linear-interpolation matrix from [-1, 1] coordinates, with the
    floor/clip convention of ``models/grid_inr._axis_weights``."""
    c01 = torch.clamp((c + 1.0) * 0.5, 0.0, 1.0)
    pos = c01 * (R - 1)
    lo = torch.clamp(torch.floor(pos).long(), 0, R - 2)
    frac = pos - lo.to(c01.dtype)
    return (F.one_hot(lo, R).to(c01.dtype) * (1.0 - frac)[:, None]
            + F.one_hot(lo + 1, R).to(c01.dtype) * frac[:, None])


class _GridProgram(nn.Module):
    """Three axis-coordinate vectors -> the (nx, ny, nz, nb, out) volume by
    the separable tensor path, the interpolation matrices built in the
    graph."""

    def __init__(self, params: Sequence[torch.Tensor], nb: int, clamp_min: float | None):
        super().__init__()
        L = len(params) - 1 - _HEAD
        self.grids = nn.ParameterList([nn.Parameter(p.detach().clone()) for p in params[:L]])
        self.head = nn.ParameterList([nn.Parameter(p.detach().clone())
                                      for p in params[L + 1:]])
        num_b = params[L].shape[0]
        # the b axis is static: its nb embedding rows are a constant
        b_pos = _b_slots(nb, num_b, params[L].device)
        self.register_buffer("b_feat", params[L].detach()[b_pos].clone())
        self.clamp_min = clamp_min

    def forward(self, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        nx, ny, nz = x.shape[0], y.shape[0], z.shape[0]
        feats = []
        for g in self.grids:  # (Rx, Ry, Rz, F)
            t = torch.einsum("xa,abcf->xbcf", _axis_mat(x, g.shape[0]), g)
            t = torch.einsum("yb,xbcf->xycf", _axis_mat(y, g.shape[1]), t)
            t = torch.einsum("zc,xycf->xyzf", _axis_mat(z, g.shape[2]), t)
            feats.append(t)
        xyz = torch.cat(feats, dim=-1)  # (nx, ny, nz, L F)
        nb, bf = self.b_feat.shape
        lf = xyz.shape[-1]
        h = torch.cat([xyz[:, :, :, None, :].expand(nx, ny, nz, nb, lf),
                       self.b_feat[None, None, None].expand(nx, ny, nz, nb, bf)],
                      dim=-1).reshape(nx * ny * nz * nb, lf + bf)
        out = _mlp_head(list(self.head), h)
        if self.clamp_min is not None:
            out = out.clamp_min(self.clamp_min)
        return out.reshape(nx, ny, nz, nb, -1)


def export_grid_inr(model: nn.Module, out_dir: str, *, nb: int | None = None,
                    clamp_min: float | None = 0.0, device: str | torch.device = "cuda",
                    model_desc: str = "", extra_manifest: dict | None = None) -> dict:
    """Export a fitted :class:`~mri_super_resolution_tpu_torch.models.GridINR`
    as ``(x (nx,), y (ny,), z (nz,)) axis coordinates in [-1, 1] -> (nx, ny,
    nz, nb, out)``, all three lengths symbolic: one artifact serves the LR,
    the HR and the 2x recon grids of the 3-D pipeline (superresDWI.py:161-162)
    at any spacing. ``nb`` defaults to the model's number of b values;
    ``clamp_min`` (None: no clamp) is the pipeline's ReLU at 0."""
    dev = resolve_device(device)
    params = model.params()
    nb = int(nb if nb is not None else params[len(params) - 1 - _HEAD].shape[0])
    examples = [torch.linspace(-1.0, 1.0, n, device=dev) for n in (5, 6, 7)]
    manifest = {
        "nb": nb,
        "clamp_min": clamp_min,
        "input": "three axis-coordinate vectors (nx,), (ny,), (nz,) in [-1, 1]; all "
                 "lengths symbolic",
        "model": model_desc,
    }
    manifest.update(extra_manifest or {})
    return export_fn(_GridProgram(params, nb, clamp_min), examples, [("nx",), ("ny",), ("nz",)],
                     out_dir, kind="grid_inr", device=dev, extra_manifest=manifest)


@dataclass
class Served:
    """A loaded artifact: calling it runs the program on ``device`` (numpy
    inputs are copied there), without gradients."""

    manifest: dict
    program: torch.export.ExportedProgram
    device: torch.device

    def __post_init__(self):
        self._module = self.program.module()

    def __call__(self, *args):
        with torch.no_grad():
            return self._module(*(torch.as_tensor(a, device=self.device) for a in args))


def load(path: str, device: str | torch.device = "cuda") -> Served:
    """Load the program of ``device``'s type from an artifact directory
    written by :func:`export_fn`; raises when the artifact has none."""
    dev = resolve_device(device)
    with open(os.path.join(path, _MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if dev.type not in manifest["platforms"]:
        raise ValueError(f"{path} holds programs for {manifest['platforms']}, not for "
                         f"{dev.type!r}; export it on that device type")
    set_float32_precision()
    program = torch.export.load(os.path.join(path, _program_file(dev.type)))
    return Served(manifest=manifest, program=program, device=dev)
