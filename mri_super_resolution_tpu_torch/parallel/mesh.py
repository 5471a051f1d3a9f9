"""Rank meshes over ``torch.distributed`` and the shard specs the fits read.

Counterpart of ``mri_super_resolution_tpu/parallel/mesh.py``. A JAX mesh
names the devices of one program; here every rank is a process that holds
one position of the mesh, its own slice of each sharded array, and a process
group for each axis through which the collectives of that axis run:

- axis ``data`` shards the voxel (coordinate) batch: the ranks of one data
  row average their loss and gradient over their row's group;
- axis ``case`` maps independent per-patient fits onto ranks (cohort
  parallelism; BASELINE.json config 5): nothing is reduced across it.

Ranks are laid out row-major over the axes (rank = case_index * data +
data_index for a ``(case, data)`` mesh), so the fastest axis, ``data``,
holds consecutive ranks. With one process every axis has size 1 and no
process group is needed.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


class Spec(tuple):
    """How an array is laid out over a mesh: entry i names the mesh axis
    that shards dimension i, or ``None``; ``Spec()`` is replicated (the
    port's ``PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of a mesh of ranks: the axis names and sizes, its
    coordinates, and one process group an axis (``None`` where the axis has
    size 1 or the mesh has one rank)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    ranks: tuple[int, ...]  # the global ranks of the mesh, row-major
    rank: int  # this process's global rank
    groups: dict  # axis name -> process group of this rank's line along it

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        coords = np.unravel_index(self.ranks.index(self.rank), self.sizes)
        return int(coords[self.axis_names.index(axis)])

    def group(self, axis: str):
        return self.groups.get(axis)


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def build_mesh(axis_names: Sequence[str], sizes: Sequence[int],
               ranks: Sequence[int] | None = None) -> Mesh:
    """A mesh of ``sizes`` over ``ranks`` (default: every rank). A mesh of
    more than one rank makes one process group per line of each axis of size
    > 1 with ``dist.new_group``, which every rank of the default group must
    enter, in the same order; a one-rank mesh makes none and may be built
    by that rank alone."""
    rank, world = _world()
    ranks = tuple(range(world)) if ranks is None else tuple(int(r) for r in ranks)
    sizes = tuple(int(s) for s in sizes)
    if int(np.prod(sizes)) != len(ranks):
        raise ValueError(f"mesh {sizes} needs {int(np.prod(sizes))} ranks; got {len(ranks)}")
    groups = {}
    if len(ranks) > 1:
        grid = np.asarray(ranks).reshape(sizes)
        for a, name in enumerate(axis_names):
            if sizes[a] == 1:
                continue
            lines = np.moveaxis(grid, a, -1).reshape(-1, sizes[a])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
    return Mesh(tuple(axis_names), sizes, ranks, rank, groups)


def mesh_2d(names: tuple[str, str], lead: int, rest: int | None,
            ranks: Sequence[int] | None = None) -> Mesh:
    """A 2-D mesh over the first ``lead * rest`` of ``ranks`` (default:
    every rank of the default group); ``rest=None`` puts every remaining
    rank on the second axis. The JAX package's checks hold."""
    pool = list(range(_world()[1])) if ranks is None else list(ranks)
    n = len(pool)
    if rest is None:
        if n % lead:
            raise ValueError(f"{n} devices not divisible by {names[0]}={lead}")
        rest = n // lead
    if lead * rest > n:
        raise ValueError(f"mesh {lead}x{rest} exceeds {n} devices")
    return build_mesh(names, (lead, rest), pool[:lead * rest])


def make_mesh(case: int = 1, data: int | None = None,
              ranks: Sequence[int] | None = None) -> Mesh:
    """A (case, data) mesh; ``data=None`` puts every remaining rank on the
    data axis."""
    return mesh_2d(("case", "data"), case, data, ranks)


def data_sharding(mesh: Mesh) -> Spec:
    """Shard the leading (batch, voxel) axis over ``data``."""
    return Spec("data")


def case_data_sharding(mesh: Mesh) -> Spec:
    """Shard axis 0 by case and axis 1 by data (stacked per-patient batches)."""
    return Spec("case", "data")


def replicated(mesh: Mesh) -> Spec:
    return Spec()


def local_slice(n: int, mesh: Mesh, axis: str) -> slice:
    """This rank's contiguous slice of a length-``n`` dimension sharded over
    ``axis``; ``n`` must divide evenly, as a JAX sharding requires."""
    k = mesh.axis_size(axis)
    if n % k:
        raise ValueError(f"dimension of {n} does not divide mesh axis {axis!r} ({k}); "
                         "pad it with pad_to_multiple")
    per = n // k
    i = mesh.index(axis)
    return slice(i * per, (i + 1) * per)


def shard_batch(x, mesh: Mesh, spec: Spec | None = None):
    """This rank's shard of ``x`` under ``spec`` (default
    :func:`data_sharding`): for each sharded dimension, its contiguous
    slice."""
    spec = data_sharding(mesh) if spec is None else spec
    index = tuple(slice(None) if ax is None else local_slice(x.shape[d], mesh, ax)
                  for d, ax in enumerate(spec))
    return x[index]


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Zero-pad ``axis`` up to a multiple of ``multiple`` (sharded axes must
    divide evenly); returns ``(padded, original_length)``. Takes tensors and
    numpy arrays."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_shape = list(x.shape)
    pad_shape[axis] = rem
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros(pad_shape)], dim=axis), n
    return np.concatenate([x, np.zeros(pad_shape, x.dtype)], axis=axis), n


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """The sums over ``axis``'s group of ``tensors`` (one flat buffer, one
    ``all_reduce``; the inputs are not modified). Without a group (an axis
    of size 1) the tensors come back as they are. ``all_reduce`` is one of
    the collectives gloo runs on CUDA tensors, so a buffer on the card stays
    there."""
    group = mesh.group(axis)
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_reduce_max(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The elementwise max over ``axis``'s group of ``t`` (a new tensor; one
    ``all_reduce``). Without a group, ``t`` as it is."""
    group = mesh.group(axis)
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _first_rank(mesh: Mesh, axis: str) -> int:
    """The global rank at index 0 of this rank's line along ``axis``."""
    coords = list(np.unravel_index(mesh.ranks.index(mesh.rank), mesh.sizes))
    coords[mesh.axis_names.index(axis)] = 0
    return mesh.ranks[int(np.ravel_multi_index(coords, mesh.sizes))]


def broadcast_from_first(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> None:
    """Overwrite ``tensors`` in place with the first rank's of this rank's
    line along ``axis`` (one flat float32 buffer, one ``broadcast``; gloo
    broadcasts CUDA tensors too). Without a group, nothing happens."""
    group = mesh.group(axis)
    if group is None:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.broadcast(flat, src=_first_rank(mesh, axis), group=group)
    at = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].reshape(t.shape))
            at += t.numel()


def axis_counts(counts: Sequence[int], mesh: Mesh, axis: str,
                device: str | torch.device = "cpu") -> np.ndarray:
    """Every rank's ``counts`` along ``axis``'s group, (axis size,
    len(counts)) in axis order: one ``all_reduce`` of a float32 buffer on
    ``device`` (exact below 2^24). Without a group, this rank's alone."""
    group = mesh.group(axis)
    if group is None:
        return np.asarray([counts], dtype=np.int64)
    buf = torch.zeros(mesh.axis_size(axis), len(counts), dtype=torch.float32, device=device)
    buf[mesh.index(axis)] = torch.tensor([float(c) for c in counts], device=device)
    dist.all_reduce(buf, group=group)
    return buf.cpu().numpy().astype(np.int64)


def all_gather_cat(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``'s group, concatenated along ``dim``
    in axis order (equal shapes). Staged through the CPU, since gloo gathers
    only CPU tensors; the result is on ``t``'s device."""
    group = mesh.group(axis)
    if group is None:
        return t
    host = t.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts, dim=dim).to(t.device)
