"""Multi-process execution: ``torch.distributed`` wiring, host-local data
slices and sharded checkpoints.

Counterpart of ``mri_super_resolution_tpu/parallel/distributed.py``. One
process is one rank of the meshes of ``parallel/mesh.py``. Launch one
command a process::

    MRI_SR_COORDINATOR=host0:9871 MRI_SR_NUM_PROCESSES=2 MRI_SR_PROCESS_ID=0 \\
        python -m mri_super_resolution_tpu_torch.cli.cohort_run --distributed ...

or under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``), or call :func:`init_distributed` with explicit arguments.

The backend: ``nccl`` when every rank has a card of its own (a CUDA device
and at most as many ranks on the host as cards), ``gloo`` otherwise: on the
CPU, and for ranks that share one card, which NCCL refuses ("Duplicate GPU
detected"). The choice is printed, never switched silently. Gloo runs
``all_reduce`` and ``broadcast`` on CUDA tensors; the port stages every
other collective through the CPU (``parallel/mesh.py:all_gather_cat``).

Checkpoints go through ``torch.distributed.checkpoint`` (not orbax: the two
packages' checkpoint formats differ by design): a tree of tensors, where a
``DTensor`` leaf is written and read shard by shard and a plain tensor is a
replicated value written once.
"""
from __future__ import annotations

import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from mri_super_resolution_tpu_torch.parallel.mesh import Mesh, Spec, all_reduce_sum, make_mesh

ENV_COORD = "MRI_SR_COORDINATOR"
ENV_NPROC = "MRI_SR_NUM_PROCESSES"
ENV_PID = "MRI_SR_PROCESS_ID"


def choose_backend(device: str | torch.device, ranks_on_host: int) -> str:
    """``nccl`` when ``device`` is CUDA and every rank on the host has a card
    of its own, else ``gloo``."""
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and ranks_on_host <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     auto: bool = False,
                     device: str | torch.device = "cuda",
                     ranks_on_host: int | None = None) -> bool:
    """Start the default process group (idempotent); returns whether the run
    is multi-process.

    Arguments fall back to the ``MRI_SR_*`` variables. With ``auto`` and
    neither set, torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
    ``MASTER_PORT`` are read; when those are missing too, a note is printed
    and the run stays single-process (pass ``auto`` when the user asked
    for multi-process, e.g. ``--distributed``). ``ranks_on_host`` (default:
    ``LOCAL_WORLD_SIZE``, else every process) picks the backend
    (:func:`choose_backend`); under ``nccl`` each rank takes card
    ``rank % device_count``."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(ENV_COORD)
    if num_processes is None and os.environ.get(ENV_NPROC):
        num_processes = int(os.environ[ENV_NPROC])
    if process_id is None and os.environ.get(ENV_PID):
        process_id = int(os.environ[ENV_PID])
    if coordinator_address is None and num_processes is None:
        if not auto:
            return False
        env = os.environ
        if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
            print("init_distributed: no MRI_SR_* or torchrun variables; "
                  "running single-process")
            return False
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator address, the number "
                         "of processes and this process's id")
    if ranks_on_host is None:
        ranks_on_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    backend = choose_backend(device, ranks_on_host)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    print(f"init_distributed: rank {process_id} of {num_processes}, backend {backend}")
    return num_processes > 1


def shutdown() -> None:
    """Destroy the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(process id, process count)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(case: int = 1, data: int | None = None) -> Mesh:
    """A (case, data) mesh over every rank: ``data``, the axis reduced
    every step, holds consecutive ranks (the same host under a launcher
    that numbers a host's ranks together); ``case`` reduces nothing."""
    return make_mesh(case=case, data=data)


def host_local_slice(n: int) -> slice:
    """The [start, stop) slice of a length-``n`` leading axis that this
    process loads (contiguous, ceil(n / processes) each)."""
    pid, pcount = process_info()
    per = -(-n // pcount)
    return slice(pid * per, min(n, (pid + 1) * per))


class GlobalBatch(NamedTuple):
    local: torch.Tensor  # this rank's rows
    global_shape: tuple[int, ...]  # the shape every rank agreed on


def make_global_batch(local, mesh: Mesh, spec: Spec = Spec("data"),
                      global_rows: int | None = None,
                      device: str | torch.device = "cpu") -> GlobalBatch:
    """This rank's slice of a batch sharded over ``spec``'s leading axis,
    with the global shape every rank agrees on: the ranks' row counts are
    summed (one ``all_reduce`` over the axis), so ragged host-local slices
    (7 cases on 2 processes: 4 + 3) give one shape. ``global_rows``, when
    given, must equal that sum. One process: the whole batch."""
    local = torch.as_tensor(np.asarray(local), device=device)
    axis = spec[0] if len(spec) else None
    if axis is None or mesh.group(axis) is None:
        rows = int(local.shape[0])
    else:
        count = torch.tensor([float(local.shape[0])], device=device)
        rows = int(all_reduce_sum([count], mesh, axis)[0].item())
    if global_rows is not None and int(global_rows) != rows:
        raise ValueError(f"global_rows {global_rows} but the ranks hold {rows} rows")
    return GlobalBatch(local, (rows,) + tuple(local.shape[1:]))


# ---------------------------------------------------------------------------
# sharded checkpoints
# ---------------------------------------------------------------------------


def device_mesh(mesh: Mesh, device_type: str):
    """A ``torch.distributed`` ``DeviceMesh`` with ``mesh``'s axes (every
    rank of the mesh must call it), for the ``DTensor`` leaves of a
    checkpoint tree."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.tensor(mesh.ranks).reshape(mesh.sizes),
                      mesh_dim_names=mesh.axis_names)


def shard_leaf(local: torch.Tensor, dmesh, spec: Spec):
    """A ``DTensor`` over ``dmesh`` whose shard on this rank is ``local``:
    dimension d of the global tensor is sharded over the axis ``spec[d]``
    names (``Shard(d)``), every other axis replicates it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Replicate()] * dmesh.ndim
    for d, ax in enumerate(spec):
        if ax is not None:
            placements[dmesh.mesh_dim_names.index(ax)] = Shard(d)
    return DTensor.from_local(local, dmesh, placements, run_check=False)


def save_sharded(path: str, tree: dict[str, Any]) -> None:
    """Write ``tree`` (a flat or nested dict of tensors, ``DTensor``s and
    numbers) with ``torch.distributed.checkpoint``. Every rank calls it; each
    writes its own shards, and a replicated value is written once."""
    import torch.distributed.checkpoint as dcp

    dcp.save(tree, checkpoint_id=os.path.abspath(path))


def restore_sharded(path: str, template: dict[str, Any]) -> dict[str, Any]:
    """Read a checkpoint into a copy of ``template`` (same keys; each leaf a
    tensor or ``DTensor`` of the shape and sharding wanted): every rank
    reads only the bytes of its own shards."""
    import torch.distributed.checkpoint as dcp

    def fresh(x):
        if isinstance(x, dict):
            return {k: fresh(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        return x

    out = fresh(template)
    dcp.load(out, checkpoint_id=os.path.abspath(path))
    return out



# ---------------------------------------------------------------------------
# local multi-process runs
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank: int, n: int, port: int, device: str, args: tuple, queue) -> None:
    import traceback

    try:
        # the host's cores shared among its ranks (more intra-op threads
        # than cores stalls every rank)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        init_distributed(f"localhost:{port}", n, rank, device=device, ranks_on_host=n)
        result = fn(*args)
        shutdown()
    except BaseException:  # reported to the parent, which fails the run
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
    queue.put((rank, result))


def spawn_ranks(fn, n: int, *args, device: str = "cpu", timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``n`` fresh processes (``spawn``), each rank of
    one process group on localhost (backend by :func:`choose_backend`: ranks
    sharing one card take gloo), and return their results in rank order.
    ``fn`` is a module-level function returning something picklable. Raises
    when a rank raises, exits non-zero or is not done within ``timeout``
    seconds; every process is ended before it returns."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, n, port, device, args, q))
             for r in range(n)]
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    failures = []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n:
            try:
                rank, res = q.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue_mod.Empty:
                failures.append(f"ranks {sorted(set(range(n)) - set(results))} gave no "
                                f"result within {timeout:.0f} s")
                break
            results[rank] = res
            if isinstance(res, dict) and "error" in res:
                failures.append(f"rank {rank} raised:\n{res['error']}")
                break
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0) if not failures else 5.0)
            if p.is_alive():
                p.kill()
                p.join()
    failures += [f"rank {r} exited with code {p.exitcode}" for r, p in enumerate(procs)
                 if p.exitcode != 0 and not any(f.startswith(f"rank {r} ") for f in failures)]
    if failures:
        raise RuntimeError("spawn_ranks failed: " + "; ".join(failures))
    return [results[r] for r in range(n)]
