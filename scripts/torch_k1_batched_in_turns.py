"""Time the port's batched K1s against the ones of a parent checkout on one
card, in turns.

Run from the root of the changed checkout on a machine with one H100:

    python3 scripts/torch_k1_batched_in_turns.py --parent <parent checkout> \
        [--kernels k1 k1w]

``k1``: the tensor-core class at the hybrid fit's shape (four stacked 256
-> 512x4 -> 1 SIRENs on 100,800 rows); the parent's ``csrc/siren_tc.cu``
(whose ``siren_loss_grads_tc_batched`` takes the same arguments as
``csrc/siren_wg.cu``'s ``siren_loss_grads_wg``) is driven through the same
launch code; then the batched kernel at one slot on the flagship's 70,000
rows against the unbatched tensor-core K1. ``k1w``: the batched K1-w at
the 2-D ensemble's shape (three stacked 2 -> 64x7 -> 1 Sirens on 3,600
rows with sample weights, as a stacked Adam holds them) against the
parent's ``csrc/siren_resident.cu`` ``siren_loss_grads_resident_batched``
(the earlier weight-resident batched kernel, two launches a call), driven
by a copy of its launch code kept here; CUDA events, the host clock (calls issued back to back, one
synchronisation at the end) and, under ``torch.profiler``, the device time
a call. The parent's sources are built with this checkout's nvcc flags
into ``build/``. Each timing is over warmed calls, in the order parent,
change, change, parent; then each kernel by pass under ``torch.profiler``.
Prints the card's name and power limit.
"""
import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mri_super_resolution_tpu_torch import set_float32_precision  # noqa: E402
from mri_super_resolution_tpu_torch.ops import _build  # noqa: E402
from mri_super_resolution_tpu_torch.ops import siren_kernel as sk  # noqa: E402


class _ParentEntry:
    """The parent's batched entry under the names the launch code calls."""

    def __init__(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.siren_tc_batched_workspace_bytes.argtypes = [i, p, i, i]
        lib.siren_tc_batched_workspace_bytes.restype = ctypes.c_longlong
        lib.siren_loss_grads_tc_batched.argtypes = [p, i, i, p, i, i, p, p, p, p, p, p, f, p, p,
                                                    p, ctypes.c_longlong, p, p]
        lib.siren_loss_grads_tc_batched.restype = i
        self.siren_wg_workspace_bytes = lib.siren_tc_batched_workspace_bytes
        self.siren_loss_grads_wg = lib.siren_loss_grads_tc_batched


def parent_libraries(parent: str, names) -> dict:
    """The parent's ``csrc/<name>.cu`` for each name, built together."""
    procs, outs = [], {}
    for name in names:
        src = os.path.join(parent, "mri_super_resolution_tpu_torch", "csrc", f"{name}.cu")
        digest = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
        out = _build.build_dir() / f"lib{name}_parent-{digest}.so"
        outs[name] = out
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            procs.append(subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                                           src], stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the parent's source: {err.decode()[-2000:]}")
    return {name: ctypes.CDLL(str(out)) for name, out in outs.items()}


class _ParentResident:
    """The parent's batched K1-w (``siren_loss_grads_resident_batched``,
    the earlier weight-resident kernel) and its wrapper's launch code: a
    workspace of its blocks' slots, then the kernel and a second launch
    that sums them."""

    def __init__(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.siren_resident_batched_work_floats.argtypes = [i, p, i, i]
        lib.siren_resident_batched_work_floats.restype = ctypes.c_longlong
        lib.siren_loss_grads_resident_batched.argtypes = [p, i, i, p, i, i, p, p, p, p, p, p, f,
                                                          p, p, p]
        lib.siren_loss_grads_resident_batched.restype = i
        self.lib = lib

    def __call__(self, x, ws, target, sw, acts, omega=30.0):
        dims, D = sk._batched_dims(x, ws)
        n = len(dims) - 1
        c_dims = (ctypes.c_int * len(dims))(*dims)
        cast = lambda a: ctypes.cast(a, ctypes.c_void_p)
        P = int(x.shape[0])
        work_n = self.lib.siren_resident_batched_work_floats(P, cast(c_dims), n, D)
        c_codes = (ctypes.c_int * n)(*[sk.ACT_CODES[a] for a in acts])
        c_om = (ctypes.c_float * (n - 1))(*([omega] * (n - 1)))
        work = torch.empty(int(work_n), dtype=x.dtype, device=x.device)
        n_params = sk._n_params(dims)
        out = torch.empty(D, n_params + 2, dtype=x.dtype, device=x.device)
        rc = self.lib.siren_loss_grads_resident_batched(
            x.data_ptr(), P, P, cast(c_dims), n, D, cast(c_codes), _build.ptr_array(ws),
            cast(sk._slot_strides(ws)), cast(c_om), target.data_ptr(),
            None if sw is None else sw.data_ptr(), 1.0 / P, work.data_ptr(), out.data_ptr(),
            _build.stream_ptr())
        _build.raise_on(rc, "siren_loss_grads_resident_batched")
        return out[:, n_params], sk._stacked_views(out, dims)


def in_turns(label: str, parent_fn, change_fn, reps: int) -> None:
    times = {"parent": [], "change": []}
    for role in ("parent", "change", "change", "parent"):
        times[role].append(cs._time_ms(parent_fn if role == "parent" else change_fn, reps))
    p, c = times["parent"], times["change"]
    print(f"[turns] {label}: parent {p[0]:.3f}, {p[1]:.3f} ms; change {c[0]:.3f}, "
          f"{c[1]:.3f} ms (CUDA events, {reps} calls each, parent/change/change/parent); "
          f"change / parent {min(c) / min(p):.3f}", flush=True)


def host_in_turns(label: str, parent_fn, change_fn, calls: int) -> None:
    """Host clock over calls issued back to back, one synchronisation at the end."""
    times = {"parent": [], "change": []}
    for role in ("parent", "change", "change", "parent"):
        fn = parent_fn if role == "parent" else change_fn
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times[role].append(1e3 * (time.perf_counter() - t0) / calls)
    p, c = times["parent"], times["change"]
    print(f"[turns] {label}, host clock: parent {p[0]:.4f}, {p[1]:.4f} ms; change {c[0]:.4f}, "
          f"{c[1]:.4f} ms ({calls} calls each, parent/change/change/parent); change / parent "
          f"{min(c) / min(p):.3f}", flush=True)


def k1w(parent: _ParentResident) -> None:
    from mri_super_resolution_tpu_torch.fit.optim import StackedAdam

    models, x, targets, sws = zip(*(cs._master_inputs(seed=81 + d)
                                    for d in range(cs.MASTER_DIRS)))
    x, acts = x[0], models[0].acts
    ws = StackedAdam([torch.stack(t) for t in zip(*(m.weights() for m in models))], 3e-4).params
    target, sw = torch.stack(targets), torch.stack(sws)
    old = lambda: parent(x, ws, target, sw, acts)
    new = lambda: sk.siren_loss_grads_batched(x, ws, target, acts=acts, sample_weights=sw)
    ref = sk.siren_loss_grads_batched_ref(x, ws, target, 30.0, None, acts, sw)
    for role, fn in (("parent", old), ("change", new)):
        loss, grads = fn()
        err = max(cs._rel(a, b)[1] for a, b in zip((loss, *grads), (ref[0], *ref[1])))
        print(f"[parity] batched K1-w, {role}, against the plain version: worst rel {err:.3e}",
              flush=True)
    label = f"batched K1-w, D={cs.MASTER_DIRS}, P={cs.MASTER_P}"
    in_turns(label, old, new, reps=200)
    host_in_turns(label, old, new, calls=300)
    cs._passes("parent's batched K1-w (csrc/siren_resident.cu)", old, calls=20)
    cs._passes("batched K1-w (csrc/siren_resident_tc.cu)", new, calls=20)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the parent checkout")
    ap.add_argument("--kernels", nargs="+", default=["k1", "k1w"], choices=["k1", "k1w"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    set_float32_precision()
    print(f"[card] {cs._card()}", flush=True)
    names = {"k1": "siren_tc", "k1w": "siren_resident"}
    libs = parent_libraries(os.path.abspath(args.parent), [names[k] for k in args.kernels])
    _build.build(("siren_wg", "siren_tc", "siren_resident", "siren_resident_tc"))
    if "k1w" in args.kernels:
        k1w(_ParentResident(libs["siren_resident"]))
    if "k1" in args.kernels:
        k1(_ParentEntry(libs["siren_tc"]))
    print(f"[card] {cs._card()}", flush=True)
    return 0


def k1(parent: _ParentEntry) -> None:
    dims = (256, 512, 512, 512, 512, 1)
    P, D = cs.HYBRID_P, cs.HYBRID_TES
    x, ws, target = cs._stacked_inputs(P, dims, D, seed=62)
    stream = _build.stream_ptr()
    old = lambda: sk._launch_loss_grads_wg(parent, x, ws, target, 30.0, P, stream)
    new = lambda: sk.siren_loss_grads_batched(x, ws, target)
    ref = sk.siren_loss_grads_batched_ref(x, ws, target, stash="bf16")
    for role, fn in (("parent", old), ("change", new)):
        loss, grads = fn()
        err = max(cs._rel(a, b)[1] for a, b in zip((loss, *grads), (ref[0], *ref[1])))
        print(f"[parity] {role} against the plain version with the bf16 stash: worst rel "
              f"{err:.3e}", flush=True)
    in_turns(f"batched K1, D={D}, P={P}", old, new, reps=5)
    cs._passes("parent's batched K1 (csrc/siren_tc.cu)", old, calls=2)
    cs._passes("batched K1 (csrc/siren_wg.cu)", new, calls=2)
    del x, ws, target, ref
    torch.cuda.empty_cache()

    P1 = 70_000
    x, ws, target = cs._stacked_inputs(P1, dims, 1, seed=63)
    one = [w[0].contiguous() for w in ws]
    unbatched = lambda: sk.siren_loss_grads(x, one, target[0])
    in_turns(f"one slot at P={P1}: the unbatched tensor-core K1 (parent column) against "
             "csrc/siren_wg.cu at D=1 (change column)", unbatched,
             lambda: sk.siren_loss_grads_batched(x, ws, target), reps=10)


if __name__ == "__main__":
    sys.exit(main())
