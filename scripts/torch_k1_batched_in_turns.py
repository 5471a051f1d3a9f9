"""Time the port's batched K1 of the tensor-core class against the one of a
parent checkout on one card, in turns, at the hybrid fit's shape (four
stacked 256 -> 512x4 -> 1 SIRENs on 100,800 rows); then the batched kernel
at one slot on the flagship's 70,000 rows against the unbatched
tensor-core K1, in turns.

Run from the root of the changed checkout on a machine with one H100:

    python3 scripts/torch_k1_batched_in_turns.py --parent <parent checkout>

The parent's ``csrc/siren_tc.cu`` (whose ``siren_loss_grads_tc_batched``
takes the same arguments as ``csrc/siren_wg.cu``'s ``siren_loss_grads_wg``)
is built with this checkout's nvcc flags into ``build/`` and driven through
the same launch code. Each timing is CUDA events over warmed calls, in the
order parent, change, change, parent; then each kernel by pass under
``torch.profiler``. Prints the card's name and power limit.
"""
import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

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


def parent_library(parent: str) -> ctypes.CDLL:
    src = os.path.join(parent, "mri_super_resolution_tpu_torch", "csrc", "siren_tc.cu")
    digest = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    out = _build.build_dir() / f"libsiren_tc_parent-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src], check=True,
                       capture_output=True)
    return ctypes.CDLL(str(out))


def in_turns(label: str, parent_fn, change_fn, reps: int) -> None:
    times = {"parent": [], "change": []}
    for role in ("parent", "change", "change", "parent"):
        times[role].append(cs._time_ms(parent_fn if role == "parent" else change_fn, reps))
    p, c = times["parent"], times["change"]
    print(f"[turns] {label}: parent {p[0]:.3f}, {p[1]:.3f} ms; change {c[0]:.3f}, "
          f"{c[1]:.3f} ms (CUDA events, {reps} calls each, parent/change/change/parent); "
          f"change / parent {min(c) / min(p):.3f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the parent checkout")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    set_float32_precision()
    print(f"[card] {cs._card()}", flush=True)
    parent = _ParentEntry(parent_library(os.path.abspath(args.parent)))
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
