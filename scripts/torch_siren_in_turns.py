"""Time the port's SIREN K1, K2 and K3 of the tensor-core class against the
ones of a parent checkout on one card, in turns.

Run from the root of the changed checkout on a machine with one H100:

    python3 scripts/torch_siren_in_turns.py --parent <parent checkout> \
        [--what k1 k3 k2 batched] [--reps 20]

The parent's ``csrc/siren_tc.cu`` (the unbatched K1, K2 and K3 on
``mma.sync`` passes) and ``csrc/siren_wg.cu`` (the batched K1) are built
with this checkout's nvcc flags into ``build/`` and driven through copies of
their launch code kept here; this checkout's kernels run through its
wrappers. First each kernel, both sides, is held against its plain version
on the card (float32, TF32 off: the worst relative error of any output),
and two calls for the same bits; then timed with CUDA events over warmed
calls in the order parent, change, change, parent, at the 3-D pipeline's
shapes: K1 on 70,000 rows (the fit) and 35,000 (a data-parallel shard), K3
on an inference chunk of 262,144 rows and on 70,000 and 35,000, K2 without
dW (the PerturbNet step) on 70,000 and 35,000 and with dW on 70,000; the
batched K1 at the hybrid's D = 4 on 100,800 rows. Then each kernel's passes
under ``torch.profiler``, both sides. Prints the card's name and power
limit.
"""
import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mri_super_resolution_tpu_torch import set_float32_precision  # noqa: E402
from mri_super_resolution_tpu_torch.ops import _build  # noqa: E402
from mri_super_resolution_tpu_torch.ops import siren_kernel as sk  # noqa: E402

FLAGSHIP = (256, 512, 512, 512, 512, 1)


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


class _ParentTc:
    """The parent's ``csrc/siren_tc.cu`` entries and a copy of their launch
    code (one workspace and fresh grads a call, as its wrapper had)."""

    def __init__(self, lib):
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.siren_tc_workspace_bytes.argtypes = [i, p, i]
        lib.siren_tc_workspace_bytes.restype = ll
        lib.siren_loss_grads_tc.argtypes = [p, i, i, p, i, p, p, p, p, f, p, p, p, p, p]
        lib.siren_forward_tc_workspace_bytes.argtypes = [i, p, i]
        lib.siren_forward_tc_workspace_bytes.restype = ll
        lib.siren_forward_tc.argtypes = [p, i, p, i, p, p, p, p, p, p]
        lib.siren_fused_bwd_tc_workspace_bytes.argtypes = [i, p, i, i]
        lib.siren_fused_bwd_tc_workspace_bytes.restype = ll
        lib.siren_fused_bwd_tc.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, p]
        self.lib = lib

    def _work(self, nbytes, like):
        return torch.empty(int(nbytes), dtype=torch.uint8, device=like.device)

    def k1(self, x, ws, target):
        a = sk._Args(x, ws, 30.0, None)
        work = self._work(self.lib.siren_tc_workspace_bytes(a.P, a.ptr(a.dims), a.n_layers), x)
        grads = [torch.empty_like(w) for w in ws]
        loss = torch.empty((), dtype=x.dtype, device=x.device)
        rc = self.lib.siren_loss_grads_tc(
            x.data_ptr(), a.P, a.P, a.ptr(a.dims), a.n_layers, a.W, a.b, a.ptr(a.omegas),
            target.data_ptr(), 1.0 / a.P, work.data_ptr(), _build.ptr_array(grads[0::2]),
            _build.ptr_array(grads[1::2]), loss.data_ptr(), _build.stream_ptr())
        _build.raise_on(rc, "parent siren_loss_grads_tc")
        return loss, grads

    def k3(self, x, ws):
        a = sk._Args(x, ws, 30.0, None)
        work = self._work(
            self.lib.siren_forward_tc_workspace_bytes(a.P, a.ptr(a.dims), a.n_layers), x)
        out = torch.empty(a.P, 1, dtype=x.dtype, device=x.device)
        rc = self.lib.siren_forward_tc(x.data_ptr(), a.P, a.ptr(a.dims), a.n_layers, a.W, a.b,
                                       a.ptr(a.omegas), work.data_ptr(), out.data_ptr(),
                                       _build.stream_ptr())
        _build.raise_on(rc, "parent siren_forward_tc")
        return out

    def k2(self, x, ws, g, need_dw):
        a = sk._Args(x, ws, 30.0, None)
        work = self._work(self.lib.siren_fused_bwd_tc_workspace_bytes(
            a.P, a.ptr(a.dims), a.n_layers, int(need_dw)), x)
        grads = [torch.empty_like(w) for w in ws] if need_dw else None
        dx = torch.empty_like(x)
        rc = self.lib.siren_fused_bwd_tc(
            x.data_ptr(), a.P, a.ptr(a.dims), a.n_layers, a.W, a.b, a.ptr(a.omegas),
            g.data_ptr(), work.data_ptr(), _build.ptr_array(grads[0::2]) if need_dw else None,
            _build.ptr_array(grads[1::2]) if need_dw else None, dx.data_ptr(),
            _build.stream_ptr())
        _build.raise_on(rc, "parent siren_fused_bwd_tc")
        return dx, grads


def _flat(out) -> list:
    """A kernel's outputs as a flat list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out if o is not None for t in _flat(o)]


def parity(label: str, fn, ref) -> None:
    got, again = _flat(fn()), _flat(fn())
    ref = _flat(ref)
    errs = [cs._rel(a, b)[1] for a, b in zip(got, ref)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"[parity] {label}: worst rel {max(errs):.3e} over {len(errs)} outputs "
          f"(each: {', '.join(f'{e:.1e}' for e in errs)}); two calls bit-equal {same}",
          flush=True)


def in_turns(label: str, parent_fn, change_fn, reps: int) -> None:
    times = {"parent": [], "change": []}
    for role in ("parent", "change", "change", "parent"):
        times[role].append(cs._time_ms(parent_fn if role == "parent" else change_fn, reps))
    p, c = times["parent"], times["change"]
    print(f"[turns] {label}: parent {p[0]:.4f}, {p[1]:.4f} ms; change {c[0]:.4f}, "
          f"{c[1]:.4f} ms (CUDA events, {reps} calls each, parent/change/change/parent); "
          f"change / parent {min(c) / min(p):.3f}", flush=True)


def k1(parent: _ParentTc, reps: int) -> None:
    for P in (70_000, 35_000):
        x, ws, target, _ = cs._flagship_inputs(P, FLAGSHIP, seed=P + 1)
        old = lambda: parent.k1(x, ws, target)
        new = lambda: sk.siren_loss_grads(x, ws, target)
        if P == 70_000:
            ref = sk.siren_loss_grads_ref(x, ws, target)
            parity(f"K1 P={P}, parent", old, ref)
            parity(f"K1 P={P}, change", new, ref)
        in_turns(f"K1, P={P}", old, new, reps)
        if P == 70_000:
            cs._passes("parent's K1 (csrc/siren_tc.cu)", old, calls=5)
            cs._passes("K1 (csrc/siren_wg.cu)", new, calls=5)


def k3(parent: _ParentTc, reps: int) -> None:
    for P in (262_144, 70_000, 35_000):
        x, ws, _, _ = cs._flagship_inputs(P, FLAGSHIP, seed=P + 3)
        old = lambda: parent.k3(x, ws)
        new = lambda: sk.siren_forward(x, ws)
        if P == 262_144:
            ref = sk.siren_forward_ref(x, ws)
            parity(f"K3 P={P}, parent", old, ref)
            parity(f"K3 P={P}, change", new, ref)
        in_turns(f"K3, P={P}", old, new, reps)
        if P == 262_144:
            cs._passes("parent's K3 (csrc/siren_tc.cu)", old, calls=5)
            cs._passes("K3 (csrc/siren_wg.cu)", new, calls=5)


def k2(parent: _ParentTc, reps: int) -> None:
    for P, need_dw in ((70_000, False), (35_000, False), (70_000, True)):
        x, ws, _, g = cs._flagship_inputs(P, FLAGSHIP, seed=P + 5)
        old = lambda: parent.k2(x, ws, g, need_dw)
        new = lambda: sk.siren_fused_bwd(x, ws, g, need_dw=need_dw)
        what = f"K2 {'with' if need_dw else 'without'} dW, P={P}"
        if P == 70_000:
            ref = sk.siren_fused_bwd_ref(x, ws, g, need_dw=need_dw)
            parity(f"{what}, parent", old, ref)
            parity(f"{what}, change", new, ref)
        in_turns(what, old, new, reps)
        if P == 70_000 and not need_dw:
            cs._passes("parent's K2 without dW (csrc/siren_tc.cu)", old, calls=5)
            cs._passes("K2 without dW (csrc/siren_wg.cu)", new, calls=5)


def batched(parent_wg, reps: int) -> None:
    P, D = cs.HYBRID_P, cs.HYBRID_TES
    x, ws, target = cs._stacked_inputs(P, FLAGSHIP, D, seed=62)
    stream = _build.stream_ptr()
    old = lambda: sk._launch_loss_grads_wg(parent_wg, x, ws, target, 30.0, P, stream)
    new = lambda: sk.siren_loss_grads_batched(x, ws, target)
    ref = sk.siren_loss_grads_batched_ref(x, ws, target, stash="bf16")
    parity(f"batched K1 D={D} P={P}, parent, against the bf16-stash plain version", old, ref)
    parity(f"batched K1 D={D} P={P}, change, against the bf16-stash plain version", new, ref)
    got, want = _flat(new()), _flat(old())
    print(f"[parity] batched K1, change against parent: bit-equal "
          f"{all(torch.equal(a, b) for a, b in zip(got, want))}", flush=True)
    in_turns(f"batched K1, D={D}, P={P}", old, new, max(2, reps // 4))
    cs._passes("batched K1 (csrc/siren_wg.cu)", new, calls=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the parent checkout")
    ap.add_argument("--what", nargs="+", default=["k1", "k3", "k2", "batched"],
                    choices=["k1", "k3", "k2", "batched"])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    set_float32_precision()
    print(f"[card] {cs._card()}", flush=True)
    libs = parent_libraries(os.path.abspath(args.parent), ["siren_tc", "siren_wg"])
    _build.build(("siren_wg",))
    print(f"[build] csrc/siren_wg.cu: {_build.BUILD_SECONDS.get('siren_wg', 0.0):.1f} s; "
          + " ".join(l for l in _build.BUILD_LOG.get("siren_wg", "").splitlines()
                     if "registers" in l or "spill" in l), flush=True)
    parent_tc = _ParentTc(libs["siren_tc"])
    parent_wg = libs["siren_wg"]
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    parent_wg.siren_wg_workspace_bytes.argtypes = [i, p, i, i]
    parent_wg.siren_wg_workspace_bytes.restype = ll
    parent_wg.siren_loss_grads_wg.argtypes = [p, i, i, p, i, i, p, p, p, p, p, p, f, p, p, p, ll,
                                              p, p]
    for what in args.what:
        if what == "batched":
            batched(parent_wg, args.reps)
        else:
            globals()[what](parent_tc, args.reps)
        torch.cuda.empty_cache()
    print(f"[card] {cs._card()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
