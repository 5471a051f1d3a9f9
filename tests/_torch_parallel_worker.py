"""The port's parallel programs on one rank of a multi-process run, for
``tests/test_torch_parallel.py``: every case runs on the spawned ranks (gloo,
CPU) from inputs the test built with numpy, and the results come back as
numpy arrays. Imports neither JAX nor the JAX package."""
import os

import numpy as np
import torch
import torch.distributed as dist

from mri_super_resolution_tpu_torch.config import RAMSConfig, TrainerConfig
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.fit.trainer import Trainer
from mri_super_resolution_tpu_torch.models import Siren
from mri_super_resolution_tpu_torch.ops.siren_kernel import (make_fused_value_and_grad,
                                                             siren_forward_ref)
from mri_super_resolution_tpu_torch.parallel import (Spec, make_cohort_fit, make_mesh,
                                                     make_sharded_fit, make_tp_fit,
                                                     make_tp_mesh, pad_to_multiple,
                                                     restore_sharded, save_sharded,
                                                     shard_batch, siren_tp_specs)
from mri_super_resolution_tpu_torch.parallel.distributed import (device_mesh,
                                                                 make_global_batch,
                                                                 shard_leaf)
from mri_super_resolution_tpu_torch.parallel.mesh import all_gather_cat
from mri_super_resolution_tpu_torch.parallel.tp_fit import shard_params
from mri_super_resolution_tpu_torch.pipelines.misr import build_rams


def apply(p, x):
    return siren_forward_ref(x, p)


def adam(lr, every=0):
    return lambda p: Adam(p, lr, restart_every=every)


def siren(hidden, layers, weights):
    m = Siren(2, hidden, layers, 1)
    m.requires_grad_(False)
    for p, w in zip(m.weights(), weights):
        p.copy_(torch.as_tensor(w))
    return m


def _np(res):
    return [t.detach().numpy() for t in res.params], res.losses.numpy()


def run_all(inp: dict) -> dict:
    torch.set_num_threads(2)
    rank, n = dist.get_rank(), dist.get_world_size()
    out = {}
    flat = make_mesh(case=1)
    one = make_mesh(1, 1, ranks=[rank])

    # voxel data parallelism, autograd and K1 (its plain version here)
    d = inp["dp"]
    m = siren(d["hidden"], d["layers"], d["weights"])
    c, t = torch.as_tensor(d["coords"]), torch.as_tensor(d["target"])
    out["dp_autograd"] = _np(make_sharded_fit(apply, adam(d["lr"]), flat, d["steps"])(
        m.weights(), shard_batch(c, flat), shard_batch(t, flat)))
    out["dp_kernel"] = _np(make_sharded_fit(
        None, adam(d["lr"]), flat, d["steps"], value_and_grad_fn=make_fused_value_and_grad(m))(
        m.weights(), shard_batch(c, flat), shard_batch(t, flat)))

    # the padded batch against one rank's unpadded fit
    d = inp["pad"]
    m = siren(d["hidden"], d["layers"], d["weights"])
    c, t = torch.as_tensor(d["coords"]), torch.as_tensor(d["target"])
    cp, n_rows = pad_to_multiple(c, n)
    tp, _ = pad_to_multiple(t, n)
    for name, kw in (("pad_autograd", {}),
                     ("pad_kernel", {"value_and_grad_fn": make_fused_value_and_grad(m)})):
        out[name] = _np(make_sharded_fit(apply, adam(d["lr"]), flat, d["steps"], n_rows=n_rows,
                                         **kw)(m.weights(), shard_batch(cp, flat),
                                               shard_batch(tp, flat)))
    out["pad_unpadded"] = _np(make_sharded_fit(apply, adam(d["lr"]), one, d["steps"])(
        m.weights(), c, t))
    # all but the last rank's rows padding: that rank adds zeros, no call
    few = n_rows // n
    cf, _ = pad_to_multiple(c[:few], n * few)
    tf, _ = pad_to_multiple(t[:few], n * few)
    out["pad_one_shard"] = _np(make_sharded_fit(
        None, adam(d["lr"]), flat, d["steps"], n_rows=few,
        value_and_grad_fn=make_fused_value_and_grad(m))(
        m.weights(), shard_batch(cf, flat), shard_batch(tf, flat)))
    out["pad_one_shard_ref"] = _np(make_sharded_fit(apply, adam(d["lr"]), one, d["steps"])(
        m.weights(), c[:few], t[:few]))

    # the cohort fit: one case a rank
    d = inp["cohort"]
    mesh = make_mesh(case=n)
    for every in (0, d["restart"]):
        res = make_cohort_fit(apply, adam(d["lr"], every), mesh, d["steps"])(
            [shard_batch(torch.as_tensor(p), mesh, Spec("case")) for p in d["stack"]],
            shard_batch(torch.as_tensor(d["coords"]), mesh, Spec("case", "data")),
            shard_batch(torch.as_tensor(d["targets"]), mesh, Spec("case", "data")))
        out[f"cohort_{every}"] = (
            [all_gather_cat(p, mesh, "case").numpy() for p in res.params],
            all_gather_cat(res.losses, mesh, "case").numpy())

    # tensor parallelism over every rank
    for layers, d in inp["tp"].items():
        m = siren(d["hidden"], layers, d["weights"])
        c, t = torch.as_tensor(d["coords"]), torch.as_tensor(d["target"])
        mesh = make_tp_mesh(data=1, model=n)
        out[f"tp_{layers}"] = _np(make_tp_fit(m, adam(d["lr"]), mesh, d["steps"],
                                              siren_tp_specs(m))(m.weights(), c, t))

    # the trainer's mesh path on a ragged batch: one step's loss, cPSNR,
    # reduced gradients and updated params
    d = inp["trainer"]
    model = build_rams(RAMSConfig(**d["rams"]))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in d["state"].items()})
    tdir = inp["trainer_dir"]
    tr = Trainer(model, TrainerConfig(batch_size=len(d["x"]), hr_size=d["hr"],
                                      checkpoint_dir=os.path.join(tdir, "ck"),
                                      log_dir=os.path.join(tdir, "logs")),
                 device="cpu", mesh=flat)
    tr.init()
    batch = tr._batch(np.arange(len(d["x"])), d["x"], d["y"], d["m"])
    loss, psnr = tr.train_step([batch])
    out["trainer"] = {"loss": float(loss), "psnr": float(psnr), "rows": len(batch[3]),
                      "grads": {k: p.grad.numpy() for k, p in model.named_parameters()},
                      "params": {k: p.detach().numpy() for k, p in model.named_parameters()},
                      "val": tr.evaluate(d["x"], d["y"], d["m"])}
    # only the first rank writes a checkpoint (the ranks share the directory)
    out["trainer"]["saved"] = tr._save(out["trainer"]["val"])
    dist.barrier()
    out["trainer"]["ckpt_files"] = sorted(os.listdir(os.path.join(tdir, "ck")))

    # the agreed global batch of ragged host-local slices, and a sharded
    # checkpoint round trip (DTensor leaves written shard by shard)
    rows = np.arange(2 * n + 1, dtype=np.float32).reshape(-1, 1)
    per = -(-len(rows) // n)
    gb = make_global_batch(rows[rank * per:(rank + 1) * per], flat)
    out["global_shape"] = gb.global_shape
    m = siren(inp["pad"]["hidden"], inp["pad"]["layers"], inp["pad"]["weights"])
    mesh = make_tp_mesh(data=1, model=n)
    specs = siren_tp_specs(m)
    dmesh = device_mesh(mesh, "cpu")
    tree = {f"w{i}": shard_leaf(s, dmesh, sp) for i, (s, sp) in
            enumerate(zip(shard_params(m.weights(), specs, mesh), specs))}
    tree["step"] = torch.tensor(7)
    path = inp["ckpt_dir"]
    save_sharded(path, tree)
    back = restore_sharded(path, {k: v * 0 for k, v in tree.items()})
    out["ckpt_equal"] = all(torch.equal(back[k].to_local(), tree[k].to_local())
                            for k in tree if k != "step") and int(back["step"]) == 7
    out["ckpt_full"] = [back[f"w{i}"].full_tensor().numpy() for i in range(len(specs))]
    return out


def run_cohort(case_kwargs: list, init: list, kwargs: dict) -> dict:
    """``pipelines/cohort.py:run_cohort`` on this rank (every rank returns
    every case)."""
    from mri_super_resolution_tpu_torch.data import Case
    from mri_super_resolution_tpu_torch.pipelines.cohort import run_cohort as run

    torch.set_num_threads(2)
    res = run([Case(**k) for k in case_kwargs],
              init_params=[[torch.as_tensor(w) for w in ws] for ws in init],
              device="cpu", **kwargs)
    return {"losses": res.losses, "recons": res.recons, "mesh_shape": res.mesh_shape}
