"""The port's three data-parallel fit programs on one rank of a multi-process
run, for ``tests/test_torch_sharded_fits.py``: ``fit_ensemble_batched``,
``fit_alternating_pn`` and ``fit_until`` with a ``mesh``, each on this
rank's shard of the inputs the test built with numpy, by autograd and by
the kernel adapters (their plain versions on the CPU); the results come back
as numpy arrays. Imports neither JAX nor the JAX package."""
import numpy as np
import torch
import torch.distributed as dist

from mri_super_resolution_tpu_torch.fit.engine import (fit_alternating_pn,
                                                      fit_ensemble_batched, fit_until,
                                                      plain_apply_init)
from mri_super_resolution_tpu_torch.fit.optim import Adam, StackedAdam
from mri_super_resolution_tpu_torch.models import Siren, SirenERD, perturbnet_apply
from mri_super_resolution_tpu_torch.ops.siren_kernel import (
    make_fused_value_grad_absmax, make_fused_weighted_value_and_grad_batched,
    siren_forward_batched_ref, siren_forward_ref, siren_fused, siren_loss_grads)
from mri_super_resolution_tpu_torch.parallel import Spec, make_mesh, shard_batch

ROUTES = ("autograd", "kernel")


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def run_ensemble(d: dict, route: str, mesh) -> dict:
    """``fit_ensemble_batched`` on ``mesh``'s shard (``mesh=None``: the
    whole batch)."""
    model = Siren(2, d["hidden"], d["layers"], 1)
    omegas = model.omegas
    shard = (lambda x, spec=None: x) if mesh is None else (  # noqa: E731
        lambda x, spec=None: shard_batch(x, mesh, spec))
    acq = Spec(None, None, "data")
    kw = {} if mesh is None else {"mesh": mesh}
    opt = StackedAdam([_t(w) for w in d["init"]], d["lr"])
    res = fit_ensemble_batched(
        lambda p, x: siren_forward_batched_ref(x, p, omegas), opt, shard(_t(d["coords"])),
        shard(_t(d["pixels"]), acq), shard(_t(d["weights"]), acq), shard(_t(d["coords"])),
        shard(_t(d["coords_s"])), d["steps"], d["seg"], valid=d["valid"],
        weighted_value_and_grad_fn=(make_fused_weighted_value_and_grad_batched(model)
                                    if route == "kernel" else None), **kw)
    return {"params": [p.numpy().copy() for p in res.params], "losses": res.losses.numpy(),
            "pred_1x": res.pred_1x.numpy(), "pred_scale": res.pred_scale.numpy(),
            "count": opt.count.copy(), "mu": opt.mu.numpy().copy(), "nu": opt.nu.numpy().copy()}


def _kernel_apply(params, x):
    return siren_fused(x, params)


def _kernel_vag(params, x, target):
    return siren_loss_grads(x, params, target)


def _plain_apply(params, x):
    return siren_forward_ref(x, params)


def run_alternating(d: dict, route: str, mesh) -> dict:
    shard = (lambda x, spec=None: x) if mesh is None else (  # noqa: E731
        lambda x, spec=None: shard_batch(x, mesh, spec))
    kw = {} if mesh is None else {"mesh": mesh}
    res = fit_alternating_pn(
        _kernel_apply if route == "kernel" else _plain_apply, perturbnet_apply,
        Adam([_t(w).clone() for w in d["inr"]], d["inr_lr"]),
        Adam([_t(w).clone() for w in d["pn"]], d["pn_lr"]), shard(_t(d["ff"])),
        shard(_t(d["target"])), shard(_t(d["acq"]), Spec(None, "data")), _t(d["B"]),
        num_epochs=d["epochs"], pn_epochs=d["pn_epochs"],
        inr_value_and_grad=_kernel_vag if route == "kernel" else None, **kw)
    return {"inr": [p.numpy().copy() for p in res.inr_params],
            "pn": [p.numpy().copy() for p in res.pn_params], "losses": res.losses.numpy()}


def run_until(d: dict, route: str, mesh, inits: list) -> dict:
    """``fit_until`` of a ``SirenERD`` whose k-th draw is ``inits[k]`` (a
    state dict of numpy arrays)."""
    model = SirenERD(2, d["hidden"], d["layers"], perturb=True)

    def init_fn(k):
        model.load_state_dict({n: _t(v) for n, v in inits[k].items()})
        return model.weights()

    apply_plain, _ = plain_apply_init(model)
    shard = (lambda x: x) if mesh is None else (lambda x: shard_batch(x, mesh))  # noqa: E731
    kw = {} if mesh is None else {"mesh": mesh}
    res = fit_until(apply_plain, d["lr"], init_fn, shard(_t(d["coords"])),
                    shard(_t(d["target"])), loss_threshold=d["threshold"],
                    max_steps=d["max_steps"],
                    value_grad_absmax_fn=(make_fused_value_grad_absmax(model)
                                          if route == "kernel" else None), **kw)
    return {"params": [p.detach().numpy().copy() for p in res.params], "steps": res.steps,
            "loss": res.loss, "losses": np.asarray(res.losses), "restarts": res.restarts}


def run_all(inp: dict) -> dict:
    torch.set_num_threads(2)
    rank = dist.get_rank()
    mesh = make_mesh(case=1)
    out = {}
    for key, d in inp["ensemble"].items():
        for route in ROUTES:
            out[f"ensemble_{key}_{route}"] = run_ensemble(d, route, mesh)
    for route in ROUTES:
        out[f"alternating_{route}"] = run_alternating(inp["alternating"], route, mesh)
    for key, d in inp["until"].items():
        # rank 1 draws other params: the broadcast from rank 0 must win
        inits = d["inits"] if rank == 0 else d["other_inits"]
        for route in ROUTES:
            out[f"until_{key}_{route}"] = run_until(d, route, mesh, inits)
    # unequal shards (rank 1 one row short) are refused on every rank
    d = inp["until"]["stop"]
    rows = len(d["coords"]) // 2 - rank
    try:
        fit_until(None, d["lr"], lambda k: [torch.zeros(1)], _t(d["coords"])[:rows],
                  _t(d["target"])[:rows], mesh=mesh)
        out["unequal"] = None
    except ValueError as e:
        out["unequal"] = str(e)
    return out
