"""The port's parallel layer against the JAX package's: the voxel-sharded fit
by autograd and by K1 (the JAX Pallas kernel in interpret mode on the
8-device virtual mesh; the port's plain K1 on CPU tensors), the padded
``n_rows`` fit against the unpadded one, the cohort fit with and without
moment restarts, the tensor-parallel fit at both stack parities, and the
MISR trainer's mesh path on a ragged batch.

The port's side runs once, in one module-scoped spawn of 2 gloo ranks on
the CPU (``tests/_torch_parallel_worker.py``), from inputs built here: the
JAX package's params converted with ``convert.py``, never two seeded draws
compared. One-process checks hold each function on a mesh of one.

Tolerances: the sharded and cohort fits, losses atol 2e-5 and params 5e-4
(the JAX package's own bar between its two routes); the padded fit against
the unpadded one, rtol 1e-5 / atol 1e-7 on losses and 1e-4 / 1e-6 on params
(its bar between 8 devices and 1); the tensor-parallel losses rtol 1e-4 (its
1-vs-N bar); the trainer's loss and cPSNR rtol 1e-5, each gradient leaf
within 1e-4 of its largest entry, the params after Adam's first update
within 2 lr (as ``tests/test_torch_trainer.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_super_resolution_tpu.config import RAMSConfig as JRAMSConfig
from mri_super_resolution_tpu.config import TrainerConfig as JTrainerConfig
from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.fit.trainer import Trainer as JTrainer
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.ops.pallas.siren_kernel import (
    make_fused_value_and_grad as jfused_vag)
from mri_super_resolution_tpu.parallel import (make_cohort_fit as jcohort_fit,
                                               make_mesh as jmake_mesh,
                                               make_sharded_fit as jsharded_fit,
                                               make_tp_fit as jtp_fit,
                                               make_tp_mesh as jtp_mesh,
                                               shard_batch as jshard_batch,
                                               siren_tp_specs as jtp_specs,
                                               stack_params as jstack)
from mri_super_resolution_tpu.pipelines.misr import build_rams as jbuild_rams
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.config import RAMSConfig, TrainerConfig
from mri_super_resolution_tpu_torch.fit.optim import Adam
from mri_super_resolution_tpu_torch.fit.trainer import Trainer
from mri_super_resolution_tpu_torch.models import Siren, SirenERD
from mri_super_resolution_tpu_torch.ops.siren_kernel import (make_fused_value_and_grad,
                                                             siren_forward_ref)
from mri_super_resolution_tpu_torch.parallel import (Spec, case_data_sharding,
                                                     data_sharding, host_local_slice,
                                                     make_cohort_fit, make_global_batch,
                                                     make_mesh, make_sharded_fit,
                                                     make_tp_fit, make_tp_mesh,
                                                     pad_to_multiple, replicated,
                                                     restore_sharded, save_sharded,
                                                     shard_batch, siren_tp_specs,
                                                     stack_params)
from mri_super_resolution_tpu_torch.parallel.distributed import spawn_ranks

torch.set_num_threads(2)

RANKS = 2
TRAIN_RAMS = dict(filters=4, N=1, r=2, compute_dtype="float32")
HR, BATCH = 18, 5  # LR 6 x 6; 5 samples: ragged on 2 ranks and on 8 devices


def _target(c):
    return np.sin(3.0 * c[:, :1]) * np.cos(2.0 * c[:, 1:2])


def _jsiren(hidden, layers, coords, seed=0):
    model = JSiren(hidden_features=hidden, hidden_layers=layers, out_features=1)
    return model, model.init(jax.random.key(seed), coords[:4])


def _tw(params):
    return [w.numpy() for w in convert.siren_weights(jax.tree.map(np.asarray, params))]


def _jfit_np(res):
    return _tw(res.params), np.asarray(res.losses)


def _jtrain_data():
    rng = np.random.default_rng(0)
    x = rng.uniform(7000, 8000, (BATCH, HR // 3, HR // 3, 9)).astype(np.float32)
    y = rng.uniform(7000, 8000, (BATCH, HR, HR, 1)).astype(np.float32)
    return x, y, np.ones_like(y)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every case's inputs and the JAX package's results."""
    mesh8 = jmake_mesh(case=1)
    mesh1 = jmake_mesh(case=1, devices=jax.devices()[:1])
    inp, ref = {}, {}

    c = jmgrid((16, 16))
    t = jnp.asarray(_target(np.asarray(c)))
    model, params = _jsiren(128, 2, c)
    inp["dp"] = dict(hidden=128, layers=2, weights=_tw(params), coords=np.asarray(c),
                     target=np.asarray(t), steps=5, lr=1e-4)
    sb = lambda a: jshard_batch(a, mesh8)  # noqa: E731
    ref["dp_autograd"] = _jfit_np(jsharded_fit(model.apply, optax.adam(1e-4), mesh8, 5)(
        jax.tree.map(jnp.copy, params), sb(c), sb(t)))
    ref["dp_kernel"] = _jfit_np(jsharded_fit(
        model.apply, optax.adam(1e-4), mesh8, 5, value_and_grad_fn=jfused_vag(model))(
        jax.tree.map(jnp.copy, params), sb(c), sb(t)))

    c = jmgrid((13, 13))  # 169 rows: divides neither 2 nor 8
    t = jnp.asarray(_target(np.asarray(c)))
    model, params = _jsiren(32, 1, c)
    inp["pad"] = dict(hidden=32, layers=1, weights=_tw(params), coords=np.asarray(c),
                      target=np.asarray(t), steps=5, lr=1e-3)
    ref["pad"] = _jfit_np(jsharded_fit(model.apply, optax.adam(1e-3), mesh1, 5)(
        jax.tree.map(jnp.copy, params), jshard_batch(c, mesh1), jshard_batch(t, mesh1)))

    c = jmgrid((12, 12))
    model = JSiren(hidden_features=16, hidden_layers=1, out_features=1)
    stack = jstack([model.init(k, c[:4]) for k in jax.random.split(jax.random.key(3), 2)])
    cs = jnp.broadcast_to(c, (2,) + c.shape)
    ts = jnp.stack([jnp.asarray(_target(np.asarray(c))), jnp.cos(c[:, :1] - c[:, 1:2])])
    conv = lambda s: [np.stack(w) for w in zip(*(_tw(jax.tree.map(  # noqa: E731
        lambda a, i=i: np.asarray(a)[i], s)) for i in range(2)))]
    inp["cohort"] = dict(stack=conv(stack), coords=np.asarray(cs), targets=np.asarray(ts),
                         steps=10, lr=3e-4, restart=4)
    mesh_c = jmake_mesh(case=2)
    from mri_super_resolution_tpu.fit.optim import restart_adam

    for every, tx in ((0, optax.adam(3e-4)), (4, restart_adam(3e-4, 4))):
        res = jcohort_fit(model.apply, tx, mesh_c, 10)(jax.tree.map(jnp.copy, stack), cs, ts)
        ref[f"cohort_{every}"] = (conv(res.params), np.asarray(res.losses))

    c = jmgrid((16, 16))
    t = jnp.asarray(np.sin(3.0 * np.asarray(c)[:, :1]) * np.cos(2.0 * np.asarray(c)[:, 1:2]))
    inp["tp"] = {}
    for layers in (2, 3):
        model, params = _jsiren(32, layers, c)
        inp["tp"][layers] = dict(hidden=32, weights=_tw(params), coords=np.asarray(c),
                                 target=np.asarray(t), steps=4, lr=1e-3)
        res = jtp_fit(model.apply, optax.adam(1e-3), jtp_mesh(data=2, model=4), 4,
                      jtp_specs(params))(jax.tree.map(jnp.copy, params), c, t)
        ref[f"tp_{layers}"] = (_tw(res.params), np.asarray(res.losses))

    x, y, m = _jtrain_data()
    jm = jbuild_rams(JRAMSConfig(**TRAIN_RAMS))
    # params drawn with numpy on the init's structure (a flax init of RAMS
    # compiles for seconds on the CPU)
    rng = np.random.default_rng(1)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(rng.uniform(
            *((0.5, 1.5) if path[-1].key == "g" else (-0.2, 0.2)), s.shape).astype(np.float32)),
        jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x[:1])))
    tdir = tmp_path_factory.mktemp("jtrainer")
    jtr = JTrainer(jm, JTrainerConfig(batch_size=BATCH, hr_size=HR,
                                      checkpoint_dir=str(tdir / "ck"),
                                      log_dir=str(tdir / "logs")),
                   mesh=jax.sharding.Mesh(np.array(jax.devices()), ("data",)))
    *padded, w = jtr._pad_shard(x, y, m)
    assert len(w) == 8 and w.sum() == BATCH
    p1, _, loss, psnr = jtr._train_step(jax.tree.map(jnp.copy, jparams), jtr.tx.init(jparams),
                                        *(jnp.asarray(a) for a in padded), jnp.asarray(w))
    (_, _), grads = jax.jit(jax.value_and_grad(_jloss(jm, padded, w), has_aux=True))(jparams)
    np_tree = lambda tr: {k: v.numpy() for k, v in  # noqa: E731
                          convert.rams_state_dict(jax.tree.map(np.asarray, tr)).items()}
    inp["trainer"] = dict(rams=TRAIN_RAMS, state=np_tree(jparams), x=x, y=y, m=m, hr=HR)
    ref["trainer"] = dict(loss=float(loss), psnr=float(psnr), grads=np_tree(grads),
                          params=np_tree(p1))
    inp["ckpt_dir"] = str(tmp_path_factory.mktemp("ckpt") / "sharded")
    inp["trainer_dir"] = str(tmp_path_factory.mktemp("trainer"))
    return inp, ref


def _jloss(jm, padded, w):
    from mri_super_resolution_tpu.ops import shift_metrics as jsm

    lr_b, hr_b, m_b = (jnp.asarray(a) for a in padded)
    w = jnp.asarray(w)

    def loss_of(p):
        sr = jm.apply(p, lr_b)
        per = jsm.shift_l1_loss(hr_b, sr, m_b, HR)
        return jnp.sum(per * w) / jnp.sum(w), sr

    return loss_of


@pytest.fixture(scope="module")
def ranks(inputs):
    """The worker's results on each of the 2 ranks."""
    import _torch_parallel_worker as worker

    return spawn_ranks(worker.run_all, RANKS, inputs[0], timeout=300)


def _close_fit(got, want, loss_kw, param_kw):
    params, losses = got
    np.testing.assert_allclose(losses, want[1], **loss_kw)
    for a, b in zip(params, want[0]):
        np.testing.assert_allclose(a, b, **param_kw)


FIT_TOL = (dict(rtol=0, atol=2e-5), dict(rtol=0, atol=5e-4))
PAD_TOL = (dict(rtol=1e-5, atol=1e-7), dict(rtol=1e-4, atol=1e-6))


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["autograd", "kernel"])
def test_sharded_fit_matches_jax(ranks, inputs, route):
    """Each rank's shard through autograd or K1, the gradients summed over
    the data group: the JAX fit on 8 devices (its kernel route through the
    Pallas K1 under shard_map)."""
    for r in ranks:
        _close_fit(r[f"dp_{route}"], inputs[1][f"dp_{route}"], *FIT_TOL)
    np.testing.assert_array_equal(ranks[0][f"dp_{route}"][1], ranks[1][f"dp_{route}"][1])


@pytest.mark.parametrize("route", ["autograd", "kernel"])
def test_padded_fit_equals_the_unpadded_fit(ranks, inputs, route):
    """169 rows padded to 170 over 2 ranks with ``n_rows``: the MSE over the
    real rows, as one rank's unpadded fit and the JAX package's."""
    for r in ranks:
        _close_fit(r[f"pad_{route}"], r["pad_unpadded"], *PAD_TOL)
        _close_fit(r[f"pad_{route}"], inputs[1]["pad"], *FIT_TOL)


def test_a_shard_of_padding_adds_zeros(ranks):
    """84 real rows padded to 168: rank 1's shard is all padding, adds zeros
    and calls no K1 (which refuses n_rows = 0)."""
    for r in ranks:
        _close_fit(r["pad_one_shard"], r["pad_one_shard_ref"], *PAD_TOL)


@pytest.mark.parametrize("every", [0, 4])
def test_cohort_fit_matches_jax(ranks, inputs, every):
    """Two cases, one a rank (the JAX mesh: case 2 x data 4), plain Adam and
    Adam with moment restarts every 4 steps."""
    for r in ranks:
        _close_fit(r[f"cohort_{every}"], inputs[1][f"cohort_{every}"], *FIT_TOL)


@pytest.mark.parametrize("layers", [2, 3])
def test_tensor_parallel_fit_matches_jax(ranks, inputs, layers):
    """Width 32 split over 2 ranks (the head row-parallel with an odd sine
    stack, replicated with an even one) against the JAX fit on its (2, 4)
    (data, model) mesh; the gathered params too."""
    for r in ranks:
        _close_fit(r[f"tp_{layers}"], inputs[1][f"tp_{layers}"], dict(rtol=1e-4, atol=1e-6),
                   dict(rtol=0, atol=5e-4))


def test_trainer_mesh_path_matches_jax(ranks, inputs):
    """A ragged batch of 5 on 2 ranks (padded to 6, w = 0 on the copy)
    against the JAX trainer's mesh step on 8 devices (padded to 8)."""
    want = inputs[1]["trainer"]
    for r in ranks:
        got = r["trainer"]
        assert got["rows"] == 3
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5)
        for k, g in got["grads"].items():
            w = want["grads"][k]
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                       err_msg=k)
            np.testing.assert_allclose(got["params"][k], want["params"][k], rtol=0,
                                       atol=2 * 1e-4, err_msg=k)
    for k in ranks[0]["trainer"]["params"]:
        np.testing.assert_array_equal(ranks[0]["trainer"]["params"][k],
                                      ranks[1]["trainer"]["params"][k])
    assert ranks[0]["trainer"]["val"] == ranks[1]["trainer"]["val"]


def test_only_the_first_rank_writes_checkpoints(ranks):
    assert ranks[0]["trainer"]["saved"] and not ranks[1]["trainer"]["saved"]
    for r in ranks:  # one directory, the first rank's file
        assert "0.pt" in r["trainer"]["ckpt_files"]


def test_global_batch_and_sharded_checkpoint(ranks, inputs):
    """Ragged host-local slices (3 + 2 rows) agree on one global shape; the
    tensor-parallel shards go through torch.distributed.checkpoint and
    back."""
    want = inputs[0]["pad"]["weights"]
    for r in ranks:
        assert r["global_shape"] == (5, 1)
        assert r["ckpt_equal"]
        for a, b in zip(r["ckpt_full"], want):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# one process: a mesh of one
# ---------------------------------------------------------------------------


def _port_siren(inp):
    m = Siren(2, inp["hidden"], inp["layers"], 1)
    m.requires_grad_(False)
    for p, w in zip(m.weights(), inp["weights"]):
        p.copy_(torch.as_tensor(w))
    return m


def _apply(p, x):
    return siren_forward_ref(x, p)


@pytest.mark.parametrize("route", ["autograd", "kernel"])
def test_sharded_fit_one_process(inputs, route):
    d = inputs[0]["dp"]
    m = _port_siren(d)
    mesh = make_mesh()
    assert mesh.shape == {"case": 1, "data": 1} and mesh.groups == {}
    kw = {"value_and_grad_fn": make_fused_value_and_grad(m)} if route == "kernel" else {}
    res = make_sharded_fit(_apply, lambda p: Adam(p, d["lr"]), mesh, d["steps"], **kw)(
        m.weights(), torch.as_tensor(d["coords"]), torch.as_tensor(d["target"]))
    _close_fit(([p.numpy() for p in res.params], res.losses.numpy()),
               inputs[1][f"dp_{route}"], *FIT_TOL)
    # the caller's params are left as they were
    np.testing.assert_array_equal(m.weights()[0].numpy(), d["weights"][0])


def test_padded_fit_one_process(inputs):
    """Padded to 176 rows on one rank, ``n_rows`` 169, by autograd and by
    K1: the unpadded fit."""
    d = inputs[0]["pad"]
    m = _port_siren(d)
    c, t = torch.as_tensor(d["coords"]), torch.as_tensor(d["target"])
    cp, n = pad_to_multiple(c, 16)
    tp, _ = pad_to_multiple(t, 16)
    assert cp.shape == (176, 2) and n == 169 and not cp[169:].any()
    for kw in ({}, {"value_and_grad_fn": make_fused_value_and_grad(m)}):
        res = make_sharded_fit(_apply, lambda p: Adam(p, d["lr"]), make_mesh(), d["steps"],
                               n_rows=n, **kw)(m.weights(), cp, tp)
        _close_fit(([p.numpy() for p in res.params], res.losses.numpy()), inputs[1]["pad"],
                   *FIT_TOL)


def test_weighted_route_takes_a_row_mask(inputs):
    """The JAX package's padded route: K1's weighted variant with a 0/1
    mask (its plain version here)."""
    from mri_super_resolution_tpu_torch.ops.siren_kernel import (
        make_fused_weighted_value_and_grad)

    d = inputs[0]["pad"]
    m = _port_siren(d)
    cp, n = pad_to_multiple(torch.as_tensor(d["coords"]), 8)
    tp, _ = pad_to_multiple(torch.as_tensor(d["target"]), 8)
    res = make_sharded_fit(None, lambda p: Adam(p, d["lr"]), make_mesh(), d["steps"], n_rows=n,
                           weighted_value_and_grad_fn=make_fused_weighted_value_and_grad(m))(
        m.weights(), cp, tp)
    _close_fit(([p.numpy() for p in res.params], res.losses.numpy()), inputs[1]["pad"],
               *FIT_TOL)
    with pytest.raises(ValueError, match="needs n_rows"):
        make_sharded_fit(None, None, make_mesh(), 1,
                         weighted_value_and_grad_fn=make_fused_weighted_value_and_grad(m))


@pytest.mark.parametrize("every", [0, 4])
def test_cohort_fit_one_process(inputs, every):
    d = inputs[0]["cohort"]
    res = make_cohort_fit(_apply, lambda p: Adam(p, d["lr"], restart_every=every),
                          make_mesh(), d["steps"])(
        [torch.as_tensor(p) for p in d["stack"]], torch.as_tensor(d["coords"]),
        torch.as_tensor(d["targets"]))
    _close_fit(([p.numpy() for p in res.params], res.losses.numpy()),
               inputs[1][f"cohort_{every}"], *FIT_TOL)


@pytest.mark.parametrize("layers", [2, 3])
def test_tensor_parallel_fit_one_process(inputs, layers):
    d = inputs[0]["tp"][layers]
    m = _port_siren({**d, "layers": layers})
    res = make_tp_fit(m, lambda p: Adam(p, d["lr"]), make_tp_mesh(), d["steps"],
                      siren_tp_specs(m))(m.weights(), torch.as_tensor(d["coords"]),
                                         torch.as_tensor(d["target"]))
    _close_fit(([p.numpy() for p in res.params], res.losses.numpy()), inputs[1][f"tp_{layers}"],
               dict(rtol=1e-4, atol=1e-6), dict(rtol=0, atol=5e-4))


def test_trainer_mesh_of_one_matches_jax(inputs, tmp_path):
    """A mesh of one pads nothing: the step equals the JAX mesh step."""
    d, want = inputs[0]["trainer"], inputs[1]["trainer"]
    model = __import__("mri_super_resolution_tpu_torch.pipelines.misr",
                       fromlist=["build_rams"]).build_rams(RAMSConfig(**d["rams"]))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in d["state"].items()})
    tr = Trainer(model, TrainerConfig(batch_size=BATCH, hr_size=HR,
                                      checkpoint_dir=str(tmp_path / "ck"),
                                      log_dir=str(tmp_path / "logs")),
                 device="cpu", mesh=make_mesh())
    tr.init()
    batch = tr._batch(np.arange(BATCH), d["x"], d["y"], d["m"])
    assert float(batch[3].sum()) == BATCH and len(batch[3]) == BATCH
    loss, psnr = tr.train_step([batch])
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(psnr), want["psnr"], rtol=1e-5)


def test_tp_specs_follow_the_stack_parity():
    even = siren_tp_specs(Siren(2, 16, 3))  # 4 sine layers: the head replicated
    assert even[0] == Spec("model", None) and even[1] == Spec("model")
    assert even[2] == Spec(None, "model") and even[3] == Spec()
    assert even[-2:] == [Spec(), Spec()]
    odd = siren_tp_specs(Siren(2, 16, 2))  # 3 sine layers: the head row-parallel
    assert odd[-2:] == [Spec(None, "model"), Spec()]
    with pytest.raises(ValueError, match="plain Siren"):
        siren_tp_specs(SirenERD(2, 16, 1))


def test_indivisible_width_raises():
    from mri_super_resolution_tpu_torch.parallel.mesh import Mesh
    from mri_super_resolution_tpu_torch.parallel.tp_fit import _check_divisible

    m = Siren(2, 30, 2)
    mesh = Mesh(("data", "model"), (1, 4), (0, 1, 2, 3), 0, {})  # rank 0's view, no groups
    with pytest.raises(ValueError, match="not divisible"):
        _check_divisible(m.weights(), siren_tp_specs(m), mesh)


def test_mesh_checks_and_shards():
    with pytest.raises(ValueError, match="not divisible by case"):
        make_mesh(case=2)
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(case=1, data=2)
    mesh = make_mesh()
    assert data_sharding(mesh) == Spec("data") and case_data_sharding(mesh) == Spec(
        "case", "data") and replicated(mesh) == Spec()
    x = torch.arange(24.0).reshape(6, 4)
    assert torch.equal(shard_batch(x, mesh), x)
    padded, n = pad_to_multiple(np.ones((5, 2), np.float32), 4)
    assert padded.shape == (8, 2) and n == 5 and padded[5:].sum() == 0
    assert host_local_slice(10) == slice(0, 10)
    gb = make_global_batch(np.arange(8.0).reshape(4, 2), mesh, global_rows=4)
    assert gb.global_shape == (4, 2)
    with pytest.raises(ValueError, match="global_rows"):
        make_global_batch(np.zeros((4, 2)), mesh, global_rows=5)
    assert stack_params([[torch.ones(2)], [torch.zeros(2)]])[0].shape == (2, 2)


def test_sharded_checkpoint_one_process(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "step": torch.tensor(3)}
    save_sharded(str(tmp_path / "c"), tree)
    back = restore_sharded(str(tmp_path / "c"), {"w": torch.zeros(3, 4),
                                                 "step": torch.tensor(0)})
    assert torch.equal(back["w"], tree["w"]) and int(back["step"]) == 3
