"""The port's MISR trainer against the JAX package's: one optimizer step of
a tiny RAMS (filters 8, N 1, r 4, float32) on the K6/K7 route and the
library route, three epochs of ``fit``, the trainer's behaviour (gradient
accumulation, EMA, the cosine schedule, the non-finite guard, checkpoints,
restore), the TensorBoard writer, the dataset functions and the
``train_misr`` CLI on the CPU, through to serving its checkpoint with
``misr_master``.

JAX-drawn params reach the port through ``convert.rams_state_dict`` (the
gradient trees too). The JAX package's K6/K7 route runs once, in Pallas
interpret mode, for the one-step comparison; the rest compares with its XLA
route, which the JAX package holds equal to the kernel route
(``tests/test_conv3d_kernel.py``). On CPU tensors K6 and K7 run their plain
versions and launch nothing.

Tolerances: loss and cPSNR rtol 1e-5 (float32 sums in another order); each
gradient leaf within 1e-4 of its largest entry; the params after Adam's
first update, about ``lr * sign(g)``, within 2 lr (a gradient near 0 may
take the other sign in the other package).
"""
import dataclasses
import importlib.util
import json
import math
import os
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.io as sio
import torch

from mri_super_resolution_tpu.config import RAMSConfig as JRAMSConfig
from mri_super_resolution_tpu.config import TrainerConfig as JTrainerConfig
from mri_super_resolution_tpu.fit.trainer import Trainer as JTrainer
from mri_super_resolution_tpu.fit.trainer import TrainState as JTrainState
from mri_super_resolution_tpu.ops import shift_metrics as jsm
from mri_super_resolution_tpu.pipelines.misr import build_rams as jbuild_rams
from mri_super_resolution_tpu.utils import tbevents as jtb
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.cli import misr_master, train_misr
from mri_super_resolution_tpu_torch.config import RAMSConfig, TrainerConfig
from mri_super_resolution_tpu_torch.fit.trainer import Trainer, _augment_batch
from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck
from mri_super_resolution_tpu_torch.pipelines.misr import build_rams
from mri_super_resolution_tpu_torch.utils import tbevents as ttb
from mri_super_resolution_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                             unwrap_trainer_params)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(filters=8, N=1, r=4, compute_dtype="float32")
HR = 24
LR = 1e-4


def _tiny_data(n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(7000, 8000, (n, HR // 3, HR // 3, 9)).astype(np.float32)
    y = rng.uniform(7000, 8000, (n, HR, HR, 1)).astype(np.float32)
    return x, y, np.ones_like(y)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    x, _, _ = _tiny_data()
    model = jbuild_rams(JRAMSConfig(**TINY))
    return jax.jit(model.init)(jax.random.key(0), jnp.asarray(x[:1]))


def _port_trainer(params, tmp, conv_kernel=True, **kw) -> Trainer:
    model = build_rams(RAMSConfig(**TINY, conv_kernel=conv_kernel))
    model.load_state_dict(convert.rams_state_dict(_np(params)))
    cfg = TrainerConfig(**{**dict(batch_size=4, hr_size=HR, checkpoint_dir=str(tmp / "ckpt"),
                                  log_dir=str(tmp / "logs")), **kw})
    return Trainer(model, cfg, device="cpu")


def _cfg(tmp, tag, **kw) -> TrainerConfig:
    return TrainerConfig(**{**dict(batch_size=4, epochs=1, evaluate_every=100, hr_size=HR,
                                   checkpoint_dir=str(tmp / f"ckpt_{tag}"),
                                   log_dir=str(tmp / f"logs_{tag}")), **kw})


def _tiny_model(seed=0, conv_kernel=False):
    return build_rams(RAMSConfig(**TINY, conv_kernel=conv_kernel),
                      generator=torch.Generator().manual_seed(seed))


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


# ---------------------------------------------------------------------------
# one step and three epochs against the JAX trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("conv_kernel", [False, True])
def test_one_step_matches_jax(tmp_path, jax_params, conv_kernel):
    """The port's step (plain K6/K7 or the library convs) against the JAX
    trainer's step: its loss (the weighted batch mean of shift_l1_loss),
    cPSNR, gradients, and the update of its own optax transform."""
    x, y, m = _tiny_data()
    jm = jbuild_rams(JRAMSConfig(**TINY, conv_kernel=conv_kernel))
    jtr = JTrainer(jm, JTrainerConfig(batch_size=4, hr_size=HR,
                                      checkpoint_dir=str(tmp_path / "j"),
                                      log_dir=str(tmp_path / "jl")))
    w = jnp.ones(4, jnp.float32)

    def loss_of(p):  # the trainer's train_fn (fit/trainer.py:129-150)
        sr = jm.apply(p, jnp.asarray(x))
        per = jsm.shift_l1_loss(jnp.asarray(y), sr, jnp.asarray(m), HR)
        return jnp.sum(per * w) / jnp.sum(w), sr

    (loss_j, sr_j), grads_j = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(jax_params)
    psnr_j = jnp.sum(jsm.shift_psnr(jnp.asarray(y), sr_j, jnp.asarray(m), HR, reduce=False)
                     * w) / jnp.sum(w)
    updates, _ = jtr.tx.update(grads_j, jtr.tx.init(jax_params))
    params_j = convert.rams_state_dict(_np(optax.apply_updates(jax_params, updates)))
    if not conv_kernel:  # the trainer's own jitted step gives the same
        p1, _, loss1, psnr1 = jtr._train_step(
            jax.tree.map(jnp.copy, jax_params), jtr.tx.init(jax_params), jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(m), w)
        np.testing.assert_allclose(float(loss1), float(loss_j), rtol=1e-6)
        for k, v in convert.rams_state_dict(_np(p1)).items():
            np.testing.assert_allclose(v.numpy(), params_j[k].numpy(), rtol=0, atol=1e-7)

    tr = _port_trainer(jax_params, tmp_path, conv_kernel=conv_kernel)
    tr.init()
    ck.reset_launches()
    loss, psnr = tr.train_step([tr._batch(np.arange(4), x, y, m)])
    assert ck.LAUNCHES == {"conv3d_rfab": 0, "conv3d_rfab_bwd": 0, "conv3d_rfab_wg": 0}
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(psnr), float(psnr_j), rtol=1e-5)
    grads_j = convert.rams_state_dict(_np(grads_j))
    for k, p in tr.model.named_parameters():
        want = grads_j[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-12, err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(), params_j[k].numpy(), rtol=0,
                                   atol=2 * LR, err_msg=k)


def test_three_epochs_match_jax(tmp_path, jax_params):
    """fit() with batch_size = the dataset size (the permutation only
    reorders one batch) and a validation pass after every step: the port on
    its K6/K7 route against the JAX trainer on its XLA route, step by step
    (train loss, train cPSNR, validation cPSNR)."""
    x, y, m = _tiny_data()
    jcfg = JTrainerConfig(batch_size=4, epochs=3, evaluate_every=1, hr_size=HR,
                          checkpoint_dir=str(tmp_path / "j"), log_dir=str(tmp_path / "jl"))
    jtr = JTrainer(jbuild_rams(JRAMSConfig(**TINY)), jcfg)
    # the state init() builds, without its eager flax init; fit() donates it
    jtr.state = JTrainState(jax.tree.map(jnp.copy, jax_params), jtr.tx.init(jax_params), 0)
    jtr.fit(x, (y, m), validation_data=(x, y, m), seed=3)
    jrows = np.loadtxt(tmp_path / "jl" / "RAMS_scalars.csv", delimiter=",", skiprows=1)

    tr = _port_trainer(jax_params, tmp_path, epochs=3, evaluate_every=1)
    tr.init()
    state = tr.fit(x, (y, m), validation_data=(x, y, m), seed=3)
    rows = np.loadtxt(tmp_path / "logs" / "RAMS_scalars.csv", delimiter=",", skiprows=1)
    assert state.step == 3 and rows.shape == jrows.shape == (3, 4)
    np.testing.assert_array_equal(rows[:, 0], [1, 2, 3])
    np.testing.assert_allclose(rows[:, 1:], jrows[:, 1:], rtol=1e-5)
    assert rows[-1, 1] < rows[0, 1]  # the loss falls


# ---------------------------------------------------------------------------
# trainer behaviour
# ---------------------------------------------------------------------------


def test_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TrainerConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JTrainerConfig)}
    assert ours == theirs


def test_grad_accum_equals_one_big_batch(tmp_path):
    """Two micro-batches of 4 accumulated as weighted sums are one step on
    the batch of 8 (the same permutation: the same seed, the same n)."""
    x, y, m = _tiny_data(n=8)
    big = Trainer(_tiny_model(), _cfg(tmp_path, "big", batch_size=8), device="cpu")
    big.init()
    sb = big.fit(x, (y, m), seed=3)
    acc = Trainer(_tiny_model(), _cfg(tmp_path, "acc", batch_size=4, grad_accum=2),
                  device="cpu")
    acc.init()
    sa = acc.fit(x, (y, m), seed=3)
    assert sb.step == sa.step == 1
    for k, p in sb.params.items():
        torch.testing.assert_close(sa.params[k], p, rtol=2e-5, atol=2e-7)
    # a partial last group (3 micro-batches, accum 2) is one more step
    rag = Trainer(_tiny_model(), _cfg(tmp_path, "rag", batch_size=2, grad_accum=2,
                                      ema_decay=0.5), device="cpu")
    rag.init()
    assert rag.fit(x[:6], (y[:6], m[:6]), seed=3).step == 2


def test_ema_matches_closed_form(tmp_path):
    """The EMA run's averages equal the plain run's trajectory folded
    through e = d e + (1 - d) p, and the raw params are the plain run's."""
    x, y, m = _tiny_data()
    d = 0.5
    plain = Trainer(_tiny_model(), _cfg(tmp_path, "plain", batch_size=2), device="cpu")
    plain.init()
    ema = Trainer(_tiny_model(), _cfg(tmp_path, "ema", batch_size=2, ema_decay=d),
                  device="cpu")
    ema.init()
    expect = _params(plain.model)
    gen = torch.Generator().manual_seed(3 + 1)  # fit()'s draws for seed 3
    perm = torch.randperm(len(x), generator=gen).numpy()
    for i in range(0, len(x), 2):
        plain.train_step([plain._batch(perm[i:i + 2], x, y, m)])
        expect = {k: d * e + (1 - d) * plain.state.params[k].detach()
                  for k, e in expect.items()}
    ema.fit(x, (y, m), seed=3)
    for k, e in expect.items():
        torch.testing.assert_close(ema.state.ema_params[k], e, rtol=2e-6, atol=2e-7)
        torch.testing.assert_close(ema.state.params[k], plain.state.params[k],
                                   rtol=2e-6, atol=2e-7)
    with pytest.raises(ValueError, match="ema_decay"):
        Trainer(_tiny_model(), _cfg(tmp_path, "bad", ema_decay=1.0), device="cpu")


def test_cosine_schedule_counts_applied_updates(tmp_path):
    """learning_rate(count) is optax's cosine_decay_schedule (alpha 0); each
    step's update uses the count of updates applied before it."""
    cfg = _cfg(tmp_path, "cos", batch_size=2, lr_schedule="cosine", decay_steps=4)
    tr = Trainer(_tiny_model(), cfg, device="cpu")
    sched = optax.cosine_decay_schedule(LR, 4)
    for count in range(7):
        np.testing.assert_allclose(tr.learning_rate(count), float(sched(count)), rtol=1e-6,
                                   atol=1e-12)
    tr.init()
    x, y, m = _tiny_data()
    seen = []
    step = torch.optim.Adam.step

    def spy(opt, *a, **k):
        seen.append(opt.param_groups[0]["lr"])
        return step(opt, *a, **k)

    torch.optim.Adam.step = spy
    try:
        tr.fit(x, (y, m), epochs=3, seed=0)
    finally:
        torch.optim.Adam.step = step
    np.testing.assert_allclose(seen, [float(sched(c)) for c in range(6)], rtol=1e-6,
                               atol=1e-12)
    with pytest.raises(ValueError, match="decay_steps"):
        Trainer(_tiny_model(), _cfg(tmp_path, "c2", lr_schedule="cosine"), device="cpu")
    with pytest.raises(ValueError, match="lr_schedule"):
        Trainer(_tiny_model(), _cfg(tmp_path, "c3", lr_schedule="bogus"), device="cpu")


def test_non_finite_guard(tmp_path, capsys):
    """A batch with a non-finite loss leaves the params, the Adam state and
    the schedule's count as they were and is not counted; the EMA still
    moves (toward the unchanged params)."""
    x, y, m = _tiny_data()
    tr = Trainer(_tiny_model(), _cfg(tmp_path, "nan", batch_size=2, ema_decay=0.5),
                 device="cpu")
    tr.init()
    tr.train_step([tr._batch(np.arange(2), x, y, m)])  # one good step
    before = _params(tr.model)
    opt_before = {k: v.clone() for k, v in
                  tr.state.optimizer.state[next(tr.model.parameters())].items()}
    ema_before = {k: v.clone() for k, v in tr.state.ema_params.items()}
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    loss, _ = tr.train_step([tr._batch(np.arange(2), bad, y, m)])
    assert not math.isfinite(float(loss))
    for k, v in tr.state.params.items():
        assert torch.equal(v, before[k]), k
    for k, v in tr.state.optimizer.state[next(tr.model.parameters())].items():
        assert torch.equal(v, opt_before[k]), k
    for k, e in tr.state.ema_params.items():
        torch.testing.assert_close(e, 0.5 * ema_before[k] + 0.5 * before[k])
    state = tr.fit(bad, (y, m), seed=0)  # one bad and one good batch per epoch
    assert state.step == 1
    assert "non-finite loss, batch skipped" in capsys.readouterr().out


def test_checkpoint_manager_keeps_n_and_gates_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=3)
    assert mgr.latest_step() is None and mgr.restore() is None
    for step, metric in enumerate([1.0, 3.0, 2.0, 4.0, 5.0], start=1):
        assert mgr.save(step, {"step": step, "w": torch.full((2,), float(step))},
                        metric=metric)
    assert mgr.all_steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert float(mgr.restore()["w"][0]) == 5.0 and mgr.restore(step=3)["step"] == 3
    assert mgr.save(6, {"step": 6}, metric=4.5, best_only=True) is False
    assert mgr.save(7, {"step": 7}, metric=6.0, best_only=True) is True
    with pytest.raises(ValueError, match="requires a metric"):
        mgr.save(8, {}, best_only=True)
    again = CheckpointManager(str(tmp_path / "c"), max_to_keep=3)
    assert again.best_metric == 6.0 and again.latest_step() == 7


def test_save_best_only_gates_trainer_saves(tmp_path):
    tr = Trainer(_tiny_model(), _cfg(tmp_path, "best", save_best_only=True), device="cpu")
    tr.init()
    assert tr._save(10.0) is True
    tr.state.step += 1
    assert tr._save(5.0) is False
    tr.state.step += 1
    assert tr._save(11.0) is True
    assert tr.manager.all_steps() == [0, 2]


def test_restore_and_layout_fallback(tmp_path, capsys):
    """A fresh trainer restores step, params, Adam state and EMA; a
    checkpoint with another optimizer's layout restores the params and
    resets the moments."""
    x, y, m = _tiny_data()
    cfg = _cfg(tmp_path, "rt", batch_size=2, evaluate_every=2, ema_decay=0.9)
    tr = Trainer(_tiny_model(), cfg, device="cpu")
    tr.init()
    tr.fit(x, (y, m), validation_data=(x, y, m))
    again = Trainer(_tiny_model(seed=9), cfg, device="cpu")
    st = again.init()
    assert st.step == tr.state.step == 2
    for k, p in tr.state.params.items():
        assert torch.equal(st.params[k], p)
        assert torch.equal(st.ema_params[k], tr.state.ema_params[k])
    assert max(float((st.ema_params[k] - p.detach()).abs().max())
               for k, p in st.params.items()) > 0
    first = next(again.model.parameters())
    assert int(st.optimizer.state[first]["step"]) == 2
    tree = again.manager.restore()
    served = unwrap_trainer_params(tree)
    assert all(torch.equal(served[k], st.ema_params[k]) for k in served)
    # enabling EMA on a checkpoint without one seeds it at the params
    tree["opt_state"] = {"legacy_per_leaf_adam": torch.zeros(3)}
    del tree["ema_params"]
    again.manager.save(3, tree, metric=1.0)
    third = Trainer(_tiny_model(seed=5), cfg, device="cpu")
    st3 = third.init()
    assert "moments reset" in capsys.readouterr().out
    assert st3.step == 2 and not st3.optimizer.state
    for k, p in st3.params.items():
        assert torch.equal(p, tr.state.params[k])
        assert torch.equal(st3.ema_params[k], p)


def test_unwrap_trainer_params():
    params = {"a": torch.ones(2)}
    assert unwrap_trainer_params(params) is params
    tree = {"step": 3, "psnr": 1.0, "params": params, "opt_state": {}}
    assert unwrap_trainer_params(tree) is params
    ema = {"a": torch.zeros(2)}
    assert unwrap_trainer_params({**tree, "ema_params": ema}) is ema
    assert unwrap_trainer_params({**tree, "ema_params": None}) is params


def test_augment_batch_moves_all_three_alike():
    gen = torch.Generator().manual_seed(0)
    lr = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)
    hr = lr.repeat_interleave(3, 1).repeat_interleave(3, 2)
    for _ in range(8):
        a, b, c = _augment_batch(gen, lr, hr, hr.clone())
        assert torch.equal(b, c)
        assert torch.equal(a.repeat_interleave(3, 1).repeat_interleave(3, 2), b)


def test_trainer_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(_tiny_model(), _cfg(tmp_path, "card"))


# ---------------------------------------------------------------------------
# TensorBoard, the dataset functions and the CLI
# ---------------------------------------------------------------------------


def test_tensorboard_records_equal_the_jax_writer(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    paths = []
    for mod, tag in ((jtb, "j"), (ttb, "t")):
        with mod.EventWriter(str(tmp_path / tag)) as w:
            for step, (loss, psnr) in enumerate([(0.5, 30.25), (1e-9, 41.0), (7.0, -1.0)]):
                w.add_scalar("Loss", loss, step)
                w.add_scalar("PSNR", psnr, step)
            w.add_scalar("Loss", 3.0, -2, wall_time=12.5)
        paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def _cli_module():
    spec = importlib.util.spec_from_file_location(
        "jax_train_misr", os.path.join(REPO, "cli", "train_misr.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_split_dataset_holds_out_whole_patients():
    jcli = _cli_module()
    rng = np.random.default_rng(0)
    pids = np.asarray([0, 0, 1, 2, 2, 1, 3, 3])
    X = rng.normal(size=(8, 4, 4, 2)).astype(np.float32)
    Y = rng.normal(size=(8, 12, 12, 1)).astype(np.float32)
    M = np.ones_like(Y)
    for k in (1, 2):
        (Xt, Yt, Mt), (Xv, Yv, Mv) = train_misr.split_dataset(X, Y, M, pids, k)
        (jXt, _, _), (jXv, jYv, _) = jcli.split_dataset(X, Y, M, pids, k)
        np.testing.assert_array_equal(Xt, jXt)
        np.testing.assert_array_equal(Xv, jXv)
        np.testing.assert_array_equal(Yv, jYv)
        held = set(pids[-k:].tolist()) if k == 1 else {2, 3}
        assert len(Xv) == sum(p in held for p in pids) and len(Xt) + len(Xv) == 8
    with pytest.raises(ValueError, match="holdout_patients"):
        train_misr.split_dataset(X, Y, M, pids, 0)


def _data_dir(root, pt_nos=("07", "08", "09"), side=40, slices=12):
    """pat*_mean_b0.mat / pat*_ERD.mat at DWI magnitudes under CASE_TABLE
    patient numbers."""
    rng = np.random.default_rng(1)
    root.mkdir(parents=True, exist_ok=True)
    for no in pt_nos:
        sio.savemat(root / f"pat{no}_mean_b0.mat", {"data_mean_b0": rng.uniform(
            20, 60, (side, side, slices)).astype(np.float32)})
        sio.savemat(root / f"pat{no}_ERD.mat", {"ADC_alldata_mm_ERD": rng.uniform(
            0, 3, (side, side, slices)).astype(np.float32)})
    return root


def test_build_dataset_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_SR_DATA_DIR", str(_data_dir(tmp_path / "d")))
    got = train_misr.build_dataset(hr_size=HR, patches_per_slice=2, seed=4)
    want = _cli_module().build_dataset(hr_size=HR, patches_per_slice=2, seed=4)
    assert got[0].shape == (3 * 2 * 2, HR // 3, HR // 3, 9) and got[1].shape[1:] == (HR, HR, 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_train_misr_cli_then_serve(tmp_path, monkeypatch, capsys):
    """The port's train_misr on the CPU (K6/K7's plain versions), then its
    checkpoint directory served by misr_master (train -> serve)."""
    monkeypatch.setenv("MRI_SR_DATA_DIR", str(_data_dir(tmp_path / "d")))
    ck.reset_launches()
    tr = train_misr.main([
        "--epochs", "2", "--batch_size", "4", "--hr_size", str(HR), "--filters", "8",
        "--N", "1", "--patches_per_slice", "2", "--evaluate_every", "1", "--ckpt_dir",
        str(tmp_path / "ck"), "--log_dir", str(tmp_path / "logs"), "--device", "cpu",
        "--conv_kernel", "--compute_dtype", "float32", "--ema_decay", "0.5"])
    assert sum(ck.LAUNCHES.values()) == 0
    out = capsys.readouterr().out
    assert "dataset: 8 train / 4 val patches (patient split)" in out
    assert "final val cPSNR" in out and tr.state.step == 4
    rows = np.loadtxt(tmp_path / "logs" / "RAMS_scalars.csv", delimiter=",", skiprows=1)
    assert rows.shape == (4, 4) and np.isfinite(rows).all()
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() is not None
    misr_master.main(["--ckpt", str(tmp_path / "ck"), "--filters", "8", "--N", "1",
                      "--sample_size", "2", "--device", "cpu", "--conv_kernel",
                      "--limit_cases", "1", "--out_img_folder", str(tmp_path / "o")])
    assert "restoring trainer checkpoint" in capsys.readouterr().out
    assert (tmp_path / "o" / "sr2" / "07" / "DWI" / "mean.dcm").exists()
    timings = json.loads((tmp_path / "o" / "sr2" / "timings.json").read_text())
    assert timings["platform"] == "cpu" and timings["filters"] == 8
    # --data_parallel in one process: a mesh of one rank, the same step
    tr_dp = train_misr.main([
        "--epochs", "1", "--batch_size", "4", "--hr_size", str(HR), "--filters", "8",
        "--N", "1", "--patches_per_slice", "2", "--evaluate_every", "1", "--ckpt_dir",
        str(tmp_path / "ck_dp"), "--log_dir", str(tmp_path / "logs_dp"), "--device", "cpu",
        "--compute_dtype", "float32", "--data_parallel"])
    assert "data-parallel over 1 rank(s)" in capsys.readouterr().out
    assert tr_dp.mesh.shape == {"case": 1, "data": 1} and tr_dp.state.step == 2
