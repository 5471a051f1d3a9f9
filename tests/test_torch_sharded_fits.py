"""The port's three fit programs data-parallel over ranks against the JAX
package's under the 8-device virtual mesh: ``fit_ensemble`` (one direction,
and ``jax.vmap`` over three with unequal valid slots, the 2-D ensemble),
``fit_alternating_pn`` (the 3-D main path's schedule, PerturbNet steps
included) and ``fit_until`` (a stop placed well away from a tie, and a
collapsing first init that restarts at step 1).

The JAX side runs as its dry run does (``__graft_entry__.dryrun_multichip``):
the functions unchanged, on voxel rows put on the mesh with a
``NamedSharding``, on the autodiff route (GSPMD cannot partition a
``pallas_call``). The port's side runs once, in one module-scoped spawn of
2 gloo ranks on the CPU (``tests/_torch_sharded_fits_worker.py``), each
fit with ``mesh=`` on this rank's shard, by autograd and by the kernel
adapters (their plain versions on the CPU). Params are the JAX package's,
converted with ``convert.py``; no two seeded draws are compared. Rank 1's
``init_fn`` draws other params than rank 0's, so that ``fit_until``'s
broadcast decides the replicas' start.

Bars: losses atol 2e-5 and params 5e-4 (``tests/test_torch_parallel.py``'s,
the JAX package's own bar between its two routes), predictions within 1e-4
of their largest magnitude; the two ranks bit-equal to each other;
``fit_until`` stops at JAX's step. In one process, ``mesh=None`` and a mesh
of one are bit-equal to the call without a mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JSpec

from mri_super_resolution_tpu.core.coords import fourier_encode as jff
from mri_super_resolution_tpu.core.coords import mgrid as jmgrid
from mri_super_resolution_tpu.fit import engine as jeng
from mri_super_resolution_tpu.models import PerturbNet as JPerturbNet
from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.models import SirenERD as JSirenERD
from mri_super_resolution_tpu.parallel import make_mesh as jmake_mesh
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.parallel import make_mesh, shard_batch
from mri_super_resolution_tpu_torch.parallel.distributed import spawn_ranks

torch.set_num_threads(2)

RANKS = 2
LOSS_ATOL, PARAM_ATOL, PRED_REL = 2e-5, 5e-4, 1e-4
ROUTES = ["autograd", "kernel"]
SIDE = 8  # 64 voxel rows: 8 a device on the JAX mesh, 32 a rank here


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sd(params) -> dict:
    return {k: v.numpy() for k, v in convert.siren_erd_state_dict(_np(params)).items()}


def _shardings():
    mesh = jmake_mesh(case=1)
    return (NamedSharding(mesh, JSpec("data")),
            NamedSharding(mesh, JSpec(None, "data", None)))


def _ensemble_case(rng, D: int, counts, seed: int):
    """Inputs of the 2-D ensemble fit and the JAX result: D = 1 through
    ``fit_ensemble`` itself, D > 1 through its ``vmap`` over directions."""
    vox, acq = _shardings()
    A, P, steps, seg = max(counts), SIDE * SIDE, 5, 2
    pix = np.zeros((D, A, P, 1), np.float32)
    w = np.zeros((D, A, P, 1), np.float32)
    valid = np.zeros((D, A), bool)
    for d, n in enumerate(counts):
        pix[d, :n] = rng.uniform(-1, 1, size=(n, P, 1))
        w[d, :n] = rng.uniform(size=(n, P, 1)) > 0.2
        valid[d, :n] = True
    coords, coords_s = jmgrid((SIDE, SIDE)), jmgrid((2 * SIDE, 2 * SIDE))
    model = JSiren(hidden_features=16, hidden_layers=1, out_features=1)
    keys = jax.random.split(jax.random.key(seed), D)
    stack = jax.vmap(lambda k: model.init(k, coords[:4]))(keys)
    init = [w_.numpy() for w_ in convert.siren_batched_weights(_np(stack))]
    tx = optax.adam(1e-3)
    c, cs = jax.device_put(coords, vox), jax.device_put(coords_s, vox)

    def one(params, p, ww, ok):
        return jeng.fit_ensemble(model.apply, tx, params, c, p, ww, c, cs, total_steps=steps,
                                 seg=seg, valid=ok)

    if D == 1:
        ref = one(jax.tree.map(lambda a: a[0], stack), jax.device_put(pix[0], acq),
                  jax.device_put(w[0], acq), None)
        ref = jax.tree.map(lambda a: np.asarray(a)[None], ref)
        losses = np.asarray(ref.losses)[0][:, None]
    else:
        ref = jax.vmap(one)(stack, jax.device_put(pix, NamedSharding(vox.mesh, JSpec(
            None, None, "data", None))), jax.device_put(w, NamedSharding(vox.mesh, JSpec(
                None, None, "data", None))), jnp.asarray(valid))
        losses = np.asarray(ref.losses).T
    want = {"params": [a.numpy() for a in convert.siren_batched_weights(_np(ref.params))],
            "losses": losses, "pred_1x": np.asarray(ref.pred_1x),
            "pred_scale": np.asarray(ref.pred_scale)}
    inp = dict(hidden=16, layers=1, init=init, coords=np.asarray(coords),
               coords_s=np.asarray(coords_s), pixels=pix, weights=w, valid=valid, steps=steps,
               seg=seg, lr=1e-3)
    return inp, want


def _alternating_case(rng):
    vox, acq = _shardings()
    P = SIDE * SIDE
    B = (rng.normal(size=(8, 2)) * 0.5).astype(np.float32)
    coords = jmgrid((SIDE, SIDE))
    ff = jff(coords, jnp.asarray(B))
    target = rng.uniform(0, 1, size=(P, 1)).astype(np.float32)
    acq_pix = rng.uniform(0, 1, size=(3, P, 1)).astype(np.float32)
    inr = JSiren(hidden_features=32, hidden_layers=1)
    inr_p = inr.init(jax.random.key(1), ff[:4])
    pn = JPerturbNet(hidden_features=16, dimension=2)
    pn_p = pn.init(jax.random.key(2), ff[:4], 0, 0.0)
    inp = dict(inr=[w.numpy() for w in convert.siren_weights(_np(inr_p))],
               pn=[w.numpy() for w in convert.perturbnet_state_dict(_np(pn_p)).values()],
               ff=np.asarray(ff), target=target, acq=acq_pix, B=B, epochs=6, pn_epochs=4,
               inr_lr=1e-3, pn_lr=1e-3)
    ref = jeng.fit_alternating_pn(
        inr.apply, pn.apply, optax.adam(1e-3), optax.adam(1e-3), inr_p, pn_p,
        jax.device_put(ff, vox), jax.device_put(jnp.asarray(target), vox),
        jax.device_put(jnp.asarray(acq_pix), acq), jnp.asarray(B), num_epochs=6, pn_epochs=4)
    want = {"inr": [w.numpy() for w in convert.siren_weights(_np(ref.inr_params))],
            "pn": [w.numpy() for w in convert.perturbnet_state_dict(_np(ref.pn_params)).values()],
            "losses": np.asarray(ref.losses)}
    return inp, want


LR = 3e-3


def _keys(seed, n):
    """fit_until's key sequence: the init key, then one per loop step."""
    key, sub = jax.random.split(jax.random.key(seed))
    subs = [sub]
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return jax.random.key(seed), subs


def _threshold(jmodel, params, coords, target, first: int, steps: int):
    """A threshold 0.1% above the loss of the first step after ``first``
    that sets a new minimum by 1%, from a plain loop of fit_until's body:
    the stop is well away from a tie. Returns (threshold, that step)."""
    apply_fn, _ = jeng.plain_apply_init(jmodel)
    tx = optax.adam(LR)
    state = tx.init(params)
    vg = jax.jit(jax.value_and_grad(lambda p: jnp.mean((apply_fn(p, coords) - target) ** 2)))
    trace = []
    for _ in range(steps):
        loss, g = vg(params)
        upd, state = tx.update(g, state)
        params = optax.apply_updates(params, upd)
        trace.append(float(loss))
    k = next(i for i in range(first, steps) if trace[i] < 0.99 * min(trace[:i]))
    return trace[k] * 1.001, k


def _until_cases():
    vox, _ = _shardings()
    jmodel = JSirenERD(hidden_features=16, hidden_layers=1, perturb=True)
    yy, xx = np.mgrid[0:SIDE, 0:SIDE] / (SIDE - 1)
    target = (0.3 + 0.5 * np.exp(-((xx - 0.4) ** 2 + (yy - 0.6) ** 2) / 0.1))
    target = target.reshape(-1, 1).astype(np.float32)
    coords = jmgrid((SIDE, SIDE))
    c, t = jax.device_put(coords, vox), jax.device_put(jnp.asarray(target), vox)
    base = dict(hidden=16, layers=1, coords=np.asarray(coords), target=target, lr=LR,
                max_steps=500)
    apply_fn, init_fn = jeng.plain_apply_init(jmodel)
    inp, want = {}, {}
    other = [_sd(jmodel.init(jax.random.key(90 + i), jnp.zeros((1, 2)), 0.0, 0.0))
             for i in range(2)]

    key, subs = _keys(7, 0)
    p0 = jmodel.init(subs[0], jnp.zeros((1, 2)), 0.0, 0.0)
    thr, k = _threshold(jmodel, p0, coords, jnp.asarray(target), 20, 80)
    jp, jsteps, jloss = jeng.fit_until(apply_fn, optax.adam(LR), init_fn, key, c, t,
                                       loss_threshold=thr, max_steps=500)
    inp["stop"] = dict(base, threshold=thr, inits=[_sd(p0)], other_inits=other[:1])
    want["stop"] = dict(steps=int(jsteps), k=k, loss=float(jloss), restarts=[],
                        params=[w.detach().numpy() for w in _port_trunk(_sd(jp))])

    # the first draw's last bias -10 collapses the ReLU output to 0
    key, subs = _keys(3, 1)
    first = jax.random.key_data(subs[0])

    def init_collapse(k):
        p = jmodel.init(k, jnp.zeros((1, 2)), 0.0, 0.0)
        inner = p["params"]
        bias = jnp.where(jnp.all(jax.random.key_data(k) == first), -10.0,
                         inner["Dense_1"]["bias"])
        return {"params": {**inner, "Dense_1": {**inner["Dense_1"], "bias": bias}}}

    p_after = jmodel.init(subs[1], jnp.zeros((1, 2)), 0.0, 0.0)
    thr, k = _threshold(jmodel, p_after, coords, jnp.asarray(target), 10, 60)
    jp, jsteps, jloss = jeng.fit_until(apply_fn, optax.adam(LR), init_collapse, key, c, t,
                                       loss_threshold=thr, max_steps=500)
    inp["collapse"] = dict(base, threshold=thr, inits=[_sd(init_collapse(subs[0])),
                                                       _sd(p_after)], other_inits=other)
    want["collapse"] = dict(steps=int(jsteps), k=k + 1, loss=float(jloss), restarts=[1],
                            params=[w.detach().numpy() for w in _port_trunk(_sd(jp))])
    return inp, want


def _port_trunk(sd: dict) -> list:
    from mri_super_resolution_tpu_torch.models import SirenERD

    m = SirenERD(2, 16, 1, perturb=True)
    m.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return m.weights()


@pytest.fixture(scope="module")
def inputs():
    """Every case's inputs and the JAX package's results under the mesh."""
    rng = np.random.default_rng(0)
    inp, ref = {"ensemble": {}}, {}
    for key, D, counts, seed in (("d1", 1, (3,), 4), ("d3", 3, (3, 1, 2), 5)):
        inp["ensemble"][key], ref[f"ensemble_{key}"] = _ensemble_case(rng, D, counts, seed)
    inp["alternating"], ref["alternating"] = _alternating_case(rng)
    inp["until"], until = _until_cases()
    for key, want in until.items():
        ref[f"until_{key}"] = want
    return inp, ref


@pytest.fixture(scope="module")
def ranks(inputs):
    """The worker's results on each of the 2 ranks."""
    import _torch_sharded_fits_worker as worker

    return spawn_ranks(worker.run_all, RANKS, inputs[0], timeout=300)


def _close(got, want, what: str) -> None:
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL, err_msg=what)


def _pred_close(got, want) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_REL * np.abs(want).max())


def _equal(a: dict, b: dict) -> None:
    """Two results bit-equal, key by key."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y)), k
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["d1", "d3"])
def test_sharded_ensemble_matches_jax(ranks, inputs, case, route):
    """One direction of three acquisitions, and three directions of 3, 1 and
    2 (padded slots masked): 32 rows a rank, both eval grids sharded and
    gathered; against ``fit_ensemble`` (``vmap``-ed for three) on 8
    devices."""
    want = inputs[1][f"ensemble_{case}"]
    for r in ranks:
        got = r[f"ensemble_{case}_{route}"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=LOSS_ATOL)
        _close(got["params"], want["params"], "params")
        assert got["pred_1x"].shape == want["pred_1x"].shape
        assert got["pred_scale"].shape == want["pred_scale"].shape
        _pred_close(got["pred_1x"], want["pred_1x"])
        _pred_close(got["pred_scale"], want["pred_scale"])
    _equal(ranks[0][f"ensemble_{case}_{route}"], ranks[1][f"ensemble_{case}_{route}"])


@pytest.mark.parametrize("route", ROUTES)
def test_sharded_ensemble_keeps_padded_slots(ranks, inputs, route):
    """A padded slot leaves its direction's Adam count (and, by the ranks'
    bit-equal moments, its moments) alone on every rank: the directions of
    3, 1 and 2 acquisitions took 3, 1 and 2 updates a step."""
    steps = inputs[0]["ensemble"]["d3"]["steps"]
    for r in ranks:
        assert r[f"ensemble_d3_{route}"]["count"].tolist() == [3 * steps, steps, 2 * steps]


@pytest.mark.parametrize("route", ROUTES)
def test_sharded_alternating_matches_jax(ranks, inputs, route):
    """Six epochs, the last four alternating (two PN epochs of three
    acquisitions each), the double Fourier mapping kept: the mean steps'
    K1 (or autograd) and the PN steps' forward and backward on each rank's
    rows, reduced before every step."""
    want = inputs[1]["alternating"]
    for r in ranks:
        got = r[f"alternating_{route}"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=LOSS_ATOL)
        _close(got["inr"], want["inr"], "inr")
        _close(got["pn"], want["pn"], "pn")
        # the PN moved: its gradient reached it through the INR's input
        assert all(not np.array_equal(a, b) for a, b in zip(got["pn"],
                                                            inputs[0]["alternating"]["pn"]))
    _equal(ranks[0][f"alternating_{route}"], ranks[1][f"alternating_{route}"])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["stop", "collapse"])
def test_sharded_fit_until_matches_jax(ranks, inputs, case, route):
    """The stop at JAX's step; with the collapsing first draw, a restart
    after step 1 on both ranks, though rank 1's own first draw does not
    collapse: the draws are rank 0's."""
    want = inputs[1][f"until_{case}"]
    for r in ranks:
        got = r[f"until_{case}_{route}"]
        assert got["steps"] == want["steps"] == want["k"] + 1
        assert got["restarts"] == want["restarts"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=LOSS_ATOL)
        _close(got["params"], want["params"], "params")
    _equal(ranks[0][f"until_{case}_{route}"], ranks[1][f"until_{case}_{route}"])


def test_unequal_shards_are_refused(ranks):
    """32 rows on rank 0 and 31 on rank 1: both ranks raise, naming the
    counts."""
    for r in ranks:
        assert r["unequal"] is not None and "[32, 31]" in r["unequal"]


def test_an_indivisible_batch_is_refused():
    """63 rows do not shard over 2 ranks: ``shard_batch`` raises, naming
    both numbers (a NamedSharding refuses it too), and nothing pads."""
    from mri_super_resolution_tpu_torch.parallel import Mesh

    mesh = Mesh(("case", "data"), (1, 2), (0, 1), 0, {})  # rank 0's view of 2 ranks
    with pytest.raises(ValueError, match=r"63.*\(2\)"):
        shard_batch(torch.zeros(63, 2), mesh)
    vox, _ = _shardings()
    with pytest.raises(ValueError):
        jax.device_put(jnp.zeros((63, 2)), vox)


# ---------------------------------------------------------------------------
# one process: no mesh, mesh=None and a mesh of one are the same call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_ensemble_one_process(inputs, route):
    import _torch_sharded_fits_worker as worker

    d, want = inputs[0]["ensemble"]["d3"], inputs[1]["ensemble_d3"]
    bare = worker.run_ensemble(d, route, None)
    one = worker.run_ensemble(d, route, make_mesh())
    _equal(bare, one)
    np.testing.assert_allclose(bare["losses"], want["losses"], rtol=0, atol=LOSS_ATOL)
    _pred_close(bare["pred_scale"], want["pred_scale"])


@pytest.mark.parametrize("route", ROUTES)
def test_alternating_one_process(inputs, route):
    import _torch_sharded_fits_worker as worker

    d, want = inputs[0]["alternating"], inputs[1]["alternating"]
    bare = worker.run_alternating(d, route, None)
    _equal(bare, worker.run_alternating(d, route, make_mesh()))
    np.testing.assert_allclose(bare["losses"], want["losses"], rtol=0, atol=LOSS_ATOL)
    _close(bare["pn"], want["pn"], "pn")


@pytest.mark.parametrize("route", ROUTES)
def test_fit_until_one_process(inputs, route):
    import _torch_sharded_fits_worker as worker

    d, want = inputs[0]["until"]["collapse"], inputs[1]["until_collapse"]
    bare = worker.run_until(d, route, None, d["inits"])
    _equal(bare, worker.run_until(d, route, make_mesh(), d["inits"]))
    assert bare["steps"] == want["steps"] and bare["restarts"] == [1]
    _close(bare["params"], want["params"], "params")


def test_mesh_none_is_the_call_without_a_mesh(inputs):
    """``mesh=None`` passed explicitly: bit-equal to leaving it out."""
    from mri_super_resolution_tpu_torch.fit.engine import fit_until, plain_apply_init
    from mri_super_resolution_tpu_torch.models import SirenERD

    d = inputs[0]["until"]["stop"]
    runs = []
    for kw in ({}, {"mesh": None}):
        m = SirenERD(2, 16, 1, perturb=True)
        m.load_state_dict({k: torch.as_tensor(v) for k, v in d["inits"][0].items()})
        apply_fn, _ = plain_apply_init(m)
        runs.append(fit_until(apply_fn, LR, lambda k: m.weights(), torch.tensor(d["coords"]),
                              torch.tensor(d["target"]), d["threshold"], 500, **kw))
    assert runs[0].losses == runs[1].losses and runs[0].steps == runs[1].steps
    assert all(torch.equal(a, b) for a, b in zip(runs[0].params, runs[1].params))
