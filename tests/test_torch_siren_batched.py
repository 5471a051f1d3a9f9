"""The port's batched K1 (``siren_loss_grads_batched``: D stacked MLPs on one
x) against ``jax.vmap`` over the JAX package's Pallas ``siren_loss_grads``,
the form the JAX package's 2-D ensemble and hybrid fit run.

On CPU tensors the wrapper runs its plain batched version (``einsum``/``bmm``
over the stacked weights); the JAX kernel runs in Pallas interpret mode
under ``vmap``, which adds a batch axis to its grid. Cases: D = 4 at 256 ->
256x2 -> 1 on 300 rows with a ragged ``n_rows`` (the hybrid's class of
widths), and D = 3 at 2 -> 16x2 -> 1 with sample weights (the 2-D
ensemble's). Tolerances are ``tests/test_torch_siren_kernel.py``'s, the JAX
package's own kernel-vs-autodiff ones: loss rtol 1e-4, dW atol 5e-4 (the JAX
kernel stashes activations in bf16); the plain version with that same stash
(``stash="bf16"``, what ``csrc/siren_wg.cu`` computes on the card) is held
to dW atol 5e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.ops.pallas import siren_kernel as jk
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.fit.optim import StackedAdam
from mri_super_resolution_tpu_torch.models import Siren
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

LOSS_RTOL, DW_ATOL, FWD_ATOL = 1e-4, 5e-4, 2e-4
DW_BF16_ATOL = 5e-5  # the plain version with the Pallas kernel's own stash


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(D, P, d_in, hidden, layers, seed):
    """D JAX Sirens drawn by ``jax.vmap(model.init)`` (the 2-D ensemble's
    init), their inputs and targets from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(P, d_in)).astype(np.float32)
    model = JSiren(hidden_features=hidden, hidden_layers=layers)
    keys = jax.random.split(jax.random.key(seed), D)
    stack = jax.vmap(lambda k: model.init(k, jnp.asarray(x[:4])))(keys)
    target = rng.uniform(-1, 1, size=(D, P, 1)).astype(np.float32)
    sw = (rng.uniform(size=(D, P, 1)) > 0.2).astype(np.float32) * rng.uniform(
        0.5, 1.5, size=(D, P, 1)).astype(np.float32)
    return model, stack, x, target, sw


def _jax_batched(stack, x, target, n_rows=None, sw=None):
    """``jax.vmap`` over the interpreted Pallas K1."""
    jws = tuple(jk.weights_from_flax(stack))  # each with a leading D axis

    def one(ws, t, w):
        return jk.siren_loss_grads(jnp.asarray(x), ws, t, n_rows=n_rows, sample_weights=w)

    if sw is None:
        return jax.vmap(lambda ws, t: one(ws, t, None))(jws, jnp.asarray(target))
    return jax.vmap(one)(jws, jnp.asarray(target), jnp.asarray(sw))


def _torch_layout(dws):
    """JAX grads (D, in, out) / (D, out) -> the port's (D, out, in) / (D, out)."""
    return [np.swapaxes(np.asarray(g), 1, 2) if g.ndim == 3 else np.asarray(g) for g in dws]


@pytest.mark.parametrize("n_rows,stash", [(None, "f32"), (271, "f32"), (None, "bf16"),
                                           (271, "bf16")],
                         ids=["None", "271", "None-bf16", "271-bf16"])
def test_batched_k1_matches_vmapped_pallas_hybrid_class(n_rows, stash):
    """D = 4 stacked 256 -> 256x2 -> 1 Sirens (the hybrid fit's class of
    widths), 300 rows (no tile divides them), all rows and a ragged count.
    ``"f32"``: the wrapper on CPU tensors (the plain version's default
    stash), at the file's bars. ``"bf16"``: the plain version with the
    Pallas kernel's own stash (each layer's input bf16 for dW, the sine's
    factor omega * f32(bf16(cos))), what ``csrc/siren_wg.cu`` computes: it
    keeps what the JAX kernel keeps, so only the float32 forward's order of
    sums and the bf16 roundings it flips part the two, and dW is held to
    DW_BF16_ATOL, ten times tighter (measured 2.1e-5 against 2.3e-4 for
    the float32 stash)."""
    _, stack, x, target, _ = _stack(4, 300, 256, 256, 2, seed=0)
    loss_j, dws_j = _jax_batched(stack, x, target, n_rows)
    tws = convert.siren_batched_weights(_np(stack))
    assert [tuple(w.shape) for w in tws] == [(4, 256, 256), (4, 256), (4, 256, 256), (4, 256),
                                             (4, 256, 256), (4, 256), (4, 1, 256), (4, 1)]
    xt, tt = torch.as_tensor(x), torch.as_tensor(target)
    if stash == "f32":
        loss_t, dws_t = tk.siren_loss_grads_batched(xt, tws, tt, n_rows=n_rows)
        # the default stays the float32 one, bit for bit
        loss_f, dws_f = tk.siren_loss_grads_batched_ref(xt, tws, tt, n_rows=n_rows, stash="f32")
        assert torch.equal(loss_t, loss_f) and all(map(torch.equal, dws_t, dws_f))
    else:
        loss_t, dws_t = tk.siren_loss_grads_batched_ref(xt, tws, tt, n_rows=n_rows, stash=stash)
    assert loss_t.shape == (4,)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=LOSS_RTOL)
    for gt, gj in zip(dws_t, _torch_layout(dws_j)):
        assert gt.shape == gj.shape
        np.testing.assert_allclose(gt.numpy(), gj, atol=DW_ATOL if stash == "f32" else DW_BF16_ATOL)


def test_batched_ref_refuses_an_unknown_stash():
    _, stack, x, target, _ = _stack(2, 20, 2, 8, 1, seed=6)
    with pytest.raises(ValueError, match="stash"):
        tk.siren_loss_grads_batched_ref(torch.as_tensor(x),
                                        convert.siren_batched_weights(_np(stack)),
                                        torch.as_tensor(target), stash="bf8")


def test_batched_k1_weighted_matches_vmapped_pallas_2d_class():
    """D = 3 stacked 2 -> 16x2 -> 1 Sirens with sample weights (the 2-D
    ensemble's class), 130 rows."""
    _, stack, x, target, sw = _stack(3, 130, 2, 16, 2, seed=1)
    loss_j, dws_j = _jax_batched(stack, x, target, sw=sw)
    tws = convert.siren_batched_weights(_np(stack))
    loss_t, dws_t = tk.siren_loss_grads_batched(
        torch.as_tensor(x), tws, torch.as_tensor(target),
        sample_weights=torch.as_tensor(sw))
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=LOSS_RTOL)
    for gt, gj in zip(dws_t, _torch_layout(dws_j)):
        np.testing.assert_allclose(gt.numpy(), gj, atol=DW_ATOL)


def test_batched_forward_matches_vmapped_flax():
    model, stack, x, _, _ = _stack(3, 90, 2, 16, 2, seed=2)
    want = jax.vmap(lambda p: model.apply(p, jnp.asarray(x)))(stack)
    got = tk.siren_forward_batched_ref(torch.as_tensor(x),
                                       convert.siren_batched_weights(_np(stack)))
    assert got.shape == (3, 90, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_batched_slots_are_unbatched_calls(weighted):
    """Each slot of the batched plain K1 is the unbatched plain K1 of its
    inputs (float32 in another order: within 1e-6 of the largest magnitude),
    also for weights that are slot-strided views of one parameter buffer (a
    StackedAdam's), with a masked row count."""
    _, stack, x, target, sw = _stack(3, 70, 2, 16, 2, seed=3)
    ws = StackedAdam(convert.siren_batched_weights(_np(stack)), 1e-4).params
    assert not ws[0].is_contiguous()
    xt, tt, st = torch.as_tensor(x), torch.as_tensor(target), torch.as_tensor(sw)
    kw = {"sample_weights": st} if weighted else {}
    loss, grads = tk.siren_loss_grads_batched(xt, ws, tt, n_rows=61, **kw)
    for s in range(3):
        ls, gs = tk.siren_loss_grads(xt, [w[s] for w in ws], tt[s], n_rows=61,
                                     sample_weights=st[s] if weighted else None)
        torch.testing.assert_close(loss[s], ls, rtol=1e-6, atol=0)
        for a, b in zip(grads, gs):
            assert float((a[s] - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_batched_adapters_on_the_cpu_launch_nothing():
    """The adapters run the plain version on CPU tensors and count no
    launch; slot s of the weighted adapter is the unbatched adapter's."""
    gen = torch.Generator().manual_seed(4)
    models = [Siren(2, 16, 2, generator=gen) for _ in range(3)]
    for m in models:
        m.requires_grad_(False)
    ws = [torch.stack(t) for t in zip(*(m.weights() for m in models))]
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.uniform(-1, 1, (50, 2)).astype(np.float32))
    t = torch.as_tensor(rng.uniform(-1, 1, (3, 50, 1)).astype(np.float32))
    sw = torch.as_tensor(rng.uniform(0, 1, (3, 50, 1)).astype(np.float32))
    tk.reset_launches()
    loss, grads = tk.make_fused_weighted_value_and_grad_batched(models[0])(ws, x, t, sw)
    loss_u, grads_u = tk.make_fused_value_and_grad_batched(models[0])(ws, x, t)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    for s, m in enumerate(models):
        ls, gs = tk.make_fused_weighted_value_and_grad(m)(m.weights(), x, t[s], sw[s])
        torch.testing.assert_close(loss[s], ls, rtol=1e-6, atol=0)
        lu, _ = tk.make_fused_value_and_grad(m)(m.weights(), x, t[s])
        torch.testing.assert_close(loss_u[s], lu, rtol=1e-6, atol=0)
        for a, b in zip(grads, gs):
            assert a[s].shape == b.shape


def test_batched_wrapper_refuses_what_the_kernels_do_not_take():
    _, stack, x, target, sw = _stack(2, 20, 2, 8, 1, seed=5)
    ws = convert.siren_batched_weights(_np(stack))
    xt, tt = torch.as_tensor(x), torch.as_tensor(target)
    with pytest.raises(ValueError, match="target must be"):
        tk.siren_loss_grads_batched(xt, ws, tt[0])
    with pytest.raises(ValueError, match="sample_weights must be"):
        tk.siren_loss_grads_batched(xt, ws, tt, sample_weights=tt[:1])
    with pytest.raises(ValueError, match="stacked"):
        tk.siren_loss_grads_batched(xt, [ws[0], ws[1][:1], *ws[2:]], tt)
    with pytest.raises(ValueError, match="n_rows"):
        tk.siren_loss_grads_batched(xt, ws, tt, n_rows=21)
    with pytest.raises(TypeError):
        tk.siren_loss_grads_batched(xt.double(), ws, tt)
    with pytest.raises(ValueError, match="contiguous"):
        tk.siren_loss_grads_batched(xt, [*ws[:2], ws[2].transpose(1, 2), *ws[3:]], tt)
