"""K7 (the RAMS conv's backward) and the weight norm's closed-form backward
against the JAX package: K7's plain version against the Pallas
``conv3d_rfab_bwd`` in interpret mode (as ``tests/test_conv3d_kernel.py``
runs it), the trainable ``autograd.Function`` against autograd through the
plain K6, and ``weight_norm_kernel``'s gradients against ``jax.vjp``.

On CPU tensors the wrappers run their plain versions; the CUDA kernel runs
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``) and under the
CPU emulation (``tests/test_torch_cuda_emulated.py``). Inputs come from a
numpy seed.

Tolerances: float32, the JAX package's own for its K7 (rtol 2e-4, atol
2e-5); bfloat16 dx within one bf16 ulp (both round float32 sums of the same
bf16 products once), dW and db as float32 (exact products summed in float32
in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.models import rams as jrams
from mri_super_resolution_tpu.ops.pallas.conv3d_kernel import conv3d_rfab_bwd as jbwd
from mri_super_resolution_tpu_torch.models import rams as trams
from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

torch.set_num_threads(2)

BWD_CASES = [
    ((1, 6, 5, 3, 32), 32, "SAME"),  # the JAX package's gradient test shape
    ((1, 8, 7, 3, 8), 8, "SAME"),  # C 8, H != W
    ((1, 7, 6, 4, 32), 32, "VALID"),  # the temporal-reduction convs
    ((1, 5, 8, 4, 8), 16, "VALID"),  # C != Cout
]


def _problem(shape, cout, padding, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, shape[-1], cout)) * 0.1).astype(np.float32)
    g = rng.normal(size=(*ck.out_shape(shape, padding), cout)).astype(np.float32)
    return x, k, g


def _one_ulp(ref: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cout,padding", BWD_CASES)
def test_k7_plain_matches_pallas(shape, cout, padding, dtype):
    x, k, g = _problem(shape, cout, padding, seed=sum(shape) + cout)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cd = jnp.bfloat16 if dtype == "bfloat16" else None
    xj = jnp.asarray(x).astype(jdt)
    ref = [np.asarray(a).astype(np.float32) for a in jbwd(
        xj, jnp.asarray(k), jnp.asarray(g).astype(jdt), padding, interpret=True,
        compute_dtype=cd)]
    tdt = getattr(torch, dtype)
    ck.reset_launches()
    dx, dw, db = ck.conv3d_rfab_bwd(torch.as_tensor(x).to(tdt), torch.as_tensor(k),
                                    torch.as_tensor(g).to(tdt), padding)
    assert ck.LAUNCHES["conv3d_rfab_bwd"] == 0  # CPU tensors: the plain version
    assert dx.dtype == tdt and dw.dtype == db.dtype == torch.float32
    assert dx.shape == shape and dw.shape == k.shape and db.shape == (cout,)
    for got, want, name in ((dw, ref[1], "dkernel"), (db, ref[2], "dbias")):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5, err_msg=name)
    dx = dx.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(dx, ref[0], rtol=2e-4, atol=2e-5, err_msg="dx")
    else:
        assert (np.abs(dx - ref[0]) <= _one_ulp(ref[0])).all()


def test_k7_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 3, 8)
    k = torch.zeros(3, 3, 3, 8, 8)
    with pytest.raises(ValueError, match="g must be"):
        ck.conv3d_rfab_bwd(x, k, torch.zeros(1, 4, 4, 3, 16))
    with pytest.raises(ValueError, match="g must be"):
        ck.conv3d_rfab_bwd(x, k, torch.zeros(1, 4, 4, 3, 8), "VALID")
    with pytest.raises(ValueError, match="multiples of 8"):
        ck.conv3d_rfab_bwd(torch.zeros(1, 4, 4, 3, 4), torch.zeros(3, 3, 3, 4, 8),
                           torch.zeros(1, 4, 4, 3, 8))
    with pytest.raises(TypeError):
        ck.conv3d_rfab_bwd(x.double(), k, torch.zeros(1, 4, 4, 3, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_trainable_function_matches_autograd_through_plain_k6(padding, dtype):
    """conv3d_rfab_trainable (K6 forward, K7 backward, plain on the CPU)
    against autograd through ``conv3d_rfab_ref``. float32: the same sums in
    another order. bfloat16: autograd rounds the kernel's and the
    activations' gradients to bf16 on their way back through the casts,
    K7 keeps dkernel in float32, so within one bf16 ulp of the largest."""
    x, k, g = _problem((2, 6, 7, 5, 16), 8, padding, seed=11)
    tdt = getattr(torch, dtype)
    b = torch.as_tensor(np.random.default_rng(12).normal(size=8).astype(np.float32))
    xs = [torch.as_tensor(x).to(tdt), torch.as_tensor(k), b]
    leaves = [t.clone().requires_grad_() for t in xs]
    out = ck.conv3d_rfab_trainable(*leaves, padding)
    got = torch.autograd.grad(out, leaves, torch.as_tensor(g).to(tdt))
    ref_leaves = [t.clone().requires_grad_() for t in xs]
    ref_out = ck.conv3d_rfab_ref(*ref_leaves, padding)
    want = torch.autograd.grad(ref_out, ref_leaves, torch.as_tensor(g).to(tdt))
    assert torch.equal(out, ref_out)
    for a, w, name in zip(got, want, ("dx", "dkernel", "dbias")):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        scale = float(w.float().abs().max())
        tol = 2e-6 if dtype == "float32" else 2.0 ** -8
        torch.testing.assert_close(a.float(), w.float(), rtol=0, atol=tol * scale, msg=name)


def test_trainable_function_under_no_grad_is_k6_alone():
    x, k, _ = _problem((1, 5, 5, 3, 8), 8, "SAME", seed=3)
    xt = torch.as_tensor(x).requires_grad_()
    with torch.no_grad():
        out = ck.conv3d_rfab_trainable(xt, torch.as_tensor(k), torch.zeros(8))
    assert not out.requires_grad


@pytest.mark.parametrize("shape", [(3, 3, 3, 8, 16), (3, 3, 9, 9), (1, 1, 1, 32, 4)])
def test_weight_norm_gradients_match_jax(shape):
    """The closed-form backward (dg = sum(dw v_hat), dv = (g / n)(dw - v_hat
    dg)) against jax.vjp through the JAX package's custom-VJP weight norm."""
    rng = np.random.default_rng(sum(shape))
    v = rng.normal(size=shape).astype(np.float32)
    g = rng.uniform(0.5, 2.0, size=shape[-1]).astype(np.float32)
    dw = rng.normal(size=shape).astype(np.float32)
    w_j, vjp = jax.vjp(jrams.weight_norm_kernel, jnp.asarray(v), jnp.asarray(g))
    dv_j, dg_j = vjp(jnp.asarray(dw))
    vt = torch.as_tensor(v).requires_grad_()
    gt = torch.as_tensor(g).requires_grad_()
    w_t = trams.weight_norm_kernel(vt, gt)
    dv_t, dg_t = torch.autograd.grad(w_t, (vt, gt), torch.as_tensor(dw))
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dv_t.numpy(), np.asarray(dv_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dg_t.numpy(), np.asarray(dg_j), rtol=1e-5, atol=1e-6)
