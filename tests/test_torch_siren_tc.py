"""K1-K3's tensor-core route on the CPU: which calls take it, the bf16x3
split its operands go through, and the plain versions it is held against on
the card, compared with the JAX package's Pallas kernels at a width of its
class.

The route itself (``csrc/siren_wg.cu``) runs here under the CUDA emulation
(``tests/test_torch_cuda_emulated_siren_tc.py`` for K1,
``tests/test_torch_cuda_emulated_siren_tc_fwd.py`` for K3 and K2) and on
the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.models import Siren as JSiren
from mri_super_resolution_tpu.ops.pallas import siren_kernel as jk
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.models import Siren, SirenERD
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

SIREN_ACTS = lambda n_hidden: ("sine",) * n_hidden + ("none",)


@pytest.mark.parametrize("dims,acts,weighted,absmax,route", [
    # the 3-D pipeline's reference SIREN: 128 Fourier mappings -> 512x4 -> 1
    ((256, 512, 512, 512, 512, 1), SIREN_ACTS(4), False, False, True),
    ((128, 128, 1), SIREN_ACTS(1), False, False, True),
    ((256, 384, 128, 1), SIREN_ACTS(2), False, False, True),
    # K1-w: the 2-D ensemble's Siren 2 -> 64x7 -> 1 with sample weights
    ((2,) + (64,) * 7 + (1,), SIREN_ACTS(7), True, False, False),
    # K1-a: the soft-ERD trunk, ReLU codes and max |out|
    ((2, 128, 128, 128, 128, 128, 1), ("sine",) * 4 + ("relu", "relu"), False, True, False),
    # the flagship's widths with either option, or ReLU codes
    ((256, 512, 512, 1), SIREN_ACTS(2), True, False, False),
    ((256, 512, 512, 1), SIREN_ACTS(2), False, True, False),
    ((256, 512, 512, 1), ("sine", "relu", "none"), False, False, False),
    ((256, 512, 512, 1), ("sine", "sine", "relu"), False, False, False),
    # widths off the 128 tile: the small patient's 32 -> 32 -> 1, odd widths
    ((32, 32, 1), SIREN_ACTS(1), False, False, False),
    ((256, 500, 1), SIREN_ACTS(1), False, False, False),
    ((100, 128, 1), SIREN_ACTS(1), False, False, False),
    # the kernel's limits: the last hidden width at most 2,048, at most 16 layers
    ((256, 2048, 1), SIREN_ACTS(1), False, False, True),
    ((256, 2176, 1), SIREN_ACTS(1), False, False, False),
    ((256, 2176, 512, 1), SIREN_ACTS(2), False, False, True),
    ((128,) * 16 + (1,), SIREN_ACTS(15), False, False, True),
    ((128,) * 17 + (1,), SIREN_ACTS(16), False, False, False),
])
def test_route_rule(dims, acts, weighted, absmax, route):
    """The route is chosen from the shapes and options alone."""
    assert tk.tc_route(dims, acts, weighted, absmax) is route


@pytest.mark.parametrize("dims,acts,route", [
    # the 3-D pipeline's K3 (inference chunks, PerturbNet forward) and K2
    # (PerturbNet backward) at the reference SIREN
    ((256, 512, 512, 512, 512, 1), SIREN_ACTS(4), True),
    ((256, 128, 1), SIREN_ACTS(1), True),
    ((128, 256, 128, 1), SIREN_ACTS(2), True),
    # SirenERD's trunk: ReLU codes stay on the SIMT K2/K3
    ((2, 128, 128, 128, 128, 128, 1), ("sine",) * 4 + ("relu", "relu"), False),
    ((256, 512, 512, 1), ("sine", "relu", "none"), False),
    ((256, 512, 512, 1), ("sine", "sine", "relu"), False),
    # the 2-D ensemble's 64-wide Siren, the small patient's, odd widths
    ((2,) + (64,) * 7 + (1,), SIREN_ACTS(7), False),
    ((32, 32, 1), SIREN_ACTS(1), False),
    ((256, 500, 1), SIREN_ACTS(1), False),
    ((100, 128, 1), SIREN_ACTS(1), False),
    ((128, 128, 2), SIREN_ACTS(1), False),
])
def test_route_rule_k2_k3(dims, acts, route):
    """K2 and K3 take the route by the same rule as K1, from the shapes and
    activations alone (they have no sample weights or max |out|)."""
    assert tk.tc_route(dims, acts) is route


def test_route_of_the_models():
    """The port's models: the 3-D pipeline's Siren at its reference widths
    takes the tensor-core route; the 2-D ensemble's Siren 64x6 and the
    soft-ERD SirenERD trunk stay off it (K1 of both takes the streaming
    route, K2 and K3 the SIMT kernels)."""
    def dims_of(model, d_in):
        ws = model.weights()
        return (d_in,) + tuple(int(w.shape[0]) for w in ws[0::2])

    ref = Siren(256, 512, 3)
    assert tk.tc_route(dims_of(ref, 256), ref.acts)
    master = Siren(2, 64, 6)
    assert not tk.tc_route(dims_of(master, 2), master.acts, weighted=True)
    erd = SirenERD(2, 128, 3)
    assert not tk.tc_route(dims_of(erd, 2), erd.acts, absmax=True)


@pytest.mark.parametrize("dims,route", [
    ((2,) + (64,) * 7 + (1,), "stream"),  # K1-w: the 2-D ensemble's Siren 2 -> 64x7 -> 1
    ((32, 32, 1), "simt"),  # the small patient's
    ((3, 10, 7, 1), "simt"), ((2,) + (72,) * 7 + (1,), "simt"),
    ((2, 128, 128, 128, 128, 128, 1), "stream"),  # K1-a: the soft-ERD trunk
    ((256, 512, 512, 512, 512, 1), "wg"),  # the flagship
    ((2,) + (80,) * 7 + (1,), "simt"),
    ((2,) + (4,) * 17 + (1,), "simt"),  # more layers than any hand route's plan holds
])
def test_k1_route_rule(dims, route):
    """K1's route from the widths alone, plain Siren codes, no options:
    the tensor-core route at its widths, the streaming route at equal
    hidden widths of a multiple of 64, the SIMT route, which takes any
    widths, for the rest; with sample weights (K1-w) the tensor-core
    route's widths go to the SIMT route too."""
    acts = SIREN_ACTS(len(dims) - 2)
    assert tk.k1_route(dims, acts) == route
    assert tk.k1_route(dims, acts, weighted=True) == ("simt" if route == "wg" else route)


@pytest.mark.parametrize("dims,route", [
    ((2, 128, 128, 128, 128, 128, 1), True),  # K1-a: the soft-ERD trunk 2 -> 128x4 -> 128 -> 1
    ((2, 64, 64, 1), True), ((3,) + (128,) * 15 + (1,), True),
    ((256, 512, 512, 512, 512, 1), False),  # the flagship: 512 is over one block's plan
    ((2, 192, 192, 1), False),  # 192 needs 257,536 bytes of shared memory
    ((2, 96, 96, 1), False),  # not a multiple of 64
    ((2, 128, 64, 1), False),  # unequal hidden widths
    ((2, 64, 1), False),  # no hidden layer on the tensor cores
    ((2,) + (64,) * 16 + (1,), False),  # more layers than the kernel's plan holds
])
def test_stream_route_rule(dims, route):
    """K1's streaming route is chosen from the widths alone: equal hidden
    widths of a multiple of 64 whose plan fits one block's shared memory;
    the plan of K1-a's widths is 175,616 bytes of the H100's 232,448."""
    assert tk.stream_route(dims) is route
    assert tk.stream_smem_bytes((2, 128, 128, 128, 128, 128, 1)) == 175_616


def test_k1_route_order_of_the_models():
    """The routes in order: the 3-D pipeline's Siren takes the tensor-core
    route, the 2-D ensemble's Siren the streaming one, and so does the soft-ERD
    SirenERD trunk with max |out| (K1-a) the streaming one, with or without
    sample weights; widths no hand route takes keep the SIMT kernels."""
    def dims_of(model, d_in):
        return (d_in,) + tuple(int(w.shape[0]) for w in model.weights()[0::2])

    ref, master, erd = Siren(256, 512, 3), Siren(2, 64, 6), SirenERD(2, 128, 3)
    assert tk.k1_route(dims_of(ref, 256), ref.acts) == "wg"
    assert tk.k1_route(dims_of(master, 2), master.acts, weighted=True) == "stream"
    for weighted in (False, True):
        assert tk.k1_route(dims_of(erd, 2), erd.acts, weighted, absmax=True) == "stream"
    assert tk.k1_route((2, 192, 192, 1), ("sine", "sine", "none")) == "simt"
    assert tk.loss_grads_key(False, True, "stream") == "siren_loss_grads_absmax_stream"
    assert tk.loss_grads_key(True, True, "stream") in tk.LAUNCHES


def test_k1a_wrapper_sends_a_card_call_to_the_streaming_route(monkeypatch):
    """The wrapper's dispatch for a CUDA tensor (the launch itself stubbed
    out, this machine has no card): K1-a at SirenERD's widths goes to the
    streaming launch and counts one under its ``_stream`` key, no other."""
    model = SirenERD(2, 128, 3)
    ws, acts = [w.detach() for w in model.weights()], model.acts
    x, t = torch.zeros(300, 2), torch.zeros(300, 1)
    calls = []
    monkeypatch.setattr(tk, "_check", lambda *a: "cuda")
    monkeypatch.setattr(tk, "_stream_lib", lambda: "stream-lib")
    monkeypatch.setattr(tk._build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(tk, "_launch_loss_grads_slots",
                        lambda route, lib, *a: calls.append((route, lib)) or "out")
    tk.reset_launches()
    assert tk.siren_loss_grads(x, ws, t, acts=acts, with_out_absmax=True) == "out"
    assert calls == [("stream", "stream-lib")]
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES}, "siren_loss_grads_absmax_stream": 1}
    tk.reset_launches()


@pytest.fixture
def card_stubs(monkeypatch):
    """The wrappers' card path on this machine: every tensor taken for a
    CUDA one, a fresh plan cache, and every library a stub whose workspace
    queries take any widths and whose launches record the spans open
    around them; yields that record, (entry, open spans) a launch."""
    opened, calls = [], []

    class Span:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            opened.append(self.name)

        def __exit__(self, *exc):
            opened.pop()

    class Lib:
        def __getattr__(self, name):
            if name.endswith(("_bytes", "_floats")):
                return lambda *a: 256
            if name.endswith("_setup"):
                return lambda: 0
            return lambda *a: calls.append((name, tuple(opened))) or 0

    lib = Lib()
    monkeypatch.setattr(tk._build, "check_tensors", lambda *a: "cuda")
    monkeypatch.setattr(tk._build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(tk, "span", Span)
    monkeypatch.setattr(tk, "_PLANS", {})
    for name in ("_lib", "_wg_lib", "_stream_lib", "_rtc_lib"):
        monkeypatch.setattr(tk, name, lambda: lib)
    tk.reset_launches()
    yield calls
    tk.reset_launches()


def _stub_problem(dims, P=10, D=0):
    """Zero inputs of these widths, the weights stacked D deep when D."""
    lead = (D,) if D else ()
    ws = []
    for l in range(len(dims) - 1):
        ws += [torch.zeros(*lead, dims[l + 1], dims[l]), torch.zeros(*lead, dims[l + 1])]
    return torch.zeros(P, dims[0]), ws, torch.zeros(*lead, P, 1)


@pytest.mark.parametrize("dims,weighted,absmax,route,entry", [
    ((128, 128, 1), False, False, "wg", "siren_loss_grads_wg_f32"),
    ((2, 64, 64, 1), True, False, "stream", "siren_loss_grads_stream"),
    ((2, 128, 128, 128, 1), False, True, "stream", "siren_loss_grads_stream"),
    ((3, 10, 7, 1), True, True, "simt", "siren_loss_grads_f32"),
    ((128, 128, 1), True, False, "simt", "siren_loss_grads_f32"),
])
def test_k1_every_route_launches_inside_the_launch_span(card_stubs, dims, weighted, absmax,
                                                        route, entry):
    """The K1 wrapper's dispatch for a CUDA tensor (the libraries stubbed,
    this machine has no card): each route's ctypes call, the streaming and
    the SIMT one too, runs inside ``kernel.launch``; one count under its
    route's key, no other."""
    x, ws, t = _stub_problem(dims)
    acts = SIREN_ACTS(len(dims) - 2)
    assert tk.k1_route(dims, acts, weighted, absmax) == route
    out = tk.siren_loss_grads(x, ws, t, acts=acts, sample_weights=t if weighted else None,
                              with_out_absmax=absmax)
    assert [g.shape for g in out[-1]] == [w.shape for w in ws]
    assert card_stubs == [(entry, ("kernel.launch",))]
    assert tk.LAUNCHES == {**{k: 0 for k in tk.LAUNCHES},
                           tk.loss_grads_key(weighted, absmax, route): 1}


_ENTRY_CALLS = {
    "siren_loss_grads_wg_f32": lambda x, ws, t: tk.siren_loss_grads(x, ws, t),
    "siren_forward_wg": lambda x, ws, t: tk.siren_forward(x, ws),
    "siren_fused_bwd_wg": lambda x, ws, t: tk.siren_fused_bwd(x, ws, t, need_dw=False),
    "siren_fused_bwd_wg+dw": lambda x, ws, t: tk.siren_fused_bwd(x, ws, t),
    "siren_loss_grads_stream": lambda x, ws, t: tk.siren_loss_grads(x, ws, t, sample_weights=t),
    "siren_loss_grads_f32": lambda x, ws, t: tk.siren_loss_grads(x, ws, t),
    "siren_forward_f32": lambda x, ws, t: tk.siren_forward(x, ws),
    "siren_fused_bwd_f32": lambda x, ws, t: tk.siren_fused_bwd(x, ws, t),
    "siren_loss_grads_wg": lambda x, ws, t: tk.siren_loss_grads_batched(x, ws, t),
    "siren_loss_grads_rtc": lambda x, ws, t: tk.siren_loss_grads_batched(x, ws, t,
                                                                         sample_weights=t),
}


@pytest.mark.parametrize("entry,dims,D", [
    ("siren_loss_grads_wg_f32", (128, 128, 1), 0), ("siren_forward_wg", (128, 128, 1), 0),
    ("siren_fused_bwd_wg", (128, 128, 1), 0), ("siren_fused_bwd_wg+dw", (128, 128, 1), 0),
    ("siren_loss_grads_stream", (2, 64, 64, 1), 0), ("siren_loss_grads_f32", (3, 10, 7, 1), 0),
    ("siren_forward_f32", (3, 10, 7, 1), 0), ("siren_fused_bwd_f32", (3, 10, 7, 1), 0),
    ("siren_loss_grads_wg", (128, 128, 1), 2), ("siren_loss_grads_rtc", (2, 64, 64, 1), 3),
])
def test_two_calls_of_a_route_build_one_plan(card_stubs, entry, dims, D):
    """Every SIREN route builds its call plan on a shape's first call and
    reuses it: two calls, one ``_PLANS`` entry, two launches of the
    route's entry, each inside ``kernel.launch``."""
    x, ws, t = _stub_problem(dims, D=D)
    for _ in range(2):
        _ENTRY_CALLS[entry](x, ws, t)
    name = entry.split("+")[0]
    assert [p.entry for p in tk._PLANS.values()] == [name]
    assert card_stubs == [(name, ("kernel.launch",))] * 2


def test_k1_route_of_the_models():
    """Unbatched, the 2-D ensemble's Siren(2, 64, 6) with sample weights and
    the soft-ERD SirenERD(2, 128, 3) trunk with max |out| (and, at the same
    widths, either with ReLU codes or without options) take the streaming
    route; the 3-D pipeline's Siren the tensor-core route, and with sample
    weights the SIMT route."""
    def dims_of(model, d_in):
        return (d_in,) + tuple(int(w.shape[0]) for w in model.weights()[0::2])

    master, erd, ref = Siren(2, 64, 6), SirenERD(2, 128, 3), Siren(256, 512, 3)
    for model in (master, erd):
        for weighted, absmax in ((False, False), (True, False), (False, True), (True, True)):
            assert tk.k1_route(dims_of(model, 2), model.acts, weighted, absmax) == "stream"
    relu = ("sine",) * 5 + ("relu", "relu", "none")
    assert tk.k1_route(dims_of(master, 2), relu, weighted=True) == "stream"
    assert tk.k1_route(dims_of(ref, 256), ref.acts) == "wg"
    assert tk.k1_route(dims_of(ref, 256), ref.acts, weighted=True) == "simt"


def test_k2_k3_route_of_the_models():
    """K2 and K3 of the port's models: the 3-D Siren's PerturbNet steps and
    inference take the tensor-core route; SirenERD's trunk (ReLU codes) and
    the 2-D ensemble's 64-wide Siren keep the SIMT kernels, with or without
    K1's options."""
    def dims_of(model, d_in):
        return (d_in,) + tuple(int(w.shape[0]) for w in model.weights()[0::2])

    ref = Siren(256, 512, 3)
    assert tk.tc_route(dims_of(ref, 256), ref.acts)
    for model in (Siren(2, 64, 6), SirenERD(2, 128, 3)):
        assert not tk.tc_route(dims_of(model, 2), model.acts)
    # SirenERD's ReLU codes alone keep it off the route, at any input width
    erd = SirenERD(2, 128, 3)
    assert not tk.tc_route((128,) + dims_of(erd, 2)[1:], erd.acts)


def _bf16_rne_numpy(x32: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (as float32 values), round to nearest even on the
    bit pattern: the reference for torch's and the kernel's rounding."""
    u = x32.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return (u & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def test_split_error_bound_against_numpy():
    """split_bf16x3 (the plain version of the route's operand split): hi and
    lo are numpy's round-to-nearest-even of x and of x - hi, and |x - hi -
    lo| <= 2^-16 |x|, over magnitudes from 1e-30 to 1e30, ties and zeros."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=20_000) * 10.0 ** rng.uniform(-30, 30, size=20_000)).astype(np.float32)
    x[:5] = [0.0, -0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -9, -(1.0 + 2.0 ** -8)]
    hi, lo = tk.split_bf16x3(torch.as_tensor(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    want_hi = _bf16_rne_numpy(x)
    want_lo = _bf16_rne_numpy(x - want_hi)
    np.testing.assert_array_equal(hi.float().numpy(), want_hi)
    np.testing.assert_array_equal(lo.float().numpy(), want_lo)
    err = np.abs(x.astype(np.float64) - want_hi - want_lo.astype(np.float64))
    assert (err <= 2.0 ** -16 * np.abs(x.astype(np.float64))).all()
    assert err.max() > 0  # the bound is met, not vacuous


@pytest.fixture(scope="module")
def tc_class():
    """A Siren of the route's class, 256 -> 256x2 -> 1, on 400 rows (no tile
    of 128 divides 400): the JAX model's init, converted."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(400, 256)).astype(np.float32)
    model = JSiren(hidden_features=256, hidden_layers=1)
    params = model.init(jax.random.key(1), jnp.asarray(x))
    jws = tuple(jk.weights_from_flax(params))
    tws = convert.siren_weights(jax.tree.map(np.asarray, params))
    target = rng.normal(size=(400, 1)).astype(np.float32)
    return x, jws, tws, target


@pytest.mark.parametrize("n_rows", [None, 350])
def test_plain_k1_matches_pallas_at_the_tc_width(tc_class, n_rows):
    """The plain K1 that the route is held against on the card agrees with
    the Pallas kernel (interpret mode) at the tolerances of
    ``tests/test_torch_siren_kernel.py`` (loss rtol 1e-4, dW atol 5e-4: the
    JAX kernel stashes activations in bf16), and on the CPU it launches
    nothing."""
    x, jws, tws, target = tc_class
    dims = (256,) + tuple(int(w.shape[0]) for w in tws[0::2])
    assert tk.tc_route(dims, SIREN_ACTS(len(dims) - 2))
    loss_j, dws_j = jk.siren_loss_grads(jnp.asarray(x), jws, jnp.asarray(target),
                                        n_rows=n_rows)
    tk.reset_launches()
    loss_t, dws_t = tk.siren_loss_grads(torch.as_tensor(x), tws, torch.as_tensor(target),
                                        n_rows=n_rows)
    assert not any(tk.LAUNCHES.values())
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    for gt, gj in zip(dws_t, dws_j):
        gt = gt.T.numpy() if gt.dim() == 2 else gt.numpy()
        np.testing.assert_allclose(gt, np.asarray(gj), atol=5e-4)


def test_plain_k3_matches_pallas_at_the_tc_width(tc_class):
    """The plain K3 that the route is held against on the card agrees with
    the Pallas ``siren_forward`` (interpret mode) at the tolerance of
    ``tests/test_torch_siren_kernel.py`` (atol 2e-4), and on the CPU the
    wrapper launches nothing."""
    x, jws, tws, _ = tc_class
    ref = np.asarray(jk.siren_forward(jnp.asarray(x), list(jws)))
    tk.reset_launches()
    got = tk.siren_forward(torch.as_tensor(x), tws)
    assert not any(tk.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
    np.testing.assert_allclose(tk.siren_forward_ref(torch.as_tensor(x), tws).numpy(), ref,
                               atol=2e-4)


@pytest.mark.parametrize("need_dw", [False, True])
def test_plain_k2_matches_pallas_at_the_tc_width(tc_class, need_dw):
    """The plain K2, with and without dW, agrees with the VJP of the Pallas
    ``siren_fused`` (interpret mode) at the tolerances of
    ``tests/test_torch_siren_kernel.py`` (dx atol 5e-3, dW atol 5e-4), and
    on the CPU the wrapper launches nothing.

    With g ~ N(0, 1) / 400, dx is at most about 7e-5, far below its atol; so
    dx, and every dW and db, are also held to 1e-2 of their own largest
    magnitude. The JAX kernel's bf16 stash of activations allows that: the
    gap measured on the CPU is 1.7e-3 of max |dx| and at most 2.7e-3 of a
    dW's."""
    x, jws, tws, _ = tc_class
    g = (np.random.default_rng(2).normal(size=(x.shape[0], 1)) / x.shape[0]).astype(np.float32)
    gj = jnp.asarray(g)

    def f(xx, ws):
        return jnp.sum(jk.siren_fused(xx, ws, 30.0) * gj)

    def close(got, want):
        np.testing.assert_array_less(np.abs(got - want).max(), 1e-2 * np.abs(want).max())

    dx_j, dws_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jws)
    tk.reset_launches()
    dx_t, dws_t = tk.siren_fused_bwd(torch.as_tensor(x), tws, torch.as_tensor(g),
                                     need_dw=need_dw)
    assert not any(tk.LAUNCHES.values())
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), atol=5e-3)
    close(dx_t.numpy(), np.asarray(dx_j))
    if not need_dw:
        assert dws_t is None
        return
    for gt, gjw in zip(dws_t, dws_j):
        gt = gt.T.numpy() if gt.dim() == 2 else gt.numpy()
        np.testing.assert_allclose(gt, np.asarray(gjw), atol=5e-4)
        close(gt, np.asarray(gjw))
