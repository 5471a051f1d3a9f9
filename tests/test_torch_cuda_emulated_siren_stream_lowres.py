"""K1-a's streaming route (``csrc/siren_stream.cu``) under the CUDA
emulation (``tests/cuda_emulation``) at the half-res quality harness's row
counts: the 64 x 64 LR slice (4,096 rows, 32 row tiles of 128, so 32 slots
for the fixed-order sum where the soft-ERD fit has 128), the 63 x 63 slice
of an odd full-res side (3,969 = 31 x 128 + 1 rows: a last tile of one
row) and 129 rows (one full tile and one row). The trunk has the soft-ERD
SirenERD's depth (four sine layers, a ReLU head, a ReLU output) at hidden
64, the route's narrower width, to keep the emulation short (the wrapper
would send it to the weight-resident route, so the test calls the
streaming launch, the wrapper's own ctypes code, directly). Bars: those of
``tests/test_torch_cuda_emulated_siren_stream.py`` (the loss within 1e-4
relative, max |out| within 1e-5 relative, each dW/db within 1e-3 of its
largest magnitude), and a second call gives the same bits. The inputs keep
every ReLU gate clear of its kink (``_problem``).
"""
import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import siren_kernel as tk

torch.set_num_threads(2)

DIMS = (2, 64, 64, 64, 64, 64, 1)
ACTS = ("sine",) * 4 + ("relu", "relu")
KINK = 1e-5  # least |pre-activation| of a ReLU gate in the inputs


@pytest.fixture(scope="module")
def emulated_stream(tmp_path_factory):
    return emulated_library(tmp_path_factory, "siren_stream", tk._stream_declare)


def _head_preactivations(x, ws):
    """The ReLU head's pre-activations in float64, (P, 64)."""
    h, w = x.double(), [a.double() for a in ws]
    for l in range(4):
        h = torch.sin(30.0 * (h @ w[2 * l].T + w[2 * l + 1]))
    return h @ w[8].T + w[9]


def _problem(P, seed):
    """Seeded weights at SIREN-init scale with the output bias at 0.05 (as
    ``chip_smoke.py``'s K1-a inputs: the ReLU output on, well above the
    products' rounding) and the LR grid's first P coordinates. A row whose
    head pre-activation lies within ``KINK`` of zero is redrawn uniformly:
    there the kernel's ReLU gate can differ from the plain version's by
    rounding alone (bf16x3 products), and at hidden 64 one such row of
    3,969 moved a bias gradient by 1.1e-3 of its largest magnitude. The row
    of the largest |out| is moved last, into the last (ragged) tile, so
    that a max or a sum that missed that tile would show."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))
    side = int(np.ceil(np.sqrt(P)))
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, side)] * 2, indexing="ij"), -1)
    x = t(grid.reshape(-1, 2)[:P])
    ws = []
    for l in range(len(DIMS) - 1):
        b = 1.0 / DIMS[l] if l == 0 else np.sqrt(6.0 / DIMS[l]) / 30
        ws.append(t(rng.uniform(-b, b, size=(DIMS[l + 1], DIMS[l]))))
        ws.append(t(rng.uniform(-1, 1, size=(DIMS[l + 1],)) / np.sqrt(DIMS[l])))
    ws[-1] = torch.full_like(ws[-1], 0.05)
    while True:
        near = (_head_preactivations(x, ws).abs() < KINK).any(dim=1)
        if not bool(near.any()):
            break
        x[near] = t(rng.uniform(-1, 1, size=(int(near.sum()), 2)))
    target = t(rng.uniform(0, 1, size=(P, 1)))
    last = int(tk.siren_forward_ref(x, ws, 30.0, ACTS).abs().argmax())
    order = [i for i in range(P) if i != last] + [last]
    return x[order].contiguous(), ws, target[order].contiguous()


@pytest.mark.parametrize("P", [64 * 64, 63 * 63, 129])
def test_emulated_stream_at_the_lr_slice(emulated_stream, P):
    assert tk.stream_route(DIMS)
    x, ws, target = _problem(P, seed=P)
    got = tk._launch_loss_grads_stream(emulated_stream, x, ws, target, 30.0, P, 0, ACTS, None,
                                       True)
    loss, absmax, grads = tk.siren_loss_grads_ref(x, ws, target, 30.0, P, ACTS, None, True)
    assert 0 < float(absmax)
    torch.testing.assert_close(got[0], loss, rtol=1e-4, atol=0)
    torch.testing.assert_close(got[1], absmax, rtol=1e-5, atol=0)
    for i, (a, b) in enumerate(zip(got[2], grads)):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= 1e-3, f"grad {i}: {err:.2e} of its largest magnitude"
    again = tk._launch_loss_grads_stream(emulated_stream, x, ws, target, 30.0, P, 0, ACTS,
                                         None, True)
    assert all(torch.equal(a, b) for a, b in zip([got[0], got[1], *got[2]],
                                                 [again[0], again[1], *again[2]]))
