"""The CUDA source of P1 (``csrc/mma_probe.cu``) runs on the CPU under an
emulation of the CUDA execution model (``tests/cuda_emulation``, whose
header defers each thread's ``wgmma`` to its ``wait_group`` and reads the
operands through the descriptors as the hardware decodes them, 128-byte
swizzle included), through the same ctypes launch code the wrapper uses on
the card, against the plain PyTorch version: both types, with one and with
several steps per block. At H 256 a rep is four 128-byte depth chunks of A
and B in bf16 and two in int8, so a block's 12 to 32 stages wrap the ring
of six.
"""
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.cli.int8_mma_probe import operands as probe_operands
from mri_super_resolution_tpu_torch.ops import mma_probe as mp

torch.set_num_threads(2)

# bf16 P1 against its plain version: within 1e-5 of the largest output, as
# chip_smoke.py holds it on the card
PROBE_BF16_TOL = 1e-5


@pytest.fixture(scope="module")
def emulated_probe(tmp_path_factory):
    return emulated_library(tmp_path_factory, "mma_probe", mp._declare)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("grid_steps,splits", [(3, None), (3, 1), (4, 3)])
def test_emulated_mma_probe_matches_plain(emulated_probe, dtype, grid_steps, splits):
    """P1 at T 128, H 256 (two output tiles), REPS 2: int8 equal to the plain
    version bit for bit (exact step sums; every step adds the same float32
    value, so any order of the GRID adds gives the same bits here), bf16
    within PROBE_BF16_TOL of the largest output (float32 sums of 512 exact
    products in another order). ``splits`` 1 runs all steps in one block,
    3 of 4 steps splits them unevenly."""
    a, b = probe_operands(dtype, 128, 256, 2, seed=grid_steps)
    out = mp._launch(emulated_probe, a, b.t().contiguous(), 2, grid_steps, 0, splits)
    ref = mp.mma_probe_ref(a, b, 2, grid_steps)
    assert out.shape == ref.shape == (128, 256)
    if dtype == torch.int8:
        assert torch.equal(out, ref)
    else:
        assert float((out - ref).abs().max()) <= PROBE_BF16_TOL * float(ref.abs().max())


def test_emulated_mma_probe_plan(emulated_probe):
    """One block on each of the 132 SMs at the probe's shape (12 tiles, 11
    splits), at most one split a step, and refusals of shapes off the tile
    and of a B block too deep to stay in shared memory."""
    assert emulated_probe.mma_probe_splits(384, 512, 512) == 11
    assert emulated_probe.mma_probe_splits(128, 128, 3) == 3
    a = torch.zeros(2 * 96, 128, dtype=torch.int8)
    with pytest.raises(RuntimeError):
        mp._launch(emulated_probe, a, torch.zeros(128, 128, dtype=torch.int8), 2, 1, 0)
    deep = torch.zeros(128, 576, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        mp._launch(emulated_probe, deep, torch.zeros(128, 576, dtype=torch.bfloat16), 1, 1, 0)
