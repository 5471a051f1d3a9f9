"""The CUDA source of K6-K7 (``csrc/conv3d.cu``) runs on the CPU under an
emulation of the CUDA execution model (``tests/cuda_emulation``), through
the same ctypes launch code the wrapper uses on the card, against the plain
PyTorch versions.

K6 SAME and VALID, both types, outputs off the tiles, more than one
channel chunk and more than one 32-channel output block; K7 the same, plus
more than one 32-channel input block and more than one work item per
workspace slot. The bfloat16 kernels (tensor-core products through the
emulated ``mma.sync`` and ``ldmatrix``, ``cp.async`` copies) also on their
own tiling: flat-plane tiles of 256 rows with a ragged last tile, padded
widths that do not divide the tile, several column strips, C = 8, 24, 40
and 64 (the K padding of C % 16 == 8), more t-planes than the three-plane
ring holds, pad 2 (VALID's dx), and more work items than workspace slots.
Shared memory starts as NaN bits in each emulated block, so a row or a K
padding that a kernel reads without writing shows.
"""
import numpy as np
import pytest
import torch

from cuda_emulation.emulated import emulated_library
from mri_super_resolution_tpu_torch.ops import conv3d_kernel as ck

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def emulated_conv3d(tmp_path_factory):
    return emulated_library(tmp_path_factory, "conv3d", ck._declare)


CONV_CASES = [
    ((1, 5, 7, 4, 8), 8, "SAME"),  # one chunk, one group of 8 outputs, B 1
    ((2, 19, 35, 3, 16), 40, "VALID"),  # two row and two column tiles, two output blocks
    ((1, 17, 6, 5, 24), 16, "SAME"),  # three channel chunks, H over one tile
    ((1, 3, 3, 3, 8), 32, "VALID"),  # the smallest VALID input: one output voxel
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,padding", CONV_CASES)
def test_emulated_conv3d_matches_plain(emulated_conv3d, shape, cout, padding, dtype):
    """float32: the sums' order differs, within 1e-5 of the largest output.
    bfloat16: bf16 operands, float32 sums, one rounding to nearest, so each
    output is within half a bf16 ulp of the float32 sum of the same operands
    (plus the sums' order)."""
    rng = np.random.default_rng(sum(shape) + cout)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(dtype)
    k = torch.as_tensor((rng.normal(size=(3, 3, 3, shape[-1], cout)) * 0.1)
                        .astype(np.float32)).to(dtype)
    b = torch.as_tensor(rng.normal(size=(cout,)).astype(np.float32))
    out = ck._launch(emulated_conv3d, x, k, b, padding, 0)
    ref = ck.conv3d_rfab_ref(x, k, b, padding)
    assert out.shape == ref.shape and out.dtype == dtype
    sums = ck.conv3d_rfab_ref(x.float(), k.float(), b, padding)  # float32, unrounded
    scale = float(sums.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * scale)
    else:
        half_ulp = 2.0 ** (torch.floor(torch.log2(sums.abs().clamp_min(1e-30))) - 8)
        assert bool(((out.float() - sums).abs() <= half_ulp + 1e-5 * scale).all())


BWD_CASES = [
    ((1, 5, 7, 4, 8), 8, "SAME"),  # one block, one slot per work item, B 1
    ((2, 19, 35, 3, 16), 40, "VALID"),  # ragged 8 x 16 items, two output blocks
    ((1, 9, 18, 5, 40), 16, "SAME"),  # two input-channel blocks (32 + 8)
    ((4, 17, 17, 12, 8), 8, "SAME"),  # 288 work items: two per workspace slot
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,padding", BWD_CASES)
def test_emulated_conv3d_bwd_matches_plain(emulated_conv3d, shape, cout, padding, dtype):
    """K7 against its plain version. dW and db (float32 sums of the same
    float32 products in another order) within 1e-5 of their largest entry;
    dx as K6's output: float32 within 1e-5 of the largest, bfloat16 within
    half a bf16 ulp of the float32 sum of the same operands."""
    rng = np.random.default_rng(sum(shape) + cout)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(dtype)
    k = torch.as_tensor((rng.normal(size=(3, 3, 3, shape[-1], cout)) * 0.1)
                        .astype(np.float32)).to(dtype)
    g = torch.as_tensor(rng.normal(size=(*ck.out_shape(shape, padding), cout))
                        .astype(np.float32)).to(dtype)
    dx, dw, db = ck._launch_bwd(emulated_conv3d, x, k, g, padding, 0)
    dx_r, dw_r, db_r = ck.conv3d_rfab_bwd_ref(x, k, g, padding)
    assert dx.shape == x.shape and dx.dtype == dtype
    assert dw.shape == (3, 3, 3, shape[-1], cout) and db.shape == (cout,)
    for a, b in ((dw, dw_r), (db, db_r)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    sums = ck.conv3d_rfab_bwd_ref(x.float(), k.float(), g.float(), padding)[0]
    scale = float(sums.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(dx, dx_r, rtol=0, atol=1e-5 * scale)
    else:
        half_ulp = 2.0 ** (torch.floor(torch.log2(sums.abs().clamp_min(1e-30))) - 8)
        assert bool(((dx.float() - sums).abs() <= half_ulp + 1e-5 * scale).all())


def test_emulated_conv3d_bwd_repeats_and_sizes_its_workspace(emulated_conv3d):
    """Two runs give the same bits (no atomics), in both types; the slot
    count is at most two waves of 132 blocks and refuses a workspace sized
    for another call."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(4, 17, 17, 12, 8)).astype(np.float32))
    k = torch.as_tensor(rng.normal(size=(3, 3, 3, 8, 8)).astype(np.float32))
    g = torch.as_tensor(rng.normal(size=(4, 17, 17, 12, 8)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xd, kd, gd = x.to(dtype), k.to(dtype), g.to(dtype)
        a = ck._launch_bwd(emulated_conv3d, xd, kd, gd, "SAME", 0)
        b = ck._launch_bwd(emulated_conv3d, xd, kd, gd, "SAME", 0)
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    # the training path's main call: 32 x 9 planes of 5 x 3 items in 255 slots
    assert emulated_conv3d.conv3d_rfab_bwd_slots(32, 34, 34, 9, 1) == 255
    assert emulated_conv3d.conv3d_rfab_bwd_slots(4, 17, 17, 12, 1) == 144
    # bfloat16: 32 x 9 planes of 5 tiles (34 x 36 rows) in 85 slots of 17
    # items, three blocks (one per dz) a slot
    assert emulated_conv3d.conv3d_rfab_bwd_bf16_slots(32, 34, 34, 9, 32, 32, 1) == 85
    assert emulated_conv3d.conv3d_rfab_bwd_bf16_slots(4, 17, 17, 12, 8, 8, 1) == 48
    rc = emulated_conv3d.conv3d_rfab_bwd_f32(
        x.data_ptr(), 4, 17, 17, 12, 8, k.data_ptr(), g.data_ptr(), 8, 1, x.data_ptr(),
        k.data_ptr(), g.data_ptr(), g.data_ptr(), 7, 0)
    assert rc == -1
    xb, kb, gb = x.bfloat16(), k.bfloat16(), g.bfloat16()
    rc = emulated_conv3d.conv3d_rfab_bwd_bf16(
        xb.data_ptr(), 4, 17, 17, 12, 8, kb.data_ptr(), gb.data_ptr(), 8, 1, xb.data_ptr(),
        k.data_ptr(), g.data_ptr(), g.data_ptr(), 47, 0)
    assert rc == -1


def _half_ulp_close(out, sums):
    """Each bfloat16 output within half a bf16 ulp of the float32 sum of the
    same operands, plus 1e-5 of the largest for the sums' order."""
    scale = float(sums.abs().max())
    half_ulp = 2.0 ** (torch.floor(torch.log2(sums.abs().clamp_min(1e-30))) - 8)
    return bool(((out.float() - sums).abs() <= half_ulp + 1e-5 * scale).all())


TC_CONV_CASES = [
    ((1, 23, 13, 4, 40), 16, "SAME"),  # C 40 (K padded to 48); 345 rows: a ragged 2nd tile
    ((2, 6, 9, 11, 24), 48, "SAME"),  # 11 t-planes through the ring; two output blocks
    ((1, 40, 30, 5, 8), 8, "VALID"),  # C 8; 38 x 30 rows in five tiles; one n8 tile
    ((1, 4, 20, 3, 64), 8, "SAME"),  # C 64: the kernel leaves room for 9-column strips
]


@pytest.mark.parametrize("shape,cout,padding", TC_CONV_CASES)
def test_emulated_conv3d_tc_tiling_matches_plain(emulated_conv3d, shape, cout, padding):
    """bfloat16 K6 on the tensor-core tiling against its plain version."""
    rng = np.random.default_rng(sum(shape) + cout + 1)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).bfloat16()
    k = torch.as_tensor((rng.normal(size=(3, 3, 3, shape[-1], cout)) * 0.1)
                        .astype(np.float32)).bfloat16()
    b = torch.as_tensor(rng.normal(size=(cout,)).astype(np.float32))
    out = ck._launch(emulated_conv3d, x, k, b, padding, 0)
    assert out.shape == ck.out_shape(shape, padding) + (cout,)
    assert _half_ulp_close(out, ck.conv3d_rfab_ref(x.float(), k.float(), b, padding))


TC_BWD_CASES = [
    ((1, 23, 13, 4, 40), 16, "SAME"),  # dW: input blocks of 32 and 8 channels
    ((2, 9, 7, 6, 24), 40, "VALID"),  # dx pads g by 2 and sums 40 channels; dW C 24
    ((1, 4, 20, 3, 16), 64, "SAME"),  # dx sums 64 channels in 9-column strips
    ((1, 3, 100, 3, 8), 8, "SAME"),  # dW: two column strips of 95 and 5
    ((6, 17, 17, 12, 8), 8, "SAME"),  # 144 work items, two a slot (72 slots)
]


@pytest.mark.parametrize("shape,cout,padding", TC_BWD_CASES)
def test_emulated_conv3d_bwd_tc_tiling_matches_plain(emulated_conv3d, shape, cout, padding):
    """bfloat16 K7 on the tensor-core tiling against its plain version: dW
    and db within 1e-5 of their largest entry, dx within half a bf16 ulp."""
    rng = np.random.default_rng(sum(shape) + cout + 1)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).bfloat16()
    k = torch.as_tensor((rng.normal(size=(3, 3, 3, shape[-1], cout)) * 0.1)
                        .astype(np.float32)).bfloat16()
    g = torch.as_tensor(rng.normal(size=(*ck.out_shape(shape, padding), cout))
                        .astype(np.float32)).bfloat16()
    dx, dw, db = ck._launch_bwd(emulated_conv3d, x, k, g, padding, 0)
    sums, dw_r, db_r = ck.conv3d_rfab_bwd_ref(x.float(), k.float(), g.float(), padding)
    for a, b in ((dw, dw_r), (db, db_r)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    assert dx.shape == x.shape and _half_ulp_close(dx, sums)


def test_emulated_conv3d_bf16_refuses_wide_sums(emulated_conv3d):
    """The bfloat16 kernels keep the 3x3x3 kernel in shared memory: a sum
    over 72 channels is refused by the wrapper (both directions) and by the
    entry point."""
    x = torch.zeros(1, 3, 3, 3, 72, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 3, 72, 8, dtype=torch.bfloat16)
    b = torch.zeros(8)
    with pytest.raises(ValueError, match="at most 64"):
        ck._launch(emulated_conv3d, x, k, b, "SAME", 0)
    with pytest.raises(ValueError, match="at most 64"):
        ck._launch_bwd(emulated_conv3d, x[..., :8], k.reshape(3, 3, 3, 8, 72),
                       torch.zeros(1, 3, 3, 3, 72, dtype=torch.bfloat16), "SAME", 0)
    out = torch.empty(1, 3, 3, 3, 8, dtype=torch.bfloat16)
    assert emulated_conv3d.conv3d_rfab_bf16(x.data_ptr(), 1, 3, 3, 3, 72, k.data_ptr(),
                                            b.data_ptr(), 8, 1, out.data_ptr(), 0) == -1


WG_CASES = [
    ((2, 9, 11, 9, 32), "SAME"),  # T 9: planes 0 and 10 absent; 9 x 13 rows, a ragged tile a b
    ((1, 18, 20, 5, 32), "VALID"),  # T 5 -> 3 outputs; 16 x 20 rows in two tiles, one ragged
    ((2, 6, 7, 3, 32), "SAME"),  # T 3: one plane of three absent at each end
    ((1, 3, 300, 3, 32), "SAME"),  # seven strips of 44 columns, the last of 36
]


@pytest.mark.parametrize("shape,padding", WG_CASES)
def test_emulated_conv3d_wg_matches_plain(emulated_conv3d, shape, padding):
    """bfloat16 K6 at C = Cout = 32 takes the wgmma kernel (the three
    temporal taps side by side, an accumulator block a t_out in turn): each
    output within half a bf16 ulp of the float32 sum of the same operands,
    like the mma.sync kernel on the same call."""
    rng = np.random.default_rng(sum(shape) + 7)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).bfloat16()
    k = torch.as_tensor((rng.normal(size=(3, 3, 3, 32, 32)) * 0.1)
                        .astype(np.float32)).bfloat16()
    b = torch.as_tensor(rng.normal(size=(32,)).astype(np.float32))
    lib = emulated_conv3d
    assert ck._entry(lib, x, 32) == lib.conv3d_rfab_bf16_wg
    out = ck._launch(lib, x, k, b, padding, 0)
    sync = ck._launch(lib, x, k, b, padding, 0, fn=lib.conv3d_rfab_bf16)
    assert out.shape == ck.out_shape(shape, padding) + (32,)
    sums = ck.conv3d_rfab_ref(x.float(), k.float(), b, padding)
    assert _half_ulp_close(out, sums) and _half_ulp_close(sync, sums)


def test_emulated_conv3d_wg_persistent_walk_repeats(emulated_conv3d, monkeypatch):
    """One persistent block (a one-SM device) walks every unit of two batch
    items, four tiles each, and its ring wraps many times: the same bits as
    a block a unit, and as a second call; the entry refuses other widths."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(2, 30, 31, 5, 32)).astype(np.float32)).bfloat16()
    k = torch.as_tensor((rng.normal(size=(3, 3, 3, 32, 32)) * 0.1)
                        .astype(np.float32)).bfloat16()
    b = torch.as_tensor(rng.normal(size=(32,)).astype(np.float32))
    wide = ck._launch(emulated_conv3d, x, k, b, "SAME", 0)
    monkeypatch.setenv("EMU_SM_COUNT", "1")
    one = ck._launch(emulated_conv3d, x, k, b, "SAME", 0)
    again = ck._launch(emulated_conv3d, x, k, b, "SAME", 0)
    assert torch.equal(one, wide) and torch.equal(one, again)
    assert _half_ulp_close(one, ck.conv3d_rfab_ref(x.float(), k.float(), b, "SAME"))
    x16, k16 = x[..., :16].contiguous(), k[:, :, :, :16, :].contiguous()
    out = torch.empty(2, 30, 31, 5, 32, dtype=torch.bfloat16)
    assert emulated_conv3d.conv3d_rfab_bf16_wg(x16.data_ptr(), 2, 30, 31, 5, 16, k16.data_ptr(),
                                               b.data_ptr(), 32, 1, out.data_ptr(), 0) == -1


def test_emulated_conv3d_bwd_at_32_channels_keeps_its_kernel(emulated_conv3d):
    """K7 at C = Cout = 32 (its dx the flipped kernel, off the wgmma route)
    against its plain version."""
    rng = np.random.default_rng(5)
    shape = (1, 9, 10, 4, 32)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).bfloat16()
    k = torch.as_tensor((rng.normal(size=(3, 3, 3, 32, 32)) * 0.1)
                        .astype(np.float32)).bfloat16()
    g = torch.as_tensor(rng.normal(size=shape).astype(np.float32)).bfloat16()
    assert not ck.wg_route(True, 32, 32)
    dx, dw, db = ck._launch_bwd(emulated_conv3d, x, k, g, "SAME", 0)
    sums, dw_r, db_r = ck.conv3d_rfab_bwd_ref(x.float(), k.float(), g.float(), "SAME")
    for a, r in ((dw, dw_r), (db, db_r)):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5 * float(r.abs().max()))
    assert _half_ulp_close(dx, sums)
