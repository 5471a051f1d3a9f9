"""The port's loaders against the JAX package's and scipy: the C++ v5 reader
(``data/native_io.py``) on fabricated files, ``load_mat(prefer_native=True)``
and its fallback, the prefetch pool under ``load_cases``; MISR
preprocessing, every function, ``bicubic`` within 1e-5 of the largest value
(float32 resizes with sums in another order); the TF checkpoint index
reader on a bundle index written here (prefix-compressed entries with
restarts, an index block, the footer magic, one snappy-compressed block).

The native tests skip where ``g++`` is missing (decided in the test)."""
import os
import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from mri_super_resolution_tpu.core.interp import rescale as jrescale
from mri_super_resolution_tpu.data import native_io as jnative
from mri_super_resolution_tpu.data import preprocessing as jpre
from mri_super_resolution_tpu.data import tfckpt as jtf
from mri_super_resolution_tpu_torch.core.interp import rescale
from mri_super_resolution_tpu_torch.data import cases as tcases
from mri_super_resolution_tpu_torch.data import load_mat, native_io
from mri_super_resolution_tpu_torch.data import preprocessing as tpre
from mri_super_resolution_tpu_torch.data import tfckpt as ttf

torch.set_num_threads(2)


@pytest.fixture
def native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the C++ reader cannot be built")
    if not native_io.available():
        pytest.skip("the C++ reader did not build (zlib headers missing?)")
    return native_io


def _v5_file(path, compress=False):
    rng = np.random.default_rng(0)
    cell = np.empty((1, 2), dtype=object)
    cell[0, 0] = rng.normal(size=(2, 3))
    cell[0, 1] = np.arange(8.0).reshape(2, 2, 2)
    arrays = {"vol": rng.normal(size=(7, 5, 3)).astype(np.float32),
              "ints": np.arange(12, dtype=np.int16).reshape(3, 4),
              "cell": cell, "rec": {"a": np.eye(2), "b": np.array([[3.0]])},
              "name": "hello"}
    sio.savemat(path, arrays, do_compression=compress)
    return arrays


def test_native_reader_matches_scipy_and_jax(native, tmp_path):
    path = str(tmp_path / "a.mat")
    arrays = _v5_file(path)
    got = native.load_mat_native(path)
    ref = sio.loadmat(path)
    assert sorted(got) == sorted(arrays)
    np.testing.assert_array_equal(got["vol"], ref["vol"].astype(np.float64))
    np.testing.assert_array_equal(got["ints"], ref["ints"].astype(np.float64))
    assert got["name"] == "hello"
    assert got["cell"].shape == (1, 2) and got["cell"][0][1].shape == (2, 2, 2)
    np.testing.assert_array_equal(got["cell"][0][0], ref["cell"][0, 0])
    np.testing.assert_array_equal(got["rec"]["a"][0, 0], np.eye(2))
    if jnative.available():  # the JAX package's reader of the same source
        want = jnative.load_mat_native(path)
        for k in ("vol", "ints"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["cell"][0][1], want["cell"][0][1])
    # built into the port's build directory, never into native/
    assert native._target().parent.name in ("build", os.path.basename(
        os.environ.get("MRI_SR_TORCH_BUILD_DIR", "build")))


def test_load_mat_prefer_native_and_fallback(native, tmp_path):
    path = str(tmp_path / "c.mat")
    _v5_file(path, compress=True)  # the reader decodes numeric arrays only here
    np.testing.assert_array_equal(load_mat(path, "vol", prefer_native=True),
                                  sio.loadmat(path)["vol"].astype(np.float64))
    # a variable the reader skipped: read with scipy instead
    assert load_mat(path, "name", prefer_native=True)[0] == "hello"
    with pytest.raises(RuntimeError, match="not decoded"):
        native.load_mat_native(path, "name")
    with pytest.raises(RuntimeError):
        native.load_mat_native(str(tmp_path / "missing.mat"))


def test_load_mat_without_the_reader(tmp_path, monkeypatch):
    path = str(tmp_path / "s.mat")
    arrays = _v5_file(path)
    monkeypatch.setattr(native_io, "available", lambda: False)
    np.testing.assert_array_equal(load_mat(path, "vol", prefer_native=True), arrays["vol"])


def _registry_dir(root, side=20, slices=4):
    rng = np.random.default_rng(3)
    for no in ("07", "08"):
        sio.savemat(root / f"pat{no}_mean_b0.mat", {"data_mean_b0": rng.uniform(
            0.5, 1.5, (side, side, slices)).astype(np.float32)})
        sio.savemat(root / f"pat{no}_ERD.mat", {"ADC_alldata_mm_ERD": rng.uniform(
            0, 3, (side, side, slices)).astype(np.float32)})
    return root


def test_prefetcher_and_load_cases(native, tmp_path, monkeypatch):
    root = _registry_dir(tmp_path)
    pf = native.Prefetcher(num_threads=2)
    paths = sorted(str(p) for p in root.iterdir())
    handles = [pf.submit(p) for p in paths]
    for p, h in zip(paths, handles):
        got = pf.get(h)
        ref = {k: v for k, v in sio.loadmat(p).items() if not k.startswith("__")}
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v.astype(np.float64))
    pooled = tcases.load_cases(data_dir=str(root))
    monkeypatch.setattr(native_io, "available", lambda: False)
    plain = tcases.load_cases(data_dir=str(root))
    assert [c.pt_id for c in pooled] == ["18-1681-07", "18-1681-08"]
    for a, b in zip(pooled, plain):
        for k in ("b0", "erd", "dwi"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


def _imgset(rng, H=24, T=5):
    base = rng.uniform(0, 1, (H, H))
    imgs = np.stack([np.roll(base, (i % 3 - 1, (i * 2) % 5 - 2), (0, 1)) for i in range(T)], -1)
    mask = (rng.uniform(0, 1, imgs.shape) > 0.1).astype(float)
    return imgs, mask


def test_registration_matches_jax():
    rng = np.random.default_rng(0)
    imgs, mask = _imgset(rng)
    for i in range(imgs.shape[-1]):
        assert tpre._masked_translation(imgs[..., 0], imgs[..., i], mask[..., i]) == \
            jpre._masked_translation(imgs[..., 0], imgs[..., i], mask[..., i])
    for s in ((2, -1), (0, 3)):
        for mode in ("reflect", "constant"):
            np.testing.assert_array_equal(tpre._shift(imgs[..., 0], s, mode),
                                          jpre._shift(imgs[..., 0], s, mode))
    for a, b in zip(tpre.register_imgset(imgs, mask), jpre.register_imgset(imgs, mask)):
        np.testing.assert_array_equal(a, b)
    for flag in (False, True):
        for a, b in zip(tpre.register_dataset([imgs, imgs[::-1]], [mask, mask], flag),
                        jpre.register_dataset([imgs, imgs[::-1]], [mask, mask], flag)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_selection_augmentation_and_patches_match_jax():
    rng = np.random.default_rng(1)
    X = [rng.uniform(0, 1, (8, 8, 6)) for _ in range(3)]
    masks = [np.ones((8, 8, 6)) * np.array([1, 0.9, 0.5, 1, 0.95, 0.2]),
             np.ones((8, 8, 6)) * 0.1, np.ones((8, 8, 6)) * np.array([0.9, 0.1, 0, 0, 0, 0])]
    for kw in (dict(T=4), dict(T=4, remove_bad=False), dict(T=9, seed=3)):
        got, got_rm = tpre.select_T_images(X, masks, **kw)
        want, want_rm = jpre.select_T_images(X, masks, **kw)
        np.testing.assert_array_equal(got, want)
        assert got_rm == want_rm
    for a, b in zip(tpre.augment_imgset(X[0], X[1][..., :1], masks[0][..., :1], 3, 2),
                    jpre.augment_imgset(X[0], X[1][..., :1], masks[0][..., :1], 3, 2)):
        np.testing.assert_array_equal(a, b)
    arr = rng.uniform(0, 1, (2, 10, 10, 3))
    np.testing.assert_array_equal(tpre.gen_sub(arr, 4, 3), jpre.gen_sub(arr, 4, 3))
    with pytest.raises(ValueError, match="integer"):
        tpre.gen_sub(arr, 4, 4)
    with pytest.raises(ValueError, match="Wrong array shape"):
        tpre.gen_sub(arr[0], 4, 3)


@pytest.mark.parametrize("shape", [(2, 7, 9, 3), (5, 6, 2)])
def test_bicubic_matches_jax(shape):
    """Keys' cubic at a = -0.5 with the border taps renormalised, not
    ``F.interpolate``'s bicubic (a = -0.75, clamped border)."""
    X = np.random.default_rng(2).uniform(0, 100, shape)
    got, want = tpre.bicubic(X, 3), jpre.bicubic(X, 3)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    lib = torch.nn.functional.interpolate(torch.as_tensor(X[..., 0] if X.ndim == 4 else
                                                          X[None, ..., 0]).float()[:, None],
                                          scale_factor=3, mode="bicubic")[:, 0]
    assert np.abs(lib.numpy() - want[..., 0]).max() > 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_rescale_orders_match_jax(order, scale):
    img = np.random.default_rng(scale).uniform(0, 1, (9, 7)).astype(np.float32)
    want = np.asarray(jrescale(jnp.asarray(img), scale, order=order))
    got = rescale(torch.as_tensor(img), scale, order=order).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="order"):
        rescale(torch.as_tensor(img), scale, order=2)


# ---------------------------------------------------------------------------
# TF checkpoint index
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _entry_proto(dtype, shape, shard, offset, size) -> bytes:
    dims = b"".join(b"\x12" + _varint(len(d)) + d
                    for d in (b"\x08" + _varint(s) for s in shape))
    return (b"\x08" + _varint(dtype) + b"\x12" + _varint(len(dims)) + dims
            + b"\x18" + _varint(shard) + b"\x20" + _varint(offset) + b"\x28" + _varint(size)
            + b"\x35" + struct.pack("<I", 0xDEADBEEF))


def _block(items, restart_every=2) -> bytes:
    out, restarts, prev = bytearray(), [], b""
    for i, (key, value) in enumerate(items):
        if i % restart_every == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = len(os.path.commonprefix([prev, key]))
        out += _varint(shared) + _varint(len(key) - shared) + _varint(len(value))
        out += key[shared:] + value
        prev = key
    return bytes(out) + b"".join(struct.pack("<I", r) for r in restarts) + struct.pack(
        "<I", len(restarts))


def _snappy_literal(data: bytes) -> bytes:
    """A snappy stream of one literal (length > 60: the length in extra
    bytes)."""
    n = len(data) - 1
    extra = n.to_bytes((n.bit_length() + 7) // 8 or 1, "little")
    return _varint(len(data)) + bytes([(59 + len(extra)) << 2]) + extra + data


def _write_index(path, entries):
    """A bundle index: the header entry and the variables in two data
    blocks, the second snappy-compressed, an index block and the footer."""
    items = sorted(entries.items())
    blocks = [[(b"", b"\x08\x01")] + items[:3], items[3:]]
    data, handles = bytearray(), []
    for i, blk in enumerate(blocks):
        raw = _block(blk)
        body, ctype = (_snappy_literal(raw), 1) if i == 1 else (raw, 0)
        handles.append((blk[-1][0], len(data), len(body)))
        data += body + bytes([ctype]) + b"\0\0\0\0"
    meta_off = len(data)
    meta = _block([])
    data += meta + b"\0" * 5
    index_off = len(data)
    index = _block([(k, _varint(o) + _varint(s)) for k, o, s in handles])
    data += index + b"\0" * 5
    footer = _varint(meta_off) + _varint(len(meta)) + _varint(index_off) + _varint(len(index))
    data += footer + b"\0" * (40 - len(footer)) + struct.pack("<Q", 0xDB4775248B80FB57)
    with open(path, "wb") as f:
        f.write(bytes(data))


def test_tfckpt_reader_on_a_written_index(tmp_path):
    suffix = "/.ATTRIBUTES/VARIABLE_VALUE"
    entries = {
        f"model/conv{i}/kernel{suffix}".encode(): _entry_proto(1, (3, 3, 3, 32, 32), 0,
                                                               1000 * i, 110592)
        for i in range(3)}
    entries[f"model/conv0/bias{suffix}".encode()] = _entry_proto(1, (32,), 0, 9, 128)
    entries[f"model/conv0/kernel/.OPTIMIZER_SLOT/adam/m{suffix}".encode()] = _entry_proto(
        1, (3, 3, 3, 32, 32), 1, 0, 110592)
    entries[b"save_counter" + suffix.encode()] = _entry_proto(9, (), 0, 5, 8)
    path = str(tmp_path / "ckpt-1.index")
    _write_index(path, entries)
    got, want = ttf.read_index(path), jtf.read_index(path)
    assert got == {k: ttf.IndexEntry(**vars(v)) for k, v in want.items()}
    assert len(got) == 6
    e = got[f"model/conv1/kernel{suffix}"]
    assert (e.dtype, e.shape, e.offset, e.size) == ("float32", (3, 3, 3, 32, 32), 1000, 110592)
    assert got["save_counter" + suffix].dtype == "int64"
    shapes = ttf.model_variable_shapes(path)
    assert shapes == jtf.model_variable_shapes(path)
    assert sorted(shapes) == ["conv0/bias", "conv0/kernel", "conv1/kernel", "conv2/kernel"]
    bad = tmp_path / "bad.index"
    bad.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not an SSTable"):
        ttf.read_index(str(bad))


def test_snappy_copies():
    """Literals and both copy kinds, an overlapping copy among them."""
    stream = (_varint(15) + bytes([3 << 2]) + b"abcd"  # literal "abcd"
              + bytes([((8 - 4) << 2) | 1, 4])  # copy, 1-byte offset 4, length 8
              + bytes([(2 << 2) | 2]) + (3).to_bytes(2, "little"))  # copy, offset 3, length 3
    assert ttf._snappy_decompress(stream) == jtf._snappy_decompress(stream) == \
        b"abcdabcdabcdbcd"
    with pytest.raises(ValueError, match="header says"):
        ttf._snappy_decompress(_varint(16) + stream[1:])
