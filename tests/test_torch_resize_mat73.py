"""The port's last two public helpers against the JAX package's: the
cubic-spline resample ``core/interp.py:resize_along_axis`` and the MATLAB
v7.3 writer ``data/io.py:save_mat73``, on the CPU.

``resize_along_axis``: float32 inputs through both packages (the JAX
function runs in float32 with x64 off, its dense solve included), along
axes 0, 1 and 2, upsampled, downsampled and at the knots. The sample
positions are ``jnp.linspace(0, n - 1, new_size)`` bit for bit
(``core.coords.linspace_from_zero``), so the gap is the float32 solve and
Hermite sums: measured 1.8e-7 of values up to 1.17. Tolerance 1e-6
absolute. Against scipy's ``interp1d(kind="cubic")`` (float64, not-a-knot)
at ``tests/test_core.py``'s 2e-4 (measured 4.5e-7). At the knots
(``new_size == n``) the samples come back exactly: there u is 0 (or 1 on
the last interval) and the Hermite form reduces to the knot's value
(``tests/test_core.py`` holds the JAX function to 1e-4 there).

``save_mat73``: a dict of the layouts the pipelines read (a cell array of
volumes, float64 and float32 and integer arrays, a scalar, a string) is
written by both packages; the port's file must load the same through both
packages' ``load_mat`` and hold the same datasets, values and
``MATLAB_class`` attributes as the JAX function's file, and the same
128-byte MAT header.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import interp1d

from mri_super_resolution_tpu.core.interp import resize_along_axis as jresize
from mri_super_resolution_tpu.data import io as jio
from mri_super_resolution_tpu_torch.core.interp import resize_along_axis
from mri_super_resolution_tpu_torch.data import io as tio

torch.set_num_threads(2)

JAX_ATOL, SCIPY_ATOL = 1e-6, 2e-4


def _volume(axis: int, n: int, seed: int) -> np.ndarray:
    shape = [6, 5, 7]
    shape[axis] = n
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("n,new_size", [(12, 30), (12, 7), (24, 128)])
def test_resize_along_axis_matches_jax_float32(axis, n, new_size):
    arr = _volume(axis, n, seed=axis + n)
    got = resize_along_axis(torch.as_tensor(arr), new_size, axis)
    want = np.asarray(jresize(jnp.asarray(arr), new_size, axis))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.shape[axis] == new_size
    np.testing.assert_allclose(got.numpy(), want, atol=JAX_ATOL)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_resize_along_axis_matches_scipy_cubic(axis):
    arr = _volume(axis, 12, seed=10 + axis).astype(np.float64)
    want = interp1d(np.linspace(0, 1, 12), arr, kind="cubic", axis=axis)(np.linspace(0, 1, 30))
    got = resize_along_axis(torch.as_tensor(arr), 30, axis)
    assert got.dtype == torch.float64  # the caller's dtype
    np.testing.assert_allclose(got.numpy(), want, atol=SCIPY_ATOL)
    got32 = resize_along_axis(torch.as_tensor(arr.astype(np.float32)), 30, axis)
    np.testing.assert_allclose(got32.numpy(), want, atol=SCIPY_ATOL)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_resize_along_axis_interpolates_knots(axis):
    arr = _volume(axis, 10, seed=20 + axis)
    got = resize_along_axis(torch.as_tensor(arr), 10, axis)
    np.testing.assert_array_equal(got.numpy(), arr)
    # an integer volume resamples as float32, and a linear ramp stays linear
    ramp = torch.arange(9).reshape(1, 9, 1).expand(2, 9, 3)
    out = resize_along_axis(ramp, 17, axis=1)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out[0, :, 0].numpy(), np.linspace(0, 8, 17), atol=1e-5)


def _mat_dict():
    rng = np.random.default_rng(4)
    cells = np.empty((2, 3), dtype=object)
    for i in range(2):
        for j in range(3):
            cells[i, j] = rng.uniform(0, 1, (4, 3, 2)).astype(np.float32) + i * 3 + j
    return {"hybrid_raw": cells, "b": np.array([[0.0, 150.0, 1000.0, 1500.0]]),
            "counts": np.arange(6, dtype=np.int32).reshape(2, 3),
            "mask": (rng.uniform(size=(5, 4)) > 0.5).astype(np.uint8),
            "scale": np.float64(2.5), "pt_id": "pat07"}


def _datasets(h5py, path: str) -> dict:
    """Every dataset of the file by name: its values (references resolved to
    their targets' names) and its MATLAB_class."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                data = obj[()]
                if obj.dtype == h5py.ref_dtype:
                    data = np.vectorize(lambda r: f[r].name)(data)
                out[name] = (data, obj.attrs["MATLAB_class"])
        f.visititems(visit)
    return out


def test_save_mat73_same_file_as_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    data = _mat_dict()
    ours, theirs = str(tmp_path / "t" / "m.mat"), str(tmp_path / "j" / "m.mat")
    tio.save_mat73(ours, data)
    jio.save_mat73(theirs, data)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read(128) == b.read(128)
    got, want = _datasets(h5py, ours), _datasets(h5py, theirs)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("#refs#/") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        assert got[k][0].dtype == want[k][0].dtype and got[k][1] == want[k][1], k
    for load in (jio.load_mat, tio.load_mat):
        a, b = load(ours), load(theirs)
        assert sorted(a) == sorted(b) == sorted(data)
        for k in ("b", "counts", "mask", "scale"):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        assert a["pt_id"] == b["pt_id"] == "pat07"
        for i in range(2):
            for j in range(3):
                np.testing.assert_array_equal(a["hybrid_raw"][i][j], data["hybrid_raw"][i, j])
                np.testing.assert_array_equal(a["hybrid_raw"][i][j], b["hybrid_raw"][i][j])
