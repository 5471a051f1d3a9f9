"""The small helpers against the JAX package's: ``mgrid_square`` and
``chunked_coords`` (``core/coords.py``), ``from_tensor_normalize`` and
``per_bte_max_normalize`` (``core/normalize.py``), ``expand_from_hybrid``
(``data/combinations.py``), ``read_dicom_pixels`` (``data/io.py``); and the
RAMS ``layout="nthwc"`` forward from the JAX package's params, within 1e-5
of the output's largest magnitude in float32 (convolutions summed in
another order), equal to the ``nhwtc`` layout's on symmetric kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_super_resolution_tpu.config import RAMSConfig as JRAMSConfig
from mri_super_resolution_tpu.core import coords as jcoords
from mri_super_resolution_tpu.core import normalize as jnorm
from mri_super_resolution_tpu.data import combinations as jcomb
from mri_super_resolution_tpu.data import io as jio
from mri_super_resolution_tpu.pipelines.misr import build_rams as jbuild_rams
from mri_super_resolution_tpu_torch import convert
from mri_super_resolution_tpu_torch.config import RAMSConfig
from mri_super_resolution_tpu_torch.core import coords, normalize
from mri_super_resolution_tpu_torch.data import combinations, io
from mri_super_resolution_tpu_torch.pipelines.misr import build_rams

torch.set_num_threads(2)


@pytest.mark.parametrize("side,dim", [(5, 2), (4, 3)])
def test_mgrid_square(side, dim):
    np.testing.assert_array_equal(coords.mgrid_square(side, dim).numpy(),
                                  np.asarray(jcoords.mgrid_square(side, dim)))


def test_chunked_coords():
    got, want = coords.chunked_coords((6, 5, 3), 32), jcoords.chunked_coords((6, 5, 3), 32)
    assert [c.shape for c in got] == [c.shape for c in want] == [(32, 3)] * 2 + [(26, 3)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_normalize_helpers():
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (4, 5)).astype(np.float32)
    np.testing.assert_array_equal(normalize.from_tensor_normalize(torch.as_tensor(img)).numpy(),
                                  np.asarray(jnorm.from_tensor_normalize(jnp.asarray(img))))
    np.testing.assert_allclose(
        normalize.from_tensor_normalize(normalize.to_tensor_normalize(img)), img, atol=1e-7)
    hybrid = rng.uniform(0.1, 5, (4, 3, 6, 5, 2)).astype(np.float32)
    got, gmax = normalize.per_bte_max_normalize(torch.as_tensor(hybrid))
    want, wmax = jnorm.per_bte_max_normalize(jnp.asarray(hybrid))
    assert gmax.shape == (4, 3)
    np.testing.assert_array_equal(gmax.numpy(), np.asarray(wmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_expand_from_hybrid():
    rng = np.random.default_rng(1)
    hybrid = np.empty((4, 2), dtype=object)
    for te in range(2):
        hybrid[0, te] = rng.uniform(size=(3, 4, 2)).astype(np.float32)
        for b, A in ((1, 2), (2, 3), (3, 2)):
            hybrid[b, te] = rng.uniform(size=(3, 4, 2, A)).astype(np.float32)
    for te in (0, 1):
        got = combinations.expand_from_hybrid(hybrid, te)
        assert got.shape == (3, 4, 2, 4, 12)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jcomb.expand_from_hybrid(hybrid, te)))


def test_read_dicom_pixels(tmp_path):
    img = np.random.default_rng(2).integers(-500, 3000, (7, 9))
    path = str(tmp_path / "a.dcm")
    io.save_dicom(img, path)
    got = io.read_dicom_pixels(path)
    np.testing.assert_array_equal(got, jio.read_dicom_pixels(path))
    np.testing.assert_array_equal(got, img.astype(np.int16))
    (tmp_path / "b.dcm").write_bytes(b"\0" * 200)
    with pytest.raises(ValueError, match="not a DICOM"):
        io.read_dicom_pixels(str(tmp_path / "b.dcm"))


TINY = dict(filters=8, N=1, r=4, compute_dtype="float32")


def test_rams_nthwc_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(7000, 8000, (2, 6, 7, 9)).astype(np.float32)
    jm = jbuild_rams(JRAMSConfig(**TINY, layout="nthwc"))
    prm = jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(rng.uniform(
            *((0.5, 1.5) if path[-1].key == "g" else (-0.3, 0.3)), s.shape).astype(np.float32)),
        jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x[:1])))
    want = np.asarray(jm.apply(prm, jnp.asarray(x)))
    model = build_rams(RAMSConfig(**TINY, layout="nthwc"))
    model.load_state_dict(convert.rams_state_dict(jax.tree.map(np.asarray, prm)))
    with torch.no_grad():
        got = model(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (2, 18, 21, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the two layouts are the same network once each 3-D kernel's spatial
    # axes are permuted (H, W, T) -> (T, H, W)
    sd = model.state_dict()
    nhwtc = build_rams(RAMSConfig(**TINY))
    nhwtc.load_state_dict({k: v.permute(1, 2, 0, 3, 4) if k.endswith(".v") and v.dim() == 5
                           else v for k, v in sd.items()})
    with torch.no_grad():
        np.testing.assert_allclose(nhwtc(torch.as_tensor(x)).numpy(), got, rtol=0,
                                   atol=1e-5 * np.abs(got).max())


def test_nthwc_turns_the_conv_kernel_off():
    model = build_rams(RAMSConfig(**TINY, layout="nthwc", conv_kernel=True))
    assert model.layout == "nthwc"
    assert not any(getattr(m, "use_k6", False) for m in model.modules())
    with pytest.raises(ValueError, match="unknown layout"):
        RAMSConfig(layout="nchw")
