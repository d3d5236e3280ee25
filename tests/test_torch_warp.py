"""The port's warp ops (``ops/warp.py``) against the JAX package's, on
inputs drawn with numpy from a seed; ``resize_cubic_cv2`` also against
cv2.resize(INTER_CUBIC) itself.

Tolerances: ``rotation_matrix`` is the same numpy code, so exact. The
resize sums its products in another order than XLA: 2e-6 absolute on
values in [0, 1], as tests/test_reference_parity.py holds the JAX resize to
cv2. ``affine_warp``: 1e-6 absolute (same fp32 coordinates, so the same
cells; the four bilinear products may round differently).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu.ops import warp as jwarp
from improved_body_parts_tpu_torch.ops import warp as twarp
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("angle", [0.0, 10.0, -15.0, 90.0])
@pytest.mark.parametrize("center", [(32.0, 24.0), (16.375, 20.375)])
def test_rotation_matrix_matches_jax(center, angle):
    got = twarp.rotation_matrix(center, angle)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jwarp.rotation_matrix(center, angle))
    np.testing.assert_array_equal(twarp.rotation_matrix(center, angle, 1.5),
                                  jwarp.rotation_matrix(center, angle, 1.5))


@pytest.mark.parametrize("out_hw", [(80, 112), (60, 50), (20, 28), (37, 91)])
def test_resize_cubic_matches_jax_and_cv2(out_hw):
    oh, ow = out_hw
    img = np.random.RandomState(5).rand(2, 40, 56, 3).astype(np.float32)
    got = twarp.resize_cubic_cv2(torch.from_numpy(img), oh, ow).numpy()
    assert got.shape == (2, oh, ow, 3)
    want = np.asarray(jax.vmap(lambda im: jwarp.resize_cubic_cv2(im, oh, ow))(
        jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    for b in range(2):
        ref = cv2.resize(img[b], (ow, oh), interpolation=cv2.INTER_CUBIC)
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=2e-6)


def test_resize_cubic_of_stride_maps():
    """The TTA's map resize: 50 channels, crop-sized to base-sized."""
    maps = np.random.RandomState(6).randn(2, 24, 40, 50).astype(np.float32)
    got = twarp.resize_cubic_cv2(torch.from_numpy(maps), 16, 32).numpy()
    want = np.asarray(jax.vmap(lambda m: jwarp.resize_cubic_cv2(m, 16, 32))(
        jnp.asarray(maps)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fill", [0.0, 128 / 255.0, "vector"])
@pytest.mark.parametrize("angle", [10.0, -15.0])
def test_affine_warp_matches_jax(angle, fill):
    rng = np.random.RandomState(7)
    img = rng.rand(2, 48, 64, 3).astype(np.float32)
    fill_value = (np.float32([0.1, 0.5, 0.9]) if isinstance(fill, str)
                  else fill)
    inv = jwarp.rotation_matrix((32.0, 24.0), angle)
    got = twarp.affine_warp(torch.from_numpy(img), inv,
                            fill_value=fill_value).numpy()
    want = np.asarray(jax.vmap(lambda im: jwarp.affine_warp(
        im, inv, fill_value=fill_value))(jnp.asarray(img)))
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the corners rotate out of the canvas and take the fill
    np.testing.assert_array_equal(
        got[:, 0, 0], np.broadcast_to(np.float32(fill_value), (2, 3)))


def test_affine_warp_out_hw_matches_jax():
    img = np.random.RandomState(8).rand(30, 20, 5).astype(np.float32)
    inv = jwarp.rotation_matrix((10.0, 15.0), 25.0, scale=1.2)
    got = twarp.affine_warp(torch.from_numpy(img), inv, out_hw=(36, 28)).numpy()
    want = np.asarray(jwarp.affine_warp(jnp.asarray(img), inv, out_hw=(36, 28)))
    assert got.shape == (36, 28, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_affine_warp_identity_is_exact():
    img = torch.from_numpy(np.random.RandomState(9).rand(3, 16, 12, 2)
                           .astype(np.float32))
    out = twarp.affine_warp(img, twarp.rotation_matrix((6.0, 8.0), 0.0))
    assert torch.equal(out, img)
