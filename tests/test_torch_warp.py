"""``ops/warp.py::affine_warp`` in the port against the JAX package's, on the CPU.

The cases of tests/test_warp_and_pipeline.py:11-45 (identity, a one-pixel
translation, a 20-degree rotation held against cv2's inverse-map warp) run
through both packages on the same arrays, with nearest sampling and a
projective uint8 case with a fill value besides; the outputs agree to atol
1e-5 on unit-scale images and 1e-4 of the range on 0..255 ones (float32
bilinear taps summed in another order), the translation exactly.
"""

import numpy as np
import pytest
import torch


def _both(img, t, **kw):
    import jax.numpy as jnp

    from casapose_tpu.ops.warp import affine_warp as jax_warp
    from casapose_tpu_torch.ops.warp import affine_warp

    want = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(t), **kw))
    got = affine_warp(torch.from_numpy(img), torch.from_numpy(t), **kw).numpy()
    return got, want


def test_identity():
    img = np.random.default_rng(0).normal(size=(2, 8, 10, 3)).astype(np.float32)
    t = np.tile(np.array([1, 0, 0, 0, 1, 0, 0, 0], np.float32), (2, 1))
    got, want = _both(img, t)
    np.testing.assert_allclose(got, img, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_translation():
    img = np.zeros((1, 6, 6, 1), np.float32)
    img[0, 2, 3, 0] = 1.0
    got, want = _both(img, np.array([[1, 0, 1, 0, 1, 0, 0, 0]], np.float32))
    assert got[0, 2, 2, 0] == 1.0 and got[0, 2, 3, 0] == 0.0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_rotation_matches_jax_and_cv2(interpolation):
    import cv2

    from casapose_tpu_torch.pose.geometry import get_rotation_matrix_2D_np

    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (1, 32, 40, 3)).astype(np.float32)
    rm = get_rotation_matrix_2D_np((20.0, 16.0), 20.0)
    m3 = np.eye(3, dtype=np.float32)
    m3[:2] = rm
    got, want = _both(img, m3[None], interpolation=interpolation)
    np.testing.assert_allclose(got, want, atol=1e-4 * 255)
    if interpolation == "bilinear":
        ref = cv2.warpAffine(img[0], rm, (40, 32), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        np.testing.assert_allclose(got[0, 4:-4, 4:-4], ref[4:-4, 4:-4], atol=1.0)


def test_projective_rows_on_uint8_with_fill():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, 12, 16, 3)).astype(np.uint8)
    t = np.array([[1.1, 0.05, -2.0, -0.03, 0.95, 1.5, 0.002, -0.001],
                  [0.9, -0.1, 3.0, 0.1, 1.05, -2.0, 0.0, 0.003]], np.float32)
    got, want = _both(img, t, fill_value=-1.0)
    assert got.dtype == np.float32 and (got == -1.0).any()
    np.testing.assert_allclose(got, want, atol=1e-4 * 255)
