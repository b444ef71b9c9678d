"""The port's ``ops.warp`` against the JAX package's, on the same numpy
inputs (port on CPU tensors), plus the golden rotation.

Tolerances: sampling grids ``atol=1e-6`` (both sides multiply the same
float32 base grid by the same float32 matrix; XLA may fuse a product into
the sum), float warps ``atol=1e-4`` as the JAX tests hold them to the
reference, uint8 warps within 1 LSB, the ``rotate30_u8`` golden exactly.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu import ops as jops
from cpu_vision_tpu_torch import ops as tops

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "expect", "golden_kernels.npz"))
ROT20 = [math.cos(math.radians(20)), -math.sin(math.radians(20)), 1.5,
         math.sin(math.radians(20)), math.cos(math.radians(20)), -2.0]
COEFFS = [1.05, 0.08, -1.5, -0.04, 0.95, 2.0, 0.0008, -0.0011]


def _img(rng, shape, dtype=np.float32):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


def _close(out, ref, dtype=np.float32):
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape and out.numpy().dtype == ref.dtype
    if dtype == np.uint8:
        assert np.abs(out.numpy().astype(np.int32) - ref.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax(rng, mode, padding_mode, align_corners):
    img = _img(rng, (2, 12, 17, 3))
    grid = (rng.random((2, 9, 11, 2), dtype=np.float32) * 2.4 - 1.2).astype(np.float32)
    ref = jops.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode, padding_mode, align_corners)
    out = tops.grid_sample(torch.from_numpy(img), torch.from_numpy(grid), mode, padding_mode, align_corners)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_grid_sample_nearest_rounds_half_to_even():
    img = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    # pixel coordinates 0.5, 1.5, 2.5 along x on row 1: halves go to the even index
    xs = (np.array([0.5, 1.5, 2.5], np.float32) * 2 + 1) / 4 - 1
    grid = np.stack([xs, np.full(3, (1 * 2 + 1) / 4 - 1, np.float32)], -1).reshape(1, 1, 3, 2)
    ref = np.asarray(jops.grid_sample(jnp.asarray(img), jnp.asarray(grid), "nearest"))
    out = tops.grid_sample(torch.from_numpy(img), torch.from_numpy(grid), "nearest")
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy().ravel(), [4.0, 6.0, 6.0])
    with pytest.raises(ValueError):
        tops.grid_sample(torch.from_numpy(img), torch.from_numpy(grid), "bicubic")
    with pytest.raises(ValueError):
        tops.grid_sample(torch.from_numpy(img), torch.from_numpy(grid), "nearest", "reflection")


@pytest.mark.parametrize("w,h,ow,oh", [(20, 16, 20, 16), (96, 64, 96, 64), (7, 5, 11, 9), (640, 480, 640, 480)])
def test_affine_grid_matches_jax(w, h, ow, oh):
    ref = np.asarray(jops.affine_grid(ROT20, w, h, ow, oh))
    out = tops.affine_grid(ROT20, w, h, ow, oh, device="cpu")
    assert tuple(out.shape) == (1, oh, ow, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ow,oh", [(13, 11), (96, 64)])
def test_perspective_grid_matches_jax(ow, oh):
    ref = np.asarray(jops.perspective_grid(COEFFS, ow, oh))
    out = tops.perspective_grid(COEFFS, ow, oh, device="cpu")
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("fill", [None, 0.25, [0.5, 0.25, 1.0]])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_affine_matches_jax(rng, mode, fill, dtype):
    img = _img(rng, (16, 20, 3), dtype)
    if dtype == np.uint8 and fill is not None:
        fill = 7 if isinstance(fill, float) else [10, 20, 30]
    ref = jops.affine(jnp.asarray(img), ROT20, mode, fill)
    _close(tops.affine(torch.from_numpy(img), ROT20, mode, fill), ref, dtype)
    assert tops.warp_affine is tops.affine


@pytest.mark.parametrize("angle,expand,center", [(30.0, False, None), (90.0, True, None), (-45.0, True, None),
                                                 (17.0, False, (3.0, 5.0))])
@pytest.mark.parametrize("shape,dtype", [((12, 20, 3), np.float32), ((2, 12, 20, 1), np.uint8), ((15, 11), np.float32)])
def test_rotate_matches_jax(rng, angle, expand, center, shape, dtype):
    img = _img(rng, shape, dtype)
    ref = jops.rotate(jnp.asarray(img), angle, "bilinear", expand, center, fill=0)
    _close(tops.rotate(torch.from_numpy(img), angle, "bilinear", expand, center, fill=0), ref, dtype)


def test_rotate_90_is_rot90(rng):
    img = _img(rng, (12, 12, 1))
    out = tops.rotate(torch.from_numpy(img), 90.0, interpolation="bilinear")
    np.testing.assert_allclose(out.numpy(), np.rot90(img, 1, axes=(0, 1)), atol=1e-3)
    assert tuple(tops.rotate(torch.from_numpy(_img(rng, (10, 20, 1))), 90.0, expand=True).shape) == (20, 10, 1)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_perspective_matches_jax(rng, mode, dtype):
    img = _img(rng, (2, 11, 13, 3), dtype)
    ref = jops.perspective(jnp.asarray(img), COEFFS, mode, fill=3)
    _close(tops.perspective(torch.from_numpy(img), COEFFS, mode, fill=3), ref, dtype)
    ident = tops.perspective(torch.from_numpy(img), [1, 0, 0, 0, 1, 0, 0, 0])
    _close(ident, img, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_elastic_matches_jax(rng, dtype):
    img = _img(rng, (8, 10, 3), dtype)
    disp = (rng.random((1, 8, 10, 2), dtype=np.float32) - 0.5) * 0.3
    ref = jops.elastic(jnp.asarray(img), jnp.asarray(disp), fill=1)
    _close(tops.elastic(torch.from_numpy(img), torch.from_numpy(disp), fill=1), ref, dtype)
    zero = tops.elastic(torch.from_numpy(img), torch.zeros(1, 8, 10, 2))
    _close(zero, img, dtype)


@pytest.mark.parametrize("args", [((0.0, 0.0), 30.0, (0.0, 0.0), 1.0, (0.0, 0.0)),
                                  ((2.5, -1.0), -75.0, (3.0, 4.0), 1.3, (10.0, -5.0))])
def test_matrices_match_jax(args):
    assert tops.get_inverse_affine_matrix(*args) == jops.get_inverse_affine_matrix(*args)
    assert tops.get_rotation_matrix(args[1], args[0]) == jops.get_rotation_matrix(args[1], args[0])


def test_golden_rotate30_u8():
    out = tops.rotate(torch.from_numpy(GOLDEN["input_u8"]), 30.0, "bilinear", fill=0)
    np.testing.assert_array_equal(out.numpy(), GOLDEN["rotate30_u8"])
