"""The port's ``ops.filters`` against the JAX package's, on the same numpy
inputs (port on CPU tensors), plus the golden outputs.

Tolerances: the op-by-op paths run the same float32 operations in the same
order on both sides, so most comparisons are exact; ``atol=1e-6`` (plus
``rtol=1e-6`` for 0..255-scale magnitudes) where XLA's exp or sqrt can
differ from torch's in the last bit, and ``1e-5`` for the
grouped-convolution branch (another summation order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops import filters as jf
from cpu_vision_tpu.ops.pallas.stencil import _gaussian_taps as jax_kernel_taps
from cpu_vision_tpu_torch.ops import filters as tf
from cpu_vision_tpu_torch.ops.kernels.stencil import gaussian_taps

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "expect", "golden_kernels.npz"))
TAP_PAIRS = [(5, 1.4), (5, 1.5), (7, 2.0), (5, 1.0)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _img(rng, shape, dtype=np.float32):
    x = rng.random(shape)
    return (x * 255).astype(np.uint8) if dtype == np.uint8 else x.astype(dtype)


@pytest.mark.parametrize("ks,sigma", TAP_PAIRS)
def test_taps_bitwise(ks, sigma):
    # each of the port's two tap functions equals its JAX counterpart bit for
    # bit; the two JAX functions differ in the last bit for (5, 1.4) and (7, 2.0)
    np.testing.assert_array_equal(gaussian_taps(ks, sigma), jax_kernel_taps(ks, sigma))
    np.testing.assert_array_equal(
        tf.get_gaussian_kernel1d(ks, sigma, device="cpu").numpy(), np.asarray(jf.get_gaussian_kernel1d(ks, sigma)))


def test_gaussian_kernel2d_matches_jax():
    out = tf.get_gaussian_kernel2d((5, 7), (1.5, 2.0), device="cpu").numpy()
    np.testing.assert_array_equal(out, np.asarray(jf.get_gaussian_kernel2d((5, 7), (1.5, 2.0))))


@pytest.mark.parametrize("mode", ["reflect", "replicate", "constant", "circular", "symmetric"])
@pytest.mark.parametrize("shape,padding", [((6, 9), (2, 3, 1, 4)), ((6, 9, 2), 7), ((1, 3, 1, 1), (5, 4, 3, 2)), ((2, 4, 5, 3), 1)])
def test_pad2d_matches_jax(rng, mode, shape, padding):
    x = _img(rng, shape)
    out = tf.pad2d(_t(x), padding, mode=mode, value=0.5).numpy()
    np.testing.assert_array_equal(out, np.asarray(jf.pad2d(jnp.asarray(x), padding, mode=mode, value=0.5)))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_filter2d_matches_jax(rng, dtype):
    x = _img(rng, (2, 17, 23, 3), dtype)
    k = rng.random((3, 5)).astype(np.float32) - 0.3
    out = tf.filter2d(_t(x), k)
    assert out.dtype == _t(x).dtype
    np.testing.assert_array_equal(out.numpy(), np.asarray(jf.filter2d(jnp.asarray(x), jnp.asarray(k))))


def test_filter2d_large_kernel_uses_conv(rng):
    x = _img(rng, (19, 21, 2))
    k = rng.random((9, 9)).astype(np.float32) / 40  # 81 taps: grouped conv
    out = tf.filter2d(_t(x), k, mode="replicate").numpy()
    ref = np.asarray(jf.filter2d(jnp.asarray(x), jnp.asarray(k), mode="replicate"))
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_separable_filter2d_matches_jax(rng, dtype):
    x = _img(rng, (15, 22, 3), dtype)
    kx, ky = np.array([0.2, 0.5, 0.3], np.float32), np.array([0.1, 0.2, 0.4, 0.2, 0.1], np.float32)
    out = tf.separable_filter2d(_t(x), kx, ky, mode="reflect").numpy()
    np.testing.assert_array_equal(out, np.asarray(jf.separable_filter2d(jnp.asarray(x), kx, ky)))


@pytest.mark.parametrize(
    "dtype,ks,sigma,separable",
    [(np.float32, 5, 1.5, True), (np.float32, (3, 7), (0.8, 2.0), True), (np.uint8, 5, 1.5, True),
     (np.float32, 5, None, False), (np.uint8, (5, 3), None, True)],
)
def test_gaussian_blur_matches_jax(rng, dtype, ks, sigma, separable):
    x = _img(rng, (2, 20, 26, 3), dtype)
    out = tf.gaussian_blur(_t(x), ks, sigma, separable=separable)
    ref = np.asarray(jf.gaussian_blur(jnp.asarray(x), ks, sigma, separable=separable))
    assert out.dtype == _t(x).dtype
    # taps for sigma=None (1.1) may differ from XLA's in the last bit (its
    # exp); integer results are rounded and must be equal
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=0 if dtype == np.uint8 else 1e-6)


def test_golden_gaussian_blur_u8():
    out = tf.gaussian_blur(_t(GOLDEN["input_u8"]), 5, 1.5).numpy()
    np.testing.assert_array_equal(out, GOLDEN["gaussian_blur_u8"])


def test_golden_sobel_f32():
    np.testing.assert_allclose(tf.sobel(_t(GOLDEN["input_f32"])).numpy(), GOLDEN["sobel_f32"], atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_box_blur_matches_jax(rng, dtype):
    x = _img(rng, (18, 20), dtype)
    np.testing.assert_array_equal(tf.box_blur(_t(x), (3, 5)).numpy(), np.asarray(jf.box_blur(jnp.asarray(x), (3, 5))))


def test_stencil_kernels_match_jax():
    for tk, jk in ((tf.sobel_kernels, jf.sobel_kernels), (tf.scharr_kernels, jf.scharr_kernels)):
        for a, b in zip(tk(device="cpu"), jk()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", ["reflect", "replicate"])
def test_sobel_matches_jax(rng, mode):
    x = _img(rng, (2, 21, 19, 2), np.uint8)
    for a, b in zip(tf.sobel_gradients(_t(x), mode=mode), jf.sobel_gradients(jnp.asarray(x), mode=mode)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tf.sobel(_t(x), mode, eps=1e-6).numpy(),
                               np.asarray(jf.sobel(jnp.asarray(x), mode, eps=1e-6)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["sobel", "scharr", "diff"])
def test_spatial_gradient_matches_jax(rng, method):
    x = _img(rng, (16, 18, 3))
    for a, b in zip(tf.spatial_gradient(_t(x), method), jf.spatial_gradient(jnp.asarray(x), method)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_spatial_gradient_rejects_unknown_method():
    with pytest.raises(ValueError):
        tf.spatial_gradient(torch.zeros(4, 4), "prewitt")


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_laplacian_matches_jax(rng, dtype):
    x = _img(rng, (14, 15, 3), dtype)
    np.testing.assert_array_equal(tf.laplacian(_t(x)).numpy(), np.asarray(jf.laplacian(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("factor", [0.0, 0.5, 2.0])
def test_adjust_sharpness_matches_jax(rng, dtype, factor):
    x = _img(rng, (2, 13, 17, 3), dtype)
    out = tf.adjust_sharpness(_t(x), factor).numpy()
    np.testing.assert_allclose(out, np.asarray(jf.adjust_sharpness(jnp.asarray(x), factor)), atol=1e-6)


def test_adjust_sharpness_small_and_negative():
    x = torch.rand(2, 9, 3)
    assert tf.adjust_sharpness(x, 2.0) is x
    with pytest.raises(ValueError):
        tf.adjust_sharpness(x, -1.0)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_unsharp_mask_matches_jax(rng, dtype):
    x = _img(rng, (17, 19, 3), dtype)
    out = tf.unsharp_mask(_t(x), 5, 1.2, amount=0.7).numpy()
    np.testing.assert_allclose(out, np.asarray(jf.unsharp_mask(jnp.asarray(x), 5, 1.2, amount=0.7)), atol=1e-6)
