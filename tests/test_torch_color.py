"""The port's ``ops.color`` against the JAX package's, on the same numpy
inputs (port on CPU tensors), plus the golden equalisation.

Tolerances: float results ``atol=1e-5`` as in the JAX package's tests (both
sides run the same float32 operations; XLA may fuse a product into a sum,
and ``pow`` may differ in the last bit); uint8 results within 1 LSB where
they pass through float arithmetic, and exactly for the integer ops
(invert, posterize, solarize, equalize).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu import ops as jops
from cpu_vision_tpu_torch import ops as tops

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "expect", "golden_kernels.npz"))
DTYPES = [np.float32, np.uint8]


def _img(rng, shape, dtype=np.float32):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


def _check(name, img, *args, exact=False):
    ref = np.asarray(getattr(jops, name)(jnp.asarray(img), *args))
    out = getattr(tops, name)(torch.from_numpy(img), *args)
    assert tuple(out.shape) == ref.shape and out.numpy().dtype == ref.dtype, (out.shape, out.dtype, ref.shape, ref.dtype)
    if exact:
        np.testing.assert_array_equal(out.numpy(), ref)
    elif ref.dtype == np.uint8:
        assert np.abs(out.numpy().astype(np.int32) - ref.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ratio", [0.0, 0.3, 1.0, 1.7])
def test_blend(rng, dtype, ratio):
    a, b = _img(rng, (9, 11, 3), dtype), _img(rng, (9, 11, 3), dtype)
    ref = np.asarray(jops.blend(jnp.asarray(a), jnp.asarray(b), ratio))
    out = tops.blend(torch.from_numpy(a), torch.from_numpy(b), ratio)
    assert out.numpy().dtype == ref.dtype
    if dtype == np.uint8:
        assert np.abs(out.numpy().astype(np.int32) - ref.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(16, 16, 3), (2, 8, 9, 3)])
def test_hsv_round_trip_matches_jax(rng, shape):
    img = _img(rng, shape)
    img[0, 0] = 0.5  # a gray pixel: max == min
    _check("rgb_to_hsv", img)
    hsv = np.array(jops.rgb_to_hsv(jnp.asarray(img)))
    _check("hsv_to_rgb", hsv)
    back = tops.hsv_to_rgb(tops.rgb_to_hsv(torch.from_numpy(img)))
    np.testing.assert_allclose(back.numpy(), img, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,arg", [("adjust_brightness", 0.0), ("adjust_brightness", 1.6), ("adjust_contrast", 0.4),
                                      ("adjust_contrast", 1.8), ("adjust_saturation", 0.0), ("adjust_saturation", 1.5),
                                      ("adjust_hue", -0.3), ("adjust_hue", 0.0), ("adjust_hue", 0.45),
                                      ("adjust_gamma", 0.5), ("adjust_gamma", 2.2)])
@pytest.mark.parametrize("shape", [(12, 12, 3), (2, 7, 9, 3)])
def test_adjust_rgb(rng, dtype, name, arg, shape):
    _check(name, _img(rng, shape, dtype), arg)


ONE_CHANNEL = [("adjust_brightness", 1.3), ("adjust_contrast", 0.6), ("adjust_saturation", 0.5),
               ("adjust_hue", 0.2), ("adjust_gamma", 0.7)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,arg", ONE_CHANNEL)
def test_adjust_one_channel(rng, dtype, name, arg):
    _check(name, _img(rng, (10, 12, 1), dtype), arg)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,arg", ONE_CHANNEL)
def test_adjust_hw_image(rng, dtype, name, arg):
    # an HW image is one channel; JAX's adjust_contrast takes it only as HW1
    img = _img(rng, (10, 12), dtype)
    out = getattr(tops, name)(torch.from_numpy(img), arg)
    ref = np.asarray(getattr(jops, name)(jnp.asarray(img[..., None]), arg))[..., 0]
    assert tuple(out.shape) == (10, 12) and out.numpy().dtype == ref.dtype
    np.testing.assert_allclose(out.numpy().astype(np.float32), ref.astype(np.float32), rtol=0,
                               atol=1 if dtype == np.uint8 else 1e-5)


@pytest.mark.parametrize("name", ["adjust_brightness", "adjust_contrast", "adjust_saturation", "adjust_gamma"])
def test_negative_factor_raises(name):
    with pytest.raises(ValueError):
        getattr(tops, name)(torch.zeros(4, 4, 3), -0.1)
    with pytest.raises(ValueError):
        tops.adjust_hue(torch.zeros(4, 4, 3), 0.6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_invert_and_solarize(rng, dtype):
    img = _img(rng, (9, 10, 3), dtype)
    _check("invert", img, exact=True)
    _check("solarize", img, 128 if dtype == np.uint8 else 0.5, exact=True)


@pytest.mark.parametrize("bits", [1, 3, 4, 8])
def test_posterize(rng, bits):
    _check("posterize", _img(rng, (8, 8, 3), np.uint8), bits, exact=True)
    _check("posterize", _img(rng, (8, 8, 3)), bits)
    with pytest.raises(TypeError):
        tops.posterize(torch.zeros(2, 2, dtype=torch.int32), 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(12, 14, 3), (2, 6, 7, 1), (9, 9)])
def test_autocontrast(rng, dtype, shape):
    img = _img(rng, shape, dtype)
    if dtype == np.uint8:
        img = (img // 2 + 40).astype(np.uint8)
    _check("autocontrast", img)
    flat = np.full(shape, 7 if dtype == np.uint8 else 0.3, dtype)  # max == min: unchanged
    _check("autocontrast", flat, exact=True)


@pytest.mark.parametrize("shape", [(32, 32, 3), (2, 16, 20, 3), (24, 24)])
def test_equalize_matches_jax_exactly(rng, shape):
    img = (rng.normal(120, 30, shape).clip(0, 255)).astype(np.uint8)
    _check("equalize", img, exact=True)
    _check("equalize", np.full(shape, 9, np.uint8), exact=True)  # one bin: step 0, unchanged
    with pytest.raises(TypeError):
        tops.equalize(torch.zeros(4, 4, 3))


def test_normalize(rng):
    img = _img(rng, (8, 8, 3))
    _check("normalize", img, [0.5, 0.4, 0.3], [0.25, 0.2, 0.3])
    with pytest.raises(TypeError):
        tops.normalize(torch.zeros(4, 4, 3, dtype=torch.uint8), [0.5] * 3, [0.2] * 3)


def test_golden_equalize_u8():
    np.testing.assert_array_equal(tops.equalize(torch.from_numpy(GOLDEN["input_u8"])).numpy(), GOLDEN["equalize_u8"])
