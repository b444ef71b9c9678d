"""The port's ``ops.resize`` against the JAX package's, on the same numpy
inputs (port on CPU tensors), plus the golden outputs.

Both sides contract the same float32 weight matrices with the image in full
float32; only the order of the sums differs.  Tolerances: float results
``atol=1e-5`` (``1e-3`` on 0..255-scale inputs); uint8 results within 1 LSB
as the JAX tests hold them to the reference, and exactly on the goldens;
nearest modes and the weight matrices exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu import ops as jr
from cpu_vision_tpu_torch import ops as tr

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "expect", "golden_kernels.npz"))
SIZES = [((32, 48), (16, 24)), ((32, 48), (64, 96)), ((37, 23), (20, 40)), ((16, 16), (31, 7))]


def _img(rng, shape, dtype=np.float32):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("sizes", [(32, 16), (32, 64), (37, 20), (16, 31), (16, 7), (5, 5)])
def test_weight_matrix_is_the_jax_package_s(mode, antialias, sizes):
    ours = tr.resize_weight_matrix(*sizes, mode, antialias)
    assert ours.dtype == np.float32 and ours.shape == sizes[::-1]
    np.testing.assert_array_equal(ours, jr.resize_weight_matrix(*sizes, mode, antialias))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("insize,outsize", SIZES)
def test_float_matches_jax(rng, mode, antialias, insize, outsize):
    img = _img(rng, (*insize, 3))
    ref = np.asarray(jr.resize(jnp.asarray(img), outsize, mode, antialias))
    out = tr.resize(torch.from_numpy(img), outsize, mode, antialias)
    assert out.dtype == torch.float32 and tuple(out.shape) == (*outsize, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("insize,outsize", SIZES)
def test_uint8_matches_jax_within_1lsb(rng, mode, antialias, insize, outsize):
    img = _img(rng, (2, *insize, 3), np.uint8)
    ref = np.asarray(jr.resize(jnp.asarray(img), outsize, mode, antialias))
    out = tr.resize(torch.from_numpy(img), outsize, mode, antialias)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (2, *outsize, 3)
    assert np.abs(out.numpy().astype(np.int32) - ref.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("mode", ["nearest", "nearest-exact"])
@pytest.mark.parametrize("insize,outsize", SIZES + [((9, 9), (9, 9))])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_nearest_matches_jax_exactly(rng, mode, insize, outsize, dtype):
    img = _img(rng, (*insize, 2), dtype)
    ref = np.asarray(jr.resize(jnp.asarray(img), outsize, mode))
    np.testing.assert_array_equal(tr.resize(torch.from_numpy(img), outsize, mode).numpy(), ref)


def test_hw_image_and_same_size(rng):
    img = _img(rng, (12, 10))
    out = tr.resize(torch.from_numpy(img), (6, 10), "bilinear", True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jr.resize(jnp.asarray(img), (6, 10), "bilinear", True)),
                               rtol=0, atol=1e-5)
    assert torch.equal(tr.resize(torch.from_numpy(img), (12, 10)), torch.from_numpy(img))
    with pytest.raises(ValueError):
        tr.resize(torch.from_numpy(img), (6, 6), "lanczos")


@pytest.mark.parametrize("factor", [0.5, 2, (0.3, 1.7)])
def test_rescale_matches_jax(rng, factor):
    img = _img(rng, (21, 30, 3))
    ref = np.asarray(jr.rescale(jnp.asarray(img), factor))
    out = tr.rescale(torch.from_numpy(img), factor)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_golden_resize_bilinear_aa_u8():
    out = tr.resize(torch.from_numpy(GOLDEN["input_u8"]), (32, 48), "bilinear", True)
    np.testing.assert_array_equal(out.numpy(), GOLDEN["resize_bilinear_aa_u8"])


def test_golden_resize_bicubic_u8():
    out = tr.resize(torch.from_numpy(GOLDEN["input_u8"]), (96, 128), "bicubic", False)
    np.testing.assert_array_equal(out.numpy(), GOLDEN["resize_bicubic_u8"])
