"""The port's ``ops.pyramid`` against the JAX package's, on the same numpy
inputs (port on CPU tensors).

The 5-tap binomial blur runs the same float32 operations in the same order
on both sides (its taps are exact in float32), so the comparisons are
exact; the Laplacian round trip is held to ``atol=1e-5`` as in the JAX
package's tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops import pyramid as jp
from cpu_vision_tpu_torch.ops import pyramid as tp

SHAPES = [(32, 48, 3), (33, 47, 1), (2, 20, 26, 3), (17, 9)]


def _img(rng, shape, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


def _same(out, ref):
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape and out.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_pyr_down_matches_jax(rng, shape, dtype):
    img = _img(rng, shape, dtype)
    _same(tp.pyr_down(torch.from_numpy(img)), jp.pyr_down(jnp.asarray(img)))


@pytest.mark.parametrize("shape,size", [((16, 24, 3), None), ((17, 9), None), ((2, 10, 13, 3), (19, 25)),
                                        ((10, 13, 1), (20, 26)), ((10, 13, 1), (21, 27)), ((9, 9, 2), (17, 18))])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_pyr_up_matches_jax(rng, shape, size, dtype):
    # odd sizes: the stuffed rows end at the output's edge, the source rows at the input's
    img = _img(rng, shape, dtype)
    _same(tp.pyr_up(torch.from_numpy(img), size), jp.pyr_up(jnp.asarray(img), size))


@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_pyramid_matches_jax(rng, shape):
    img = _img(rng, shape, np.uint8)
    ours, ref = tp.gaussian_pyramid(torch.from_numpy(img), 3), jp.gaussian_pyramid(jnp.asarray(img), 3)
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        _same(o, r)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_laplacian_pyramid_matches_jax_and_reconstructs(rng, shape, dtype):
    img = _img(rng, shape, dtype)
    ours, ref = tp.laplacian_pyramid(torch.from_numpy(img), 4), jp.laplacian_pyramid(jnp.asarray(img), 4)
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        _same(o, r)
    rec = tp.reconstruct_from_laplacian(ours)
    _same(rec, jp.reconstruct_from_laplacian(ref))
    np.testing.assert_allclose(rec.numpy(), img.astype(np.float32), rtol=0, atol=1e-5 if dtype == np.float32 else 1e-3)


def test_constant_preserved():
    img = torch.full((16, 16, 1), 0.7)
    np.testing.assert_allclose(tp.pyr_down(img).numpy(), 0.7, atol=1e-5)
    np.testing.assert_allclose(tp.pyr_up(tp.pyr_down(img)).numpy()[2:-2, 2:-2], 0.7, atol=1e-5)
