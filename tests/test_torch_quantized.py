"""The port's quantised op variants (``ops/quantized.py``) against the JAX
package's (``ops/quantized.py``) on the CPU: the same values and parameters
from a seed.  Quantisation and dequantisation are the same float32 operations
(equal bit for bit), NMS keep masks are equal, and RoIAlign of a dequantised
map requantises to the same values except where the two bilinear sums land on
either side of a rounding half (within one step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops import quantized as jq
from cpu_vision_tpu_torch import ops


@pytest.mark.parametrize("dtype,jdtype", [(torch.uint8, jnp.uint8), (torch.int8, jnp.int8)])
def test_quantize_dequantize_match_jax(rng, dtype, jdtype):
    x = (rng.standard_normal((7, 33)) * 3).astype(np.float32)
    zp = 128 if dtype == torch.uint8 else 0
    got = ops.quantize(torch.from_numpy(x), 0.05, zp, dtype)
    ref = np.asarray(jq.quantize(jnp.asarray(x), 0.05, zp, jdtype))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ops.dequantize(got, 0.05, zp).numpy(), np.asarray(jq.dequantize(jnp.asarray(ref), 0.05, zp)))


def test_qnms_matches_jax(rng):
    xy = rng.uniform(0, 200, (60, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (60, 2))], axis=1).astype(np.float32)
    qboxes = np.clip(np.round(boxes / 2.0), 0, 255).astype(np.uint8)
    qscores = rng.integers(0, 256, 60).astype(np.uint8)
    got = ops.qnms(torch.from_numpy(qboxes), torch.from_numpy(qscores), 0.4, 2.0, 0)
    ref = np.asarray(jax.jit(lambda b, s: jq.qnms(b, s, 0.4, 2.0, 0))(jnp.asarray(qboxes), jnp.asarray(qscores)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_qroi_align_matches_jax(rng):
    feats = rng.integers(0, 256, (2, 24, 20, 5)).astype(np.uint8)
    rois = np.array([[0, 1.0, 2.0, 15.0, 18.0], [1, 3.5, 0.5, 19.0, 23.0], [0, 5.0, 5.0, 9.0, 7.0]], np.float32)
    got, s, zp = ops.qroi_align(torch.from_numpy(feats), torch.from_numpy(rois), 4, 0.1, 10, 1.0, 2, True)
    ref = jax.jit(lambda f, r: jq.qroi_align(f, r, 4, 0.1, 10, 1.0, 2, True)[0])(jnp.asarray(feats), jnp.asarray(rois))
    assert got.dtype == torch.uint8 and (s, zp) == (0.1, 10) and got.shape == tuple(ref.shape)
    assert np.abs(got.numpy().astype(int) - np.asarray(ref).astype(int)).max() <= 1
