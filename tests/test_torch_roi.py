"""The port's RoIAlign and multi-scale pooling (``cpu_vision_tpu_torch.ops.roi``
and ``ops.poolers``) against the JAX package's, on the same numpy inputs on
the CPU.

Float32 results agree within 1e-5: the same gathers and weights, the sums
over samples in another order (and XLA may contract a product into a sum).
The rois include the edge cases of ``tests/test_faster_rcnn.py``: rois on
the map's bottom-right edge, with negative starts, larger than the map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops import poolers as jpoolers
from cpu_vision_tpu.ops import roi as jroi
from cpu_vision_tpu_torch import ops

SCALES = [1 / 4, 1 / 8, 1 / 16, 1 / 32]
EDGE_ROIS = np.array([
    [0, 5.0, 5, 60, 60],
    [1, 0.0, 0, 319, 319],
    [0, 100.0, 100, 319, 300],
    [1, 310.0, 310, 320, 320],   # clamps at the bottom-right edge
    [0, -4.0, -4, 30, 30],       # negative start
    [1, 40.0, 8, 296, 160],
    [0, 3.0, 2, 3.5, 2.2],       # under one pixel
    [1, -30.0, 200, 400, 420],   # beyond the map on three sides
], np.float32)


@pytest.fixture
def pyramid(rng):
    return [rng.random((2, 80 // 2 ** i, 80 // 2 ** i, 16), dtype=np.float32) for i in range(4)]


def _close(got, ref, tol=1e-5):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(ref),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("sampling_ratio,aligned", [(2, False), (-1, False), (3, True), (-1, True)])
def test_roi_align_matches_jax(pyramid, sampling_ratio, aligned):
    f = pyramid[0]
    got = ops.roi_align(torch.from_numpy(f), torch.from_numpy(EDGE_ROIS), (7, 7), 1 / 4, sampling_ratio, aligned)
    ref = jroi.roi_align(jnp.asarray(f), jnp.asarray(EDGE_ROIS), (7, 7), 1 / 4, sampling_ratio, aligned)
    assert got.shape == (8, 7, 7, 16) and got.dtype == torch.float32
    _close(got, ref)


def test_roi_align_pyramid_matches_jax(rng, pyramid):
    levels = rng.integers(0, 4, len(EDGE_ROIS))
    got = ops.roi_align_pyramid([torch.from_numpy(f) for f in pyramid], torch.from_numpy(EDGE_ROIS),
                                torch.from_numpy(levels), (7, 7), SCALES)
    ref = jroi.roi_align_pyramid([jnp.asarray(f) for f in pyramid], jnp.asarray(EDGE_ROIS), jnp.asarray(levels),
                                 (7, 7), SCALES)
    _close(got, ref)
    with pytest.raises(ValueError):
        ops.roi_align_pyramid([torch.from_numpy(f) for f in pyramid], torch.from_numpy(EDGE_ROIS),
                              torch.from_numpy(levels), (7, 7), SCALES, sampling_ratio=-1)


def test_multiscale_roi_align_matches_jax_and_all_levels(pyramid):
    feats = [torch.from_numpy(f) for f in pyramid]
    got = ops.multiscale_roi_align(feats, torch.from_numpy(EDGE_ROIS), (7, 7), SCALES)
    ref = jpoolers.multiscale_roi_align([jnp.asarray(f) for f in pyramid], jnp.asarray(EDGE_ROIS), (7, 7), SCALES)
    _close(got, ref)
    # every roi pooled at every level and its own level selected: the same numbers
    every = ops.multiscale_roi_align(feats, torch.from_numpy(EDGE_ROIS), (7, 7), SCALES, all_levels=True)
    _close(every, got.numpy(), 1e-6)
    pooler = ops.MultiScaleRoIAlign(7)
    _close(pooler(feats, torch.from_numpy(EDGE_ROIS), (320, 320)), got.numpy(), 0)


def test_level_mapper_matches_jax(rng):
    sides = np.concatenate([rng.uniform(1, 900, 300), [56.0, 112.0, 224.0, 448.0, 10.0]])
    boxes = np.stack([np.zeros_like(sides), np.zeros_like(sides), sides, sides * rng.uniform(0.5, 2, sides.size)],
                     -1).astype(np.float32)
    got = ops.LevelMapper(2, 5)(torch.from_numpy(boxes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpoolers.LevelMapper(2, 5)(jnp.asarray(boxes))))
    assert set(got.tolist()) == {0, 1, 2, 3}


def test_bfloat16_features_pool_in_float32(pyramid):
    """bfloat16 maps: weights in bfloat16, the pooling sum in float32, the
    result cast back; within two bfloat16 steps of the float32 pooling."""
    f = torch.from_numpy(pyramid[0])
    got = ops.roi_align(f.to(torch.bfloat16), torch.from_numpy(EDGE_ROIS), (7, 7), 1 / 4, 2)
    assert got.dtype == torch.bfloat16
    ref = ops.roi_align(f, torch.from_numpy(EDGE_ROIS), (7, 7), 1 / 4, 2)
    assert float((got.float() - ref).abs().max()) <= 2 * 2 ** -8
