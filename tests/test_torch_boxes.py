"""The port's box ops and NMS (``cpu_vision_tpu_torch.ops.boxes`` and the
``nms_sorted`` twin in ``ops.kernels.nms``) against the JAX package's, on the
same numpy inputs on the CPU.

NMS keep masks must be equal bit for bit: to JAX's ``nms`` (the Jacobi
fixpoint) and to ``nms_sorted_pallas`` run in interpret mode, at the cases of
``tests/test_nms_pallas.py`` (random fields, dense long chains, N not a
multiple of the Pallas block of 128).  Box ops agree within 1e-6: the same
float32 formulas, XLA may contract a product and a sum into one rounding.
On CPU tensors the ``None`` route runs the twin; the kernel is held against
the twin on the card by ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops import boxes as jboxes
from cpu_vision_tpu.ops.pallas.nms import nms_sorted_pallas
from cpu_vision_tpu_torch import ops
from cpu_vision_tpu_torch.ops import boxes as tboxes
from cpu_vision_tpu_torch.ops.kernels import nms as tnms


def _field(rng, p, n, spread=30.0, extent=100.0, sort=True):
    ctr = rng.random((p, n, 2)) * extent
    wh = rng.random((p, n, 2)) * spread + 1
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = rng.random((p, n)).astype(np.float32)
    if sort:
        scores = np.sort(scores)[:, ::-1].copy()
    return boxes, scores


def _jax_nms(boxes, scores, thr):
    return np.asarray(jax.vmap(lambda b, s: jboxes.nms(b, s, thr))(jnp.asarray(boxes), jnp.asarray(scores)))


@pytest.mark.parametrize("n,p,thr", [(1000, 3, 0.5), (300, 1, 0.3), (130, 2, 0.5)])
def test_twin_matches_pallas_and_greedy(rng, n, p, thr):
    boxes, scores = _field(rng, p, n)
    got = tnms.nms_sorted_plain(torch.from_numpy(boxes), thr).numpy()
    np.testing.assert_array_equal(got, np.asarray(nms_sorted_pallas(jnp.asarray(boxes), thr, interpret=True)))
    np.testing.assert_array_equal(got, _jax_nms(boxes, scores, thr))
    assert 0 < got.sum() < got.size


def test_twin_matches_greedy_at_4096(rng):
    boxes, scores = _field(rng, 2, 4096)
    got = tnms.nms_sorted_plain(torch.from_numpy(boxes), 0.7).numpy()
    np.testing.assert_array_equal(got, _jax_nms(boxes, scores, 0.7))


def test_dense_overlaps_long_chains(rng):
    p, n = 2, 512
    ctr = rng.random((p, n, 2)) * 20  # a crowded field: deep suppression chains across blocks
    wh = rng.random((p, n, 2)) * 15 + 5
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = np.sort(rng.random((p, n)).astype(np.float32))[:, ::-1].copy()
    got = tnms.nms_sorted_plain(torch.from_numpy(boxes), 0.5).numpy()
    np.testing.assert_array_equal(got, np.asarray(nms_sorted_pallas(jnp.asarray(boxes), 0.5, interpret=True)))
    np.testing.assert_array_equal(got, _jax_nms(boxes, scores, 0.5))


def test_n_off_the_pallas_block(rng):
    boxes, scores = _field(rng, 1, 200)
    got = tnms.nms_sorted_plain(torch.from_numpy(boxes), 0.5).numpy()
    np.testing.assert_array_equal(got, np.asarray(nms_sorted_pallas(jnp.asarray(boxes), 0.5, interpret=True)))
    np.testing.assert_array_equal(got[0], np.asarray(jboxes.nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.5)))


def test_degenerate_boxes(rng):
    """Identical boxes keep the first only; zero-area boxes (union 0, and
    below the 1e-12 floor) suppress nothing and are suppressed by nothing."""
    same = np.tile(np.array([[10.0, 10.0, 30.0, 40.0]], np.float32), (5, 1))
    flat = np.array([[5.0, 5.0, 5.0, 9.0], [5.0, 5.0, 5.0, 9.0], [1.0, 2.0, 1.0, 2.0]], np.float32)
    for boxes in (same, flat):
        got = tnms.nms_sorted_plain(torch.from_numpy(boxes), 0.5).numpy()
        ref = np.asarray(nms_sorted_pallas(jnp.asarray(boxes), 0.5, interpret=True))
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tnms.nms_sorted_plain(torch.from_numpy(same), 0.5).numpy(), [1, 0, 0, 0, 0])
    assert tnms.nms_sorted_plain(torch.from_numpy(flat), 0.5).all()


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
def test_nms_sorts_stably_and_scatters_back(rng, ties):
    """``ops.nms`` on unsorted scores, with leading dims, against JAX's
    ``nms`` problem by problem; tied scores (quantised to 16 levels) take the
    order of a stable sort, as ``jnp.argsort(-scores)``."""
    boxes, scores = _field(rng, 6, 300, sort=False, extent=60.0)
    if ties:
        scores = np.floor(scores * 16) / 16
    ref = _jax_nms(boxes, scores, 0.5).reshape(2, 3, 300)
    boxes, scores = boxes.reshape(2, 3, 300, 4), scores.reshape(2, 3, 300)
    for backend in (None, "plain"):
        got = ops.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, backend=backend).numpy()
        np.testing.assert_array_equal(got, ref)


def test_batched_nms_and_nms_padded(rng):
    boxes, scores = _field(rng, 3, 400, sort=False, extent=50.0)
    idxs = rng.integers(0, 5, (3, 400))
    got = ops.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(idxs), 0.5).numpy()
    ref = jax.vmap(lambda b, s, i: jboxes.batched_nms(b, s, i, 0.5))(jnp.asarray(boxes), jnp.asarray(scores),
                                                                     jnp.asarray(idxs))
    np.testing.assert_array_equal(got, np.asarray(ref))
    # offsets near a 640 canvas and 90 classes: the shifted coordinates lose bits, the same bits on both sides
    canvas = (boxes[0] * 6.4).astype(np.float32)
    ids = rng.integers(0, 90, 400)
    got = ops.batched_nms(torch.from_numpy(canvas), torch.from_numpy(scores[0]), torch.from_numpy(ids), 0.5).numpy()
    ref = jboxes.batched_nms(jnp.asarray(canvas), jnp.asarray(scores[0]), jnp.asarray(ids), 0.5)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert ops.batched_nms(torch.zeros((0, 4)), torch.zeros(0), torch.zeros(0), 0.5).shape == (0,)
    idx, count = ops.nms_padded(torch.from_numpy(boxes[1]), torch.from_numpy(scores[1]), 0.4)
    ridx, rcount = jboxes.nms_padded(jnp.asarray(boxes[1]), jnp.asarray(scores[1]), 0.4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    assert int(count) == int(rcount) and int(count) < 400  # padded with -1
    short, _ = ops.nms_padded(torch.from_numpy(boxes[1]), torch.from_numpy(scores[1]), 0.4, 50)
    np.testing.assert_array_equal(short.numpy(), idx.numpy()[:50])


def test_top_k_gives_ties_to_the_lower_index(rng):
    x = np.floor(rng.random((4, 257)) * 8).astype(np.float32)
    values, indices = tboxes.top_k(torch.from_numpy(x), 100)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 100)
    np.testing.assert_array_equal(values.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(indices.numpy(), np.asarray(ri))


def test_nms_routes(rng):
    boxes, scores = _field(rng, 2, 50)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    with pytest.raises(ValueError, match="CUDA"):
        ops.nms(b, s, 0.5, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        ops.nms(b, s, 0.5, backend="xla")
    with pytest.raises(ValueError):
        ops.nms(b, s[:, :10], 0.5)
    with pytest.raises(TypeError):
        tnms.nms_sorted(b.to(torch.int32), 0.5)
    with pytest.raises(ValueError, match="13600"):
        tnms.require_kernel(torch.zeros((1, tnms.MAX_BOXES + 1, 4)))
    # bfloat16 boxes are widened to float32 for the IoUs, as the Pallas kernel does
    got = ops.nms(b.to(torch.bfloat16), s, 0.5).numpy()
    np.testing.assert_array_equal(got, np.asarray(nms_sorted_pallas(jnp.asarray(boxes, jnp.bfloat16), 0.5,
                                                                     interpret=True)))


def test_recording_sees_launches_only(rng):
    """``recording`` lists the kernel's launches: the twin that a CPU tensor
    takes is none, and the list stops growing when its block ends."""
    boxes, scores = _field(rng, 2, 50)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    with tnms.recording() as calls:
        ops.nms(b, s, 0.5)
        tnms.nms_sorted(b, 0.7)
    assert calls == [] and tnms._recorders == []


@pytest.fixture
def box_pairs(rng):
    a, _ = _field(rng, 1, 37, extent=50.0, sort=False)
    b, _ = _field(rng, 1, 23, extent=50.0, sort=False)
    return a[0], b[0]


@pytest.mark.parametrize("name", ["box_iou", "generalized_box_iou", "distance_box_iou", "complete_box_iou"])
def test_iou_family(box_pairs, name):
    a, b = box_pairs
    got = getattr(ops, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(getattr(jboxes, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_box_convert_area_clip_small(box_pairs):
    a, _ = box_pairs
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    for fin in ("xyxy", "xywh", "cxcywh"):
        for fout in ("xyxy", "xywh", "cxcywh"):
            np.testing.assert_allclose(ops.box_convert(ta, fin, fout).numpy(),
                                       np.asarray(jboxes.box_convert(ja, fin, fout)), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        ops.box_convert(ta, "xyxy", "yxyx")
    np.testing.assert_allclose(ops.box_area(ta).numpy(), np.asarray(jboxes.box_area(ja)), rtol=1e-6)
    np.testing.assert_array_equal(ops.clip_boxes_to_image(ta, (30, 40)).numpy(),
                                  np.asarray(jboxes.clip_boxes_to_image(ja, (30, 40))))
    np.testing.assert_array_equal(ops.remove_small_boxes(ta, 12.0).numpy(),
                                  np.asarray(jboxes.remove_small_boxes(ja, 12.0)))


def test_masks_to_boxes(rng):
    masks = rng.random((4, 17, 23)) > 0.97
    masks[2] = False
    got = ops.masks_to_boxes(torch.from_numpy(masks))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jboxes.masks_to_boxes(jnp.asarray(masks))))
