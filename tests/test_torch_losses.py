"""The port's detection losses (``ops.sigmoid_focal_loss`` and the three box
IoU losses) against the JAX package's ``ops/losses.py`` on the CPU: values
and gradients (``torch.autograd`` against ``jax.grad``) of every reduction in
float32, on the same numpy inputs.  Both sides run the same float32
operations, in orders that may differ by an ulp: held to 1e-6 relative
(with 1e-6 absolute beside zeros).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops import losses as jlosses
from cpu_vision_tpu_torch import ops

REDUCTIONS = ["none", "mean", "sum"]
BOX_LOSSES = ["generalized_box_iou_loss", "distance_box_iou_loss", "complete_box_iou_loss"]


def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(1, 30, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


def _check(name, inputs, kwargs, reduction, weights):
    """Values and the gradient of every input of ``name`` on both sides; for "none" the gradient is that of the
    losses weighted by ``weights``."""
    def jax_loss(*xs):
        out = getattr(jlosses, name)(*xs, reduction=reduction, **kwargs)
        return out, (out * jnp.asarray(weights)).sum() if reduction == "none" else out

    ref, vjp = jax.vjp(lambda *xs: jax_loss(*xs)[1], *(jnp.asarray(x) for x in inputs))
    ref_grads = vjp(jnp.ones((), jnp.float32))
    ref_out = jax_loss(*(jnp.asarray(x) for x in inputs))[0]
    ts = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = getattr(ops, name)(*ts, reduction=reduction, **kwargs)
    assert out.dtype == torch.float32 and out.shape == tuple(ref_out.shape)
    _close(out.detach().numpy(), ref_out)
    scalar = (out * torch.from_numpy(weights)).sum() if reduction == "none" else out
    scalar.backward()
    for t, g in zip(ts, ref_grads):
        _close(t.grad.numpy(), g)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (-1.0, 1.5)], ids=["alpha", "no-alpha"])
def test_sigmoid_focal_loss_matches_jax(rng, reduction, alpha, gamma):
    logits = (rng.standard_normal((6, 7)) * 3).astype(np.float32)
    targets = (rng.random((6, 7)) < 0.3).astype(np.float32)
    weights = rng.random((6, 7)).astype(np.float32)
    _check("sigmoid_focal_loss", [logits, targets], dict(alpha=alpha, gamma=gamma), reduction, weights)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", BOX_LOSSES)
def test_box_iou_losses_match_jax(rng, name, reduction):
    boxes1, boxes2 = _boxes(rng, 12), _boxes(rng, 12)
    boxes2[:3] = boxes1[:3] + rng.uniform(-2, 2, (3, 4)).astype(np.float32)  # overlapping pairs, and apart ones
    _check(name, [boxes1, boxes2], {}, reduction, rng.random(12).astype(np.float32))


def test_bad_reduction_raises_as_in_jax(rng):
    boxes = _boxes(rng, 3)
    for fn, xs in [(jlosses.generalized_box_iou_loss, [jnp.asarray(boxes)] * 2),
                   (ops.generalized_box_iou_loss, [torch.from_numpy(boxes)] * 2),
                   (jlosses.sigmoid_focal_loss, [jnp.zeros((2, 3))] * 2),
                   (ops.sigmoid_focal_loss, [torch.zeros(2, 3)] * 2)]:
        with pytest.raises(ValueError, match="invalid reduction"):
            fn(*xs, reduction="max")
