"""The port's pointwise convolution (``cpu_vision_tpu_torch.ops.pointwise``)
against the JAX package's ``conv1x1`` under ``jax.grad``, and against stock
``conv2d`` autograd, on the same numpy inputs on the CPU.

Float32 forward and ``dx`` agree within ``1e-5``, ``dW`` within
``1e-4·(1 + |ref|)`` (sums over N·H·W rows in other orders); bfloat16 within
``2e-2·(1 + |ref|)`` (one bfloat16 step is 2^-8 of the value).  On CPU
tensors the weight gradient is the twin of ``wgrad_matmul`` on either side of
the 16,384-row switch; the card's side of the switch is held by
``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cpu_vision_tpu.ops import pointwise as jpw
from cpu_vision_tpu_torch import models, ops
from cpu_vision_tpu_torch.ops import kernels, pointwise


def _grads_jax(x, k, stride, dtype=jnp.float32):
    def loss(x, k):
        return jnp.sum(jnp.sin(jpw.conv1x1(x, k, stride).astype(jnp.float32)))

    xj, kj = jnp.asarray(x, dtype), jnp.asarray(k, dtype)
    return jpw.conv1x1(xj, kj, stride), *jax.grad(loss, argnums=(0, 1))(xj, kj)


def _grads_port(x, k, stride, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    kt = torch.from_numpy(k).to(dtype).requires_grad_()
    y = ops.conv1x1(xt, kt, stride)
    torch.sin(y.float()).sum().backward()
    return y, xt.grad, kt.grad


def _close(out, ref, tol):
    out, ref = out.detach().float().numpy(), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.all(np.abs(out - ref) <= tol * (1 + np.abs(ref))), np.abs(out - ref).max()


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (4, 64, 64, 8)], ids=["small", "16384-rows"])
@pytest.mark.parametrize("stride", [1, 2])
def test_forward_and_grads_match_jax(rng, shape, stride):
    x = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((1, 1, shape[3], 24)).astype(np.float32)
    y_ref, dx_ref, dk_ref = _grads_jax(x, k, stride)
    y, dx, dk = _grads_port(x, k, stride)
    assert y.shape == y_ref.shape and dx.shape == x.shape and dk.shape == k.shape
    _close(y, y_ref, 1e-5)
    _close(dx, dx_ref, 1e-5)
    _close(dk, dk_ref, 1e-4)
    assert kernels.launch_counts()["wgrad_matmul"] == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("stride", [1, 2])
def test_bfloat16_matches_jax(rng, stride):
    x = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    k = (rng.standard_normal((1, 1, 32, 16)) * 32 ** -0.5).astype(np.float32)
    y_ref, dx_ref, dk_ref = _grads_jax(x, k, stride, jnp.bfloat16)
    y, dx, dk = _grads_port(x, k, stride, torch.bfloat16)
    assert y.dtype == dx.dtype == dk.dtype == torch.bfloat16
    for out, ref in ((y, y_ref), (dx, dx_ref), (dk, dk_ref)):
        _close(out, np.asarray(ref.astype(jnp.float32)), 2e-2)


@pytest.mark.parametrize("stride", [1, 2])
def test_grads_match_stock_conv2d(rng, stride):
    x = torch.from_numpy(rng.standard_normal((2, 9, 7, 12)).astype(np.float32)).requires_grad_()
    conv = ops.PointwiseConv(12, 20, stride, generator=torch.Generator().manual_seed(0))
    g = torch.from_numpy(rng.standard_normal((2, (9 + stride - 1) // stride, (7 + stride - 1) // stride, 20))
                         .astype(np.float32))
    y = conv(x)
    y.backward(g)
    x2 = x.detach().clone().requires_grad_()
    w2 = conv.weight.detach().clone().requires_grad_()
    y2 = F.conv2d(x2.permute(0, 3, 1, 2), w2, stride=stride).permute(0, 2, 3, 1)
    y2.backward(g)
    _close(y, y2.detach(), 1e-5)
    _close(x.grad, x2.grad, 1e-5)
    _close(conv.weight.grad, w2.grad, 1e-4)


def test_module_carries_the_jax_parameters(rng):
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    jmod = jpw.PointwiseConv(24, strides=2)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    conv = ops.PointwiseConv(16, 24, strides=2)
    conv.load_state_dict(models.pointwise_state_dict_from_numpy(jax.tree_util.tree_map(np.asarray, variables)))
    assert conv.weight.shape == (24, 16, 1, 1)  # torch.nn.Conv2d's layout
    _close(conv(torch.from_numpy(x)), ref, 1e-5)
    # the initialiser's variance is the JAX module's (1 / Cin), not its values
    wide = ops.PointwiseConv(256, 512, generator=torch.Generator().manual_seed(0))
    assert abs(float(wide.weight.detach().std()) - 256 ** -0.5) < 0.01 * 256 ** -0.5


def test_refuses_mismatched_arguments():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        ops.conv1x1(x, torch.zeros(1, 1, 7, 3))
    with pytest.raises(TypeError):
        ops.conv1x1(x, torch.zeros(1, 1, 8, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ops.conv1x1(x, torch.zeros(1, 1, 8, 3), stride=0)
    assert pointwise.MIN_ROWS_FOR_KERNEL == jpw._MIN_ROWS_FOR_PALLAS
