"""The port's fused conv3x3 + ReLU + pool stage
(``cpu_vision_tpu_torch.ops.kernels.conv_block``) against the JAX package's
Pallas kernel run in interpret mode and against its XLA oracle.

On CPU tensors the wrapper runs its plain twin (nine per-tap matrix products
summed in the Pallas kernel's (dy, dx) order).  Tolerance ``atol=1e-5``, as
the JAX test holds the Pallas kernel to the oracle: the sums over input
channels run in another order on each side.  The CUDA kernel is held
against the twin on the card by ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cpu_vision_tpu.ops.pallas import conv_block as jcb
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import conv_block as tcb

SHAPES = [((2, 28, 28, 3), 16), ((1, 64, 48, 8), 32), ((3, 30, 30, 1), 4)]


def _oracle(x, w, b):
    out = lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=lax.Precision.HIGHEST) + b
    out = jax.nn.relu(out)
    return lax.reduce_window(out, -jnp.inf, lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")


def _inputs(rng, shape, cout):
    x = rng.random(shape, dtype=np.float32)
    w = rng.normal(0, 0.3, (3, 3, shape[-1], cout)).astype(np.float32)
    b = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_twin_matches_pallas_interpret(rng, shape, cout):
    x, w, b = _inputs(rng, shape, cout)
    ref = np.asarray(jcb.fused_conv3x3_relu_pool(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    out = kernels.fused_conv3x3_relu_pool(*map(torch.from_numpy, (x, w, b)))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("shape,cout", SHAPES)
def test_twin_matches_xla_oracle(rng, shape, cout):
    x, w, b = _inputs(rng, shape, cout)
    ref = np.asarray(_oracle(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    out = tcb.fused_conv3x3_relu_pool_plain(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("backend", [None, "kernel", "plain", "stock"])
def test_backends_agree_on_cpu(rng, backend):
    x, w, b = _inputs(rng, (2, 16, 20, 3), 8)
    ref = np.asarray(jcb.conv3x3_relu_pool(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    out = kernels.conv3x3_relu_pool(*map(torch.from_numpy, (x, w, b)), backend=backend)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    assert kernels.launch_counts()["fused_conv3x3_relu_pool"] == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("shape", [(1, 7, 8, 2), (1, 8, 7, 2)])
def test_odd_sizes_raise_as_in_jax(shape):
    x, w, b = np.zeros(shape, np.float32), np.zeros((3, 3, 2, 4), np.float32), np.zeros(4, np.float32)
    with pytest.raises(ValueError):
        jcb.fused_conv3x3_relu_pool(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    for fn in (kernels.fused_conv3x3_relu_pool, tcb.fused_conv3x3_relu_pool_plain):
        with pytest.raises(ValueError):
            fn(*map(torch.from_numpy, (x, w, b)))


def test_bad_arguments_raise():
    x, w, b = torch.zeros(1, 8, 8, 2), torch.zeros(3, 3, 2, 4), torch.zeros(4)
    with pytest.raises(ValueError):  # not 3x3
        kernels.fused_conv3x3_relu_pool(x, torch.zeros(5, 5, 2, 4), b)
    with pytest.raises(ValueError):  # channels do not match
        kernels.fused_conv3x3_relu_pool(x, torch.zeros(3, 3, 3, 4), b)
    with pytest.raises(ValueError):
        kernels.fused_conv3x3_relu_pool(x, w, torch.zeros(5))
    with pytest.raises(TypeError):
        kernels.fused_conv3x3_relu_pool(x.double(), w, b)
    with pytest.raises(ValueError):
        kernels.conv3x3_relu_pool(x, w, b, backend="xla")
    with pytest.raises(ValueError):
        kernels.fused_conv3x3_relu_pool(x.to("meta"), w.to("meta"), b.to("meta"))
