"""The port's depthwise convolution
(``cpu_vision_tpu_torch.ops.kernels.depthwise``) against the JAX package's
Pallas kernel run in interpret mode, on the same numpy inputs.

On CPU tensors the wrapper runs its plain twin.  Tolerances: float32 ``1e-5``
(both sides sum the taps in (i, j) order; a fused multiply-add on one side
rounds once where the other rounds twice), bfloat16 ``2e-2·(1 + |ref|)`` (the
sum is float32 on both sides and rounded once; one bfloat16 step is 2^-8 of
the value).  The CUDA kernel is held against the twin on the card by
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cpu_vision_tpu.models import layers as jlayers
from cpu_vision_tpu.ops.pallas import depthwise as jdw
from cpu_vision_tpu_torch.models import layers
from cpu_vision_tpu_torch.ops import kernels

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rng, shape, k):
    c = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32), (rng.standard_normal((k, k, c)) / k).astype(np.float32),
            rng.standard_normal(c).astype(np.float32))


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_conv2d_matches_pallas_interpret(rng, k, use_bias, dtype):
    x, taps, bias = _inputs(rng, (2, 9, 14, 24), k)
    ref = jdw.depthwise_conv2d(jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(taps).astype(JDT[dtype]),
                               jnp.asarray(bias), use_bias, True)
    out = kernels.depthwise_conv2d(torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(taps).to(TDT[dtype]),
                                   torch.from_numpy(bias), use_bias)
    assert out.dtype == TDT[dtype] and out.shape == x.shape
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    else:
        assert np.all(np.abs(out.float().numpy() - ref) <= 2e-2 * (1 + np.abs(ref)))
    assert kernels.launch_counts()["depthwise_conv2d"] == 0  # CPU tensors launch nothing


def test_twin_is_the_grouped_convolution(rng):
    x, taps, bias = _inputs(rng, (2, 7, 7, 16), 7)  # the window is larger than the map, as in ConvNeXt's last stage
    out = kernels.depthwise_conv2d_plain(torch.from_numpy(x), torch.from_numpy(taps), torch.from_numpy(bias))
    weight = torch.from_numpy(taps).permute(2, 0, 1)[:, None]
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), weight, torch.from_numpy(bias), padding=3, groups=16)
    np.testing.assert_allclose(out.numpy(), ref.permute(0, 2, 3, 1).numpy(), atol=1e-5)


@pytest.mark.parametrize("backend", [None, "kernel", "stock"])
@pytest.mark.parametrize("kwargs", [dict(), dict(strides=(2, 2)), dict(padding="VALID"), dict(kernel_dilation=(2, 2)),
                                    dict(padding=[(1, 2), (0, 1)]), dict(use_bias=False)],
                         ids=["same", "strided", "valid", "dilated", "asymmetric", "no_bias"])
def test_depthwise_conv_layer_matches_the_jax_layer(rng, backend, kwargs):
    applies = set(kwargs) <= {"use_bias"}
    if backend == "kernel" and not applies:  # an explicit kernel route never gives way to the stock convolution
        with pytest.raises(ValueError, match='backend="kernel"'):
            layers.DepthwiseConv(8, (3, 3), backend=backend, **kwargs)
        backend = "stock"
    layer = layers.DepthwiseConv(8, (3, 3), backend=backend, **kwargs)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(rng.standard_normal((8, 1, 3, 3)).astype(np.float32)))
        if layer.bias is not None:
            layer.bias.copy_(torch.from_numpy(rng.standard_normal(8).astype(np.float32)))
    x = rng.standard_normal((2, 10, 11, 8)).astype(np.float32)
    params = {"kernel": jnp.asarray(layer.weight.detach().numpy().transpose(2, 3, 1, 0))}
    if layer.bias is not None:
        params["bias"] = jnp.asarray(layer.bias.detach().numpy())
    ref = jlayers.DepthwiseConv(8, (3, 3), **kwargs).apply({"params": params}, jnp.asarray(x))
    out = layer(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    assert layer.kernel_applies() == applies


def test_bad_arguments_raise(rng):
    x, taps, bias = (torch.from_numpy(a) for a in _inputs(rng, (1, 6, 6, 8), 3))
    with pytest.raises(ValueError):  # HWC input
        kernels.depthwise_conv2d(x[0], taps, bias)
    with pytest.raises(ValueError):  # taps of other channels
        kernels.depthwise_conv2d(x, taps[..., :4], bias)
    with pytest.raises(ValueError):  # even kernel
        kernels.depthwise_conv2d(x, taps[:2], bias)
    with pytest.raises(ValueError):  # bias of the wrong length
        kernels.depthwise_conv2d(x, taps, bias[:4])
    with pytest.raises(TypeError):
        kernels.depthwise_conv2d(x.long(), taps, bias)
    with pytest.raises(ValueError):
        kernels.depthwise_conv2d(x.to("meta"), taps.to("meta"), bias.to("meta"))
    with pytest.raises(ValueError):
        layers.DepthwiseConv(8, (3, 3), backend="pallas")
    with pytest.raises(ValueError):
        layers.DepthwiseConv(8, (3, 3))(torch.zeros(1, 4, 4, 4))
    assert kernels.depthwise_conv2d(x, taps, bias, use_bias=False).shape == x.shape
