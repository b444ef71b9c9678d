"""The port's ``ops.cnn`` against the JAX package's: JAX's ``cnn_init``
parameters are carried across as numpy arrays by ``cnn_params_from_numpy``
and the same numpy images go through both ``cnn_forward``s (the port on CPU
tensors).  Tolerance ``atol=1e-4`` on the logits: the convolutions and the
two matrix products sum in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops import cnn as jcnn
from cpu_vision_tpu_torch import ops
from cpu_vision_tpu_torch.ops import kernels

CONFIGS = [
    dict(input_hw=(28, 28), in_channels=1, conv_channels=(8, 16), hidden=32, num_classes=10),
    dict(input_hw=(32, 32), in_channels=3, conv_channels=(8, 16), hidden=32, num_classes=10),
    dict(input_hw=(28, 28), in_channels=1, conv_channels=(4, 4, 4), hidden=8, num_classes=3),  # 28 -> 14 -> 7 (odd) -> 3
]


def _jax_params(cfg):
    params = jcnn.cnn_init(jax.random.PRNGKey(0), **cfg)
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["28x28x1", "32x32x3", "odd-stage"])
@pytest.mark.parametrize("backend", [None, "plain", "stock"])
def test_forward_matches_jax(rng, cfg, backend):
    jparams, nparams = _jax_params(cfg)
    images = rng.random((4, *cfg["input_hw"], cfg["in_channels"]), dtype=np.float32)
    ref = np.asarray(jcnn.cnn_forward(jparams, jnp.asarray(images)))
    params = ops.cnn_params_from_numpy(nparams, device="cpu")
    out = ops.cnn_forward(params, torch.from_numpy(images), backend=backend)
    assert out.shape == (4, cfg["num_classes"]) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    assert kernels.launch_counts()["fused_conv3x3_relu_pool"] == 0


def test_params_from_numpy_keeps_keys_and_layouts():
    _, nparams = _jax_params(CONFIGS[1])
    params = ops.cnn_params_from_numpy(nparams, device="cpu")
    assert list(params) == ["conv0", "conv1", "fc1", "fc2"]
    for layer, leaves in nparams.items():
        for name, value in leaves.items():
            t = params[layer][name]
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), value)
    # float64 numpy leaves arrive as float32
    p64 = ops.cnn_params_from_numpy({"fc2": {"w": np.ones((2, 3)), "b": np.zeros(3)}}, device="cpu")
    assert p64["fc2"]["w"].dtype == torch.float32


@pytest.mark.parametrize("cfg", CONFIGS, ids=["28x28x1", "32x32x3", "odd-stage"])
def test_init_shapes_match_jax(cfg):
    _, nparams = _jax_params(cfg)
    params = ops.cnn_init(torch.Generator().manual_seed(0), **cfg, device="cpu")
    assert list(params) == list(nparams)
    for layer, leaves in nparams.items():
        assert {k: tuple(v.shape) for k, v in params[layer].items()} == {k: v.shape for k, v in leaves.items()}
        assert all(v.dtype == torch.float32 for v in params[layer].values())
        assert not params[layer]["b"].any()


def test_init_is_he_normal_and_follows_its_generator():
    cfg = dict(input_hw=(28, 28), in_channels=1, conv_channels=(32, 64), hidden=128, num_classes=10, device="cpu")
    a = ops.cnn_init(torch.Generator().manual_seed(7), **cfg)
    b = ops.cnn_init(torch.Generator().manual_seed(7), **cfg)
    c = ops.cnn_init(torch.Generator().manual_seed(8), **cfg)
    for layer in a:
        assert torch.equal(a[layer]["w"], b[layer]["w"])
    assert not torch.equal(a["fc1"]["w"], c["fc1"]["w"])
    # std sqrt(2 / fan_in): fc1 has 7*7*64 inputs and 401k samples
    assert abs(float(a["fc1"]["w"].std()) / np.sqrt(2.0 / (7 * 7 * 64)) - 1.0) < 0.01
    assert abs(float(a["conv1"]["w"].std()) / np.sqrt(2.0 / (9 * 32)) - 1.0) < 0.02
    half = ops.cnn_init(torch.Generator().manual_seed(7), **{**cfg, "dtype": torch.float16})
    assert half["conv0"]["w"].dtype == torch.float16


def test_numpy_images_go_to_the_card():
    params = ops.cnn_init(torch.Generator().manual_seed(0), (8, 8), 1, (2,), 4, 2, device="cpu")
    images = np.zeros((1, 8, 8, 1), np.float32)
    if torch.cuda.is_available():
        cuda_params = ops.cnn_params_from_numpy({k: {n: t.numpy() for n, t in v.items()} for k, v in params.items()})
        assert ops.cnn_forward(cuda_params, images).device.type == "cuda"
    else:
        # no silent CPU fallback: asking for the card without one fails
        with pytest.raises((RuntimeError, AssertionError)):
            ops.cnn_forward(params, images)
        with pytest.raises((RuntimeError, AssertionError)):
            ops.cnn_init(torch.Generator().manual_seed(0), (8, 8), 1, (2,), 4, 2)
