"""The port's ConvNeXt (``cpu_vision_tpu_torch.models.convnext``) against the
JAX package's, with parameters carried across in both directions.

A small model (dims (8, 16), depths (1, 2), 32x32 images) on the CPU, where
the port's kernel routes run the kernels' plain twins and the JAX package's
run its Pallas kernels in interpret mode.  Float32 logits agree within 1e-4:
every product sums in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.models import convnext as jconvnext
from cpu_vision_tpu.models import torch_weights
from cpu_vision_tpu_torch import models
from cpu_vision_tpu_torch.ops import kernels

DIMS, DEPTHS, CLASSES = (8, 16), (1, 2), 7


def _port(dtype=torch.float32, **kw):
    return models.ConvNeXt(DIMS, DEPTHS, num_classes=CLASSES, dtype=dtype, **kw)


def _jax(dtype=jnp.float32):
    return jconvnext.ConvNeXt(DIMS, DEPTHS, num_classes=CLASSES, dtype=dtype)


def _randomised_state(rng, model):
    """A state_dict with every entry random, so that no zero bias and no 1e-6
    layer scale hides a mapping error; LayerNorm weights around 1."""
    sd = model.state_dict()
    for key, value in sd.items():
        draw = rng.normal(0, 0.1, tuple(value.shape)).astype(np.float32)
        norm = key.endswith(("block.2.weight", "features.0.1.weight", "features.2.0.weight", "classifier.0.weight"))
        value.copy_(torch.from_numpy(draw + (1.0 if norm else 0.5 if key.endswith("layer_scale") else 0.0)))
    return sd


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def images(rng):
    return rng.random((2, 32, 32, 3), dtype=np.float32)


def test_port_parameters_run_in_the_jax_model(rng, images):
    model = _port(generator=torch.Generator().manual_seed(0))
    sd = _randomised_state(rng, model)
    ref = np.asarray(_jax().apply(torch_weights.convnext_from_torch(sd), jnp.asarray(images)))
    out = model(torch.from_numpy(images))
    assert out.shape == (2, CLASSES) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    assert all(v == 0 for v in kernels.launch_counts().values())  # CPU tensors launch nothing


def test_jax_parameters_run_in_the_port(images):
    variables = _jax().init(jax.random.PRNGKey(0), jnp.asarray(images))
    # flax starts biases at zero and the layer scale at 1e-6; make them count
    variables = jax.tree_util.tree_map(lambda a: a + 0.05 * jnp.cos(jnp.arange(a.size).reshape(a.shape)), variables)
    ref = np.asarray(_jax().apply(variables, jnp.asarray(images)))
    model = _port()
    model.load_state_dict(models.convnext_state_dict_from_numpy(_numpy_tree(variables)))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(), ref, atol=1e-4)
    sd = models.convnext_state_dict_from_numpy(_numpy_tree(variables["params"]))  # the params tree itself
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in sd.items())


def test_converters_round_trip(rng):
    sd = _randomised_state(rng, _port())
    params = _numpy_tree(torch_weights.convnext_from_torch(sd))
    back = models.convnext_state_dict_from_numpy(params)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key
    again = _numpy_tree(torch_weights.convnext_from_torch(back))
    flat, flat_again = jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(again)
    assert len(flat) == len(flat_again) and all(np.array_equal(a, b) for a, b in zip(flat, flat_again))


def test_state_dict_keys_are_torchvisions():
    sd = _port().state_dict()
    block = "features.3.1."
    expected = {"features.0.0.weight", "features.0.0.bias", "features.0.1.weight", "features.0.1.bias",
                "features.2.0.weight", "features.2.0.bias", "features.2.1.weight", "features.2.1.bias",
                "classifier.0.weight", "classifier.0.bias", "classifier.2.weight", "classifier.2.bias",
                "features.1.0.layer_scale", block + "layer_scale", block + "block.0.weight", block + "block.0.bias",
                block + "block.2.weight", block + "block.2.bias", block + "block.3.weight", block + "block.3.bias",
                block + "block.5.weight", block + "block.5.bias"}
    assert expected == set(sd) - {k for k in sd if k.startswith(("features.1.0.block", "features.3.0."))}
    assert sd["features.0.0.weight"].shape == (8, 3, 4, 4) and sd["features.2.1.weight"].shape == (16, 8, 2, 2)
    assert sd[block + "block.0.weight"].shape == (16, 1, 7, 7) and sd[block + "layer_scale"].shape == (16, 1, 1)
    assert sd[block + "block.3.weight"].shape == (64, 16) and float(sd[block + "layer_scale"][0]) == pytest.approx(1e-6)


@pytest.mark.parametrize("mlp", [None, "block", "plain"])
@pytest.mark.parametrize("depthwise", [None, "kernel", "stock"])
def test_routes_agree_with_jax(rng, images, monkeypatch, mlp, depthwise):
    # the JAX side runs its fused tail always when serving, and its depthwise kernel (interpret mode) when asked
    monkeypatch.setenv("CVT_DW_PALLAS", "1" if depthwise == "kernel" else "0")
    model = _port(mlp=mlp, depthwise=depthwise)
    sd = _randomised_state(rng, model)
    ref = np.asarray(_jax().apply(torch_weights.convnext_from_torch(sd), jnp.asarray(images)))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(), ref, atol=1e-4)
    assert model.routes() == [(mlp or "block", depthwise or "stock")] * 3


@pytest.mark.parametrize("mlp,depthwise", [(None, None), ("block", "kernel"), ("plain", "stock")])
def test_bfloat16_matches_jax(rng, images, monkeypatch, mlp, depthwise):
    monkeypatch.setenv("CVT_DW_PALLAS", "1" if depthwise == "kernel" else "0")
    model = _port(torch.bfloat16, mlp=mlp, depthwise=depthwise)
    sd = _randomised_state(rng, model)
    ref = _jax(jnp.bfloat16).apply(torch_weights.convnext_from_torch(sd), jnp.asarray(images))
    out = model(torch.from_numpy(images))
    assert out.dtype == torch.bfloat16
    # bfloat16 logits come in steps of 2^-8 of their value: 2e-2·(1 + |ref|), as the kernels' own tolerance
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2e-2, rtol=2e-2)


def test_odd_maps_drop_the_last_row_before_downsampling(rng):
    images = rng.random((1, 36, 44, 3), dtype=np.float32)  # 9x11 maps: the 2x2/2 convolution is VALID
    model = _port()
    sd = _randomised_state(rng, model)
    ref = np.asarray(_jax().apply(torch_weights.convnext_from_torch(sd), jnp.asarray(images)))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(), ref, atol=1e-4)


def test_packed_weights_follow_the_parameters(rng, images):
    model = _port(depthwise="kernel")
    x = torch.from_numpy(images)
    first = model(x)
    block = model.blocks()[1]
    with torch.no_grad():  # serving: the copies are cached (under grad mode they are built in the graph)
        w1, w2 = block._packed.transposed(torch.float32, block.block[3].weight, block.block[5].weight)
        assert w1.shape == (16, 64) and w2.shape == (64, 16) and torch.equal(w1, block.block[3].weight.t())
        model(x)
        assert block._packed.transposed(torch.float32, block.block[3].weight, block.block[5].weight)[0] is w1
    sd = _randomised_state(rng, model)
    assert not torch.equal(model(x), first)
    other = _port(depthwise="kernel")
    other.load_state_dict(sd)
    assert torch.equal(other(x), model(x))


@pytest.mark.parametrize("name,params,blocks,width", [
    ("convnext_tiny", 28589128, 18, 768), ("convnext_small", 50223688, 36, 768), ("convnext_base", 88591464, 36, 1024),
    ("convnext_large", 197767336, 36, 1536)])
def test_registered_models_have_the_references_parameter_counts(name, params, blocks, width):
    model = models.get_model(name, device="cpu")  # the counts torchvision publishes for the same names
    assert sum(p.numel() for p in model.parameters()) == params
    assert len(model.blocks()) == blocks and model.blocks()[-1].dim == width
    assert model.routes() == [("block", "stock")] * blocks and not model.training


def test_registry_and_bad_arguments():
    assert models.list_models("convnext*") == ["convnext_base", "convnext_large", "convnext_small", "convnext_tiny"]
    assert len(models.list_models()) == 28  # with fasterrcnn_resnet50_fpn and _v2
    model = models.get_model("convnext_tiny", device="cpu", num_classes=5, depthwise="kernel",
                             generator=torch.Generator().manual_seed(0))
    assert isinstance(model, models.ConvNeXt) and next(model.parameters()).device.type == "cpu" and not model.training
    assert len(model.blocks()) == 18 and model.routes() == [("block", "kernel")] * 18
    assert model.classifier[2].weight.shape == (5, 768) and model.blocks()[17].dim == 768
    assert all(models.get_model_builder(n) is getattr(models, n) for n in models.list_models("convnext*"))
    with pytest.raises(ValueError):
        _port(mlp="flash")
    with pytest.raises(ValueError):
        _port(depthwise="pallas")
    with pytest.raises(TypeError):
        _port(torch.float16)
    with pytest.raises(ValueError):
        _port()(torch.zeros(1, 30, 30, 3))  # sides must be multiples of the 4x4 patch
    # training: the blocks that drop (stochastic depth above 0) take the plain tail, and "block" raises on them
    trained = _port()(torch.zeros(1, 32, 32, 3), train=True, generator=torch.Generator().manual_seed(0))
    assert trained.shape == (1, CLASSES) and trained.requires_grad
    with pytest.raises(ValueError, match="no branch to drop"):
        _port(mlp="block")(torch.zeros(1, 32, 32, 3), train=True)
