"""The port's Vision Transformer (``cpu_vision_tpu_torch.models``) against
the JAX package's, with parameters carried across in both directions.

A small model (2 layers, D=128, MLP 256, 4 heads, patch 8, 32x32 images) on
the CPU, where the port's kernel routes run the kernels' plain twins and the
JAX package's run its Pallas kernels in interpret mode.  Float32 logits agree
within 1e-4: every product sums in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.models import torch_weights
from cpu_vision_tpu.models import vision_transformer as jvit
from cpu_vision_tpu_torch import models
from cpu_vision_tpu_torch.models import vision_transformer as tvit
from cpu_vision_tpu_torch.ops import kernels

CFG = dict(patch_size=8, num_layers=2, num_heads=4, hidden_dim=128, mlp_dim=256)
LAYERS, HEADS, CLASSES = CFG["num_layers"], CFG["num_heads"], 10


def _port(dtype=torch.float32, **kw):
    return models.VisionTransformer(**CFG, num_classes=CLASSES, image_size=32, dtype=dtype, **kw)


def _jax(dtype=jnp.float32):
    return jvit.VisionTransformer(**CFG, num_classes=CLASSES, dtype=dtype)


def _randomised_state(rng, model):
    """A state_dict with every entry random, so that no zero bias or zero
    class token hides a mapping error."""
    sd = model.state_dict()
    for key, value in sd.items():
        draw = rng.normal(0, 0.1, tuple(value.shape)).astype(np.float32)
        value.copy_(torch.from_numpy(draw + (1.0 if key.endswith(("ln_1.weight", "ln_2.weight", "ln.weight")) else 0.0)))
    return sd


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def images(rng):
    return rng.random((3, 32, 32, 3), dtype=np.float32)


def test_port_parameters_run_in_the_jax_model(rng, images):
    model = _port(generator=torch.Generator().manual_seed(0))
    sd = _randomised_state(rng, model)
    ref = np.asarray(_jax().apply(torch_weights.vit_from_torch(sd, LAYERS, HEADS), jnp.asarray(images)))
    out = model(torch.from_numpy(images))
    assert out.shape == (3, CLASSES) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    assert all(v == 0 for v in kernels.launch_counts().values())  # CPU tensors launch nothing


def test_jax_parameters_run_in_the_port(images):
    variables = _jax().init(jax.random.PRNGKey(0), jnp.asarray(images))
    # flax starts biases and the class token at zero; make them count
    variables = jax.tree_util.tree_map(lambda a: a + 0.05 * jnp.cos(jnp.arange(a.size).reshape(a.shape)), variables)
    ref = np.asarray(_jax().apply(variables, jnp.asarray(images)))
    model = _port()
    model.load_state_dict(models.vit_state_dict_from_numpy(_numpy_tree(variables), LAYERS, HEADS))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(), ref, atol=1e-4)
    # the params tree itself is taken as well as {"params": ...}
    sd = models.vit_state_dict_from_numpy(_numpy_tree(variables["params"]), LAYERS, HEADS)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in sd.items())


def test_converters_round_trip(rng):
    sd = _randomised_state(rng, _port())
    back = models.vit_state_dict_from_numpy(_numpy_tree(torch_weights.vit_from_torch(sd, LAYERS, HEADS)), LAYERS, HEADS)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key
    params = _numpy_tree(torch_weights.vit_from_torch(sd, LAYERS, HEADS))
    again = _numpy_tree(torch_weights.vit_from_torch(models.vit_state_dict_from_numpy(params, LAYERS, HEADS), LAYERS, HEADS))
    flat, flat_again = jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(again)
    assert len(flat) == len(flat_again) and all(np.array_equal(a, b) for a, b in zip(flat, flat_again))


def test_state_dict_keys_are_torchvisions():
    keys = set(_port().state_dict())
    layer = "encoder.layers.encoder_layer_1."
    expected = {"conv_proj.weight", "conv_proj.bias", "class_token", "encoder.pos_embedding", "encoder.ln.weight",
                "encoder.ln.bias", "heads.head.weight", "heads.head.bias", layer + "ln_1.weight", layer + "ln_2.bias",
                layer + "self_attention.in_proj_weight", layer + "self_attention.in_proj_bias",
                layer + "self_attention.out_proj.weight", layer + "self_attention.out_proj.bias",
                layer + "mlp.0.weight", layer + "mlp.0.bias", layer + "mlp.3.weight", layer + "mlp.3.bias"}
    assert expected <= keys and len(keys) == 8 + 12 * LAYERS
    assert _port().state_dict()["conv_proj.weight"].shape == (128, 3, 8, 8)  # the convolution's shape


@pytest.mark.parametrize("attention", [None, "block", "flash", "plain"])
@pytest.mark.parametrize("mlp", [None, "block", "plain"])
def test_routes_agree_with_jax(rng, images, monkeypatch, attention, mlp):
    # the JAX side: its fused kernels for "block" (and None, which picks them at
    # this size), FusedMHA around flash_mha for "flash", both in interpret mode
    monkeypatch.setattr(jvit, "FUSED_ATTENTION", attention in (None, "block"))
    monkeypatch.setattr(jvit, "FUSED_MLP", mlp in (None, "block"))
    model = _port(attention=attention, mlp=mlp)
    sd = _randomised_state(rng, model)
    ref = np.asarray(_jax().apply(torch_weights.vit_from_torch(sd, LAYERS, HEADS), jnp.asarray(images)))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(), ref, atol=1e-4)
    # head dim 32 lies outside the attention kernels' HEAD_DIMS, so None takes the plain attention route by shape
    assert model.routes() == (attention or "plain", mlp or "block")


@pytest.mark.parametrize("attention,mlp", [(None, None), ("flash", "block"), ("plain", "plain")])
def test_bfloat16_matches_jax(rng, images, monkeypatch, attention, mlp):
    monkeypatch.setattr(jvit, "FUSED_ATTENTION", attention is None)
    monkeypatch.setattr(jvit, "FUSED_MLP", mlp in (None, "block"))
    model = _port(torch.bfloat16, attention=attention, mlp=mlp)
    sd = _randomised_state(rng, model)
    ref = _jax(jnp.bfloat16).apply(torch_weights.vit_from_torch(sd, LAYERS, HEADS), jnp.asarray(images))
    out = model(torch.from_numpy(images))
    assert out.dtype == torch.bfloat16
    # bfloat16 logits come in steps of 2^-8 of their value: 2e-2·(1 + |ref|), as the kernels' own tolerance
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name,dtype,expected", [
    ("vit_b_16", torch.float32, ("flash", "block")), ("vit_b_16", torch.bfloat16, ("block", "block")),
    ("vit_b_32", torch.float32, ("block", "block")), ("vit_l_16", torch.bfloat16, ("block", "block")),
    ("vit_l_16", torch.float32, ("flash", "block")), ("vit_h_14", torch.bfloat16, ("flash", "block"))])
def test_default_routes_copy_the_jax_rule(name, dtype, expected):
    patch, layers, heads, d, mlp_dim = {"vit_b_16": (16, 12, 12, 768, 3072), "vit_b_32": (32, 12, 12, 768, 3072),
                                        "vit_l_16": (16, 24, 16, 1024, 4096), "vit_h_14": (14, 32, 16, 1280, 5120)}[name]
    s = (224 // patch) ** 2 + 1
    block = tvit.EncoderBlock(heads, heads, 8, dtype)  # the rule reads the widths it is asked about, not the module's
    block.mlp_dim = mlp_dim
    assert block.routes(d, s) == expected
    jblock = jvit.EncoderBlock(heads, mlp_dim, 0.0, 0.0, dtype={torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype])
    assert (expected[0] == "block") == jblock._attn_fits_vmem(d, s)
    assert (expected[1] == "block") == jblock._mlp_fits_vmem(d)
    assert not tvit.mlp_fits_vmem(96, 256) and not tvit.mlp_fits_vmem(128, 384)


def test_packed_weights_are_built_once_and_follow_the_parameters(rng, images):
    model = _port()
    x = torch.from_numpy(images)
    block = model.encoder.layers[0]
    first = model(x)
    w_qkv, w_o = block.self_attention.packed()
    assert w_qkv.shape == (128, 384) and w_o.shape == (128, 128) and w_qkv.is_contiguous()
    assert torch.equal(w_qkv, block.self_attention.in_proj_weight.t())
    model(x)
    assert block.self_attention.packed()[0] is w_qkv  # not rebuilt at every forward
    sd = _randomised_state(rng, model)  # in-place writes, as load_state_dict makes them
    assert block.self_attention.packed()[0] is not w_qkv
    assert not torch.equal(model(x), first)
    other = _port()
    other.load_state_dict(sd)
    assert torch.equal(other(x), model(x))


def test_patchify_dense_is_the_strided_convolution(rng):
    layer = models.PatchifyDense(3, 16, (4, 4))
    x = torch.from_numpy(rng.random((2, 8, 12, 3), dtype=np.float32))
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), layer.weight, layer.bias, stride=4).permute(0, 2, 3, 1)
    out = layer(x)
    assert out.shape == (2, 2, 3, 16)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-5)
    with pytest.raises(ValueError):
        layer(x[:, :7])
    with pytest.raises(ValueError):
        layer(x[0])


def test_registry_and_bad_arguments():
    assert models.list_models("vit_*") == ["vit_b_16", "vit_b_32", "vit_h_14", "vit_l_16", "vit_l_32"]
    model = models.get_model("vit_b_32", device="cpu", num_classes=5, image_size=64, generator=torch.Generator().manual_seed(0))
    assert isinstance(model, models.VisionTransformer) and next(model.parameters()).device.type == "cpu"
    assert model.encoder.pos_embedding.shape == (1, 5, 768) and not model.training
    with pytest.raises(ValueError):
        _port(attention="xla")
    with pytest.raises(ValueError):
        _port(mlp="flash")
    with pytest.raises(TypeError):
        _port(torch.float16)
    with pytest.raises(ValueError):
        _port()(torch.zeros(1, 40, 40, 3))
    with pytest.raises(NotImplementedError):
        _port()(torch.zeros(1, 32, 32, 3), train=True)
