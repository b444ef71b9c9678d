"""The port's ResNet family and model registry
(``cpu_vision_tpu_torch.models``) against the JAX package's, with parameters
carried across in both directions, on 64x64 images on the CPU.

Batch-norm statistics and scales are randomised, so that no zero-initialised
scale or unit variance hides a mapping error.  Float32 logits and feature
maps agree within 1e-4: the convolutions sum in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu import models as jmodels
from cpu_vision_tpu.models import torch_weights
from cpu_vision_tpu_torch import graft_entry, models

LAYERS = {"resnet18": ((2, 2, 2, 2), False), "resnet50": ((3, 4, 6, 3), True),
          "resnext50_32x4d": ((3, 4, 6, 3), True), "wide_resnet50_2": ((3, 4, 6, 3), True)}


def _randomised_state(rng, model):
    sd = model.state_dict()
    for key, value in sd.items():
        if key.endswith("running_var"):
            value.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, tuple(value.shape)).astype(np.float32)))
        elif key.endswith("num_batches_tracked"):
            continue
        elif "bn" in key or "downsample.1" in key:
            offset = 1.0 if key.endswith("weight") else 0.0
            value.copy_(torch.from_numpy((offset + rng.normal(0, 0.3, tuple(value.shape))).astype(np.float32)))
        elif key.endswith("bias"):
            value.copy_(torch.from_numpy(rng.normal(0, 0.1, tuple(value.shape)).astype(np.float32)))
    return sd


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def images(rng):
    return rng.random((2, 64, 64, 3), dtype=np.float32)


@pytest.mark.parametrize("name,kwargs", [
    ("resnet18", {}), ("resnet50", {}), ("resnext50_32x4d", {}), ("wide_resnet50_2", {}),
    ("resnet50", {"replace_stride_with_dilation": (False, True, True)})],
    ids=["resnet18", "resnet50", "grouped", "wide", "dilated"])
def test_port_parameters_run_in_the_jax_model(rng, images, name, kwargs):
    layers, bottleneck = LAYERS[name]
    model = models.get_model(name, device="cpu", num_classes=10, generator=torch.Generator().manual_seed(0), **kwargs)
    sd = _randomised_state(rng, model)
    variables = torch_weights.resnet_from_torch(sd, layers, bottleneck)
    ref = np.asarray(jmodels.get_model(name, num_classes=10, **kwargs).apply(variables, jnp.asarray(images), train=False))
    out = model(torch.from_numpy(images))
    assert out.shape == (2, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    # and back: the carrier is the converter's inverse
    back = models.resnet_state_dict_from_numpy(_numpy_tree(variables), layers, bottleneck)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_jax_parameters_run_in_the_port(rng, images, name):
    layers, bottleneck = LAYERS[name]
    jmodel = jmodels.get_model(name, num_classes=10)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), train=False)
    # flax starts the last scales at zero and the statistics at (0, 1); make them count
    variables = jax.tree_util.tree_map(lambda a: a + 0.3 + 0.2 * jnp.cos(jnp.arange(a.size).reshape(a.shape)), variables)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(images), train=False))
    model = models.get_model(name, device="cpu", num_classes=10)
    model.load_state_dict(models.resnet_state_dict_from_numpy(_numpy_tree(variables), layers, bottleneck))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,kwargs", [("resnet18", {}), ("resnet50", {"replace_stride_with_dilation": (False, False, True)})],
                         ids=["resnet18", "resnet50-dilated"])
def test_features_only_matches_jax(rng, images, name, kwargs):
    layers, bottleneck = LAYERS[name]
    model = models.get_model(name, device="cpu", num_classes=10, generator=torch.Generator().manual_seed(1), **kwargs)
    variables = torch_weights.resnet_from_torch(_randomised_state(rng, model), layers, bottleneck)
    ref = jmodels.get_model(name, num_classes=10, **kwargs).apply(variables, jnp.asarray(images), train=False,
                                                                  features_only=True)
    feats = model(torch.from_numpy(images), features_only=True)
    assert list(feats) == ["layer1", "layer2", "layer3", "layer4"]
    for key, value in feats.items():
        assert tuple(value.shape) == ref[key].shape  # NHWC, as the JAX model
        np.testing.assert_allclose(value.numpy(), np.asarray(ref[key]), atol=1e-4)


def test_initialiser_zeroes_the_last_scale_of_each_block():
    model = models.resnet50(device="cpu", num_classes=4, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert float(sd["layer1.0.bn3.weight"].abs().max()) == 0 and float(sd["layer4.2.bn3.weight"].abs().max()) == 0
    assert float(sd["layer1.0.bn1.weight"].min()) == 1 and float(sd["layer1.0.downsample.1.weight"].min()) == 1
    assert model.bn1.eps == 1e-5 and not model.training
    kept = models.resnet18(device="cpu", num_classes=4, zero_init_residual=False)
    assert float(kept.state_dict()["layer1.0.bn2.weight"].min()) == 1
    # one seed, one set of parameters
    again = models.resnet50(device="cpu", num_classes=4, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


def test_max_pool_pads_with_minus_infinity():
    model = models.resnet18(device="cpu", num_classes=4)
    with torch.no_grad():
        model.conv1.weight.zero_()
        model.bn1.bias.fill_(-3.0)  # the stem's output is relu(-3) = 0 everywhere: a zero pad would not show,
        model.bn1.running_mean.fill_(-5.0)  # so shift it: (0 + 5) / 1 - 3 = 2 inside, and -inf outside
    feats = model(torch.zeros(1, 32, 32, 3), features_only=True)
    assert bool(torch.isfinite(feats["layer1"]).all())


@pytest.mark.parametrize("name", sorted(LAYERS) + ["resnet34", "resnet101", "resnet152", "resnext101_32x8d",
                                                   "resnext101_64x4d", "wide_resnet101_2"])
def test_variants_are_registered_with_the_jax_names(name):
    assert name in models.list_models() and name in jmodels.list_models()
    assert models.get_model_builder(name) is getattr(models, name)


def test_registry():
    assert models.list_models("resne*t50*") == ["resnet50", "resnext50_32x4d"]
    assert models.list_models("resnet*", exclude="resnet1*") == ["resnet34", "resnet50"]
    assert set(models.list_models()) <= set(jmodels.list_models())
    with pytest.raises(ValueError):
        models.get_model("resnet51")
    with pytest.raises(ValueError):
        models.register_model("resnet50")(lambda: None)
    with pytest.raises(TypeError):
        models.resnet18(device="cpu", dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        models.resnet18(device="cpu", num_classes=2)(torch.zeros(1, 32, 32, 3), train=True)


@pytest.mark.parametrize("kwargs,error", [({"groups": 2}, ValueError), ({"width_per_group": 128}, ValueError),
                                          ({"replace_stride_with_dilation": (False, True, True)}, NotImplementedError)],
                         ids=["grouped", "wide", "dilated"])
def test_basic_block_refuses_what_it_would_ignore(kwargs, error):
    with pytest.raises(error):
        models.resnet18(device="cpu", num_classes=4, **kwargs)
    assert isinstance(models.resnet50(device="cpu", num_classes=4, **kwargs), models.ResNet)


def test_graft_entry_on_the_cpu():
    forward, (model, images) = graft_entry.entry(device="cpu")
    assert isinstance(model, models.ResNet) and tuple(images.shape) == (4, 224, 224, 3)
    expected = np.random.default_rng(0).random((4, 224, 224, 3), dtype=np.float32)
    np.testing.assert_array_equal(images.numpy(), expected)  # the JAX entry's images
    logits = forward(model, images[:1, :64, :64])
    assert logits.shape == (1, 1000) and bool(torch.isfinite(logits).all())
