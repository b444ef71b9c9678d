"""The port's ``Int8ResNet`` (``models/quantization_resnet.py``) against the JAX
package's ``Int8ResNet`` on the CPU, where the 1x1 kernel route runs its plain
twin.

resnet18 and resnext50_32x4d (grouped 3x3 convolutions) at 64x64.  The port's
model draws its weights from a seeded ``torch.Generator``; its batch norms are
perturbed from an explicitly seeded numpy generator (else each block's last
scale is 0 and its residual branch vanishes); ``torch_weights.resnet_from_torch``
carries them to the JAX model.  Folding and quantising the same float weights
gives the same int8 kernels bit for bit (their float32 scales within two steps).  The float graphs sum their
convolutions in other orders, so calibrated scales agree within 1e-4
relative.  With the JAX engine's scales carried across
(``models.int8_scales_from_numpy``) the int8 logits equal JAX's (measured: no
difference on either model); they are held within 1e-5 of max |logit|, since
both sums are exact but XLA may contract an epilogue's product and sum into
one rounding elsewhere.  On the port's side every route runs the same
float32 operations on exact sums, so the 1x1 kernel route, the stock route and
the space-to-depth stem give the same logits bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu import models as jmodels
from cpu_vision_tpu.models import torch_weights
from cpu_vision_tpu.models.quantization_resnet import Int8ResNet as JaxInt8ResNet
from cpu_vision_tpu_torch import models
from cpu_vision_tpu_torch.ops import kernels

LAYERS = {"resnet18": ((2, 2, 2, 2), False), "resnext50_32x4d": ((3, 4, 6, 3), True)}


def _perturbed(name, seed=0):
    """The port's model with its batch norms perturbed from ``seed``, and its state."""
    model = models.get_model(name, device="cpu", num_classes=10, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.uniform(-0.3, 0.3, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, c).astype(np.float32)))
    return model, model.state_dict()


@pytest.fixture(scope="module", params=list(LAYERS))
def pair(request):
    name = request.param
    model, sd = _perturbed(name)
    layers, bottleneck = LAYERS[name]
    jmodel = jmodels.get_model(name, num_classes=10)
    jeng = JaxInt8ResNet.from_model(jmodel, torch_weights.resnet_from_torch(sd, layers, bottleneck))
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    jeng.calibrate([jnp.asarray(x)])
    logits = {"int8": np.asarray(jax.jit(jeng)(jnp.asarray(x))),
              "float": np.asarray(jax.jit(jeng.float_reference)(jnp.asarray(x)))}
    return name, model, jeng, x, logits


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def test_folded_weights_and_float_graph_match_jax(pair):
    _, model, jeng, x, jlogits = pair
    eng = models.Int8ResNet.from_model(model)
    assert set(eng.convs) == set(jeng.convs)
    for k, spec in eng.convs.items():
        jspec = jeng.convs[k]
        np.testing.assert_array_equal(spec.qw.numpy(), np.asarray(jspec.qw), err_msg=k)
        # XLA evaluates gamma / sqrt(var + eps) as gamma * rsqrt(var + eps): the folded kernel, and so its
        # scale, may sit a float32 step or two apart (the int8 values above are equal all the same)
        np.testing.assert_allclose(spec.w_scale.numpy(), np.asarray(jspec.w_scale), rtol=5e-7, err_msg=k)
        np.testing.assert_allclose(spec.bias.numpy(), np.asarray(jspec.bias), rtol=1e-6, atol=1e-7, err_msg=k)
        assert (spec.stride, spec.pad, spec.groups) == (jspec.stride, jspec.pad, jspec.groups), k
    np.testing.assert_allclose(eng.float_reference(torch.from_numpy(x)).numpy(), jlogits["float"], atol=1e-4)


def test_calibrated_scales_match_jax(pair):
    _, model, jeng, x, _ = pair
    eng = models.Int8ResNet.from_model(model).calibrate([torch.from_numpy(x)])
    assert set(eng.scales) == set(jeng.scales)
    for k, v in jeng.scales.items():
        np.testing.assert_allclose(float(eng.scales[k]), float(v), rtol=1e-4, err_msg=k)


def test_carried_scales_give_jax_logits(pair):
    name, model, jeng, x, jlogits = pair
    eng = models.int8_scales_from_numpy(models.Int8ResNet.from_model(model),
                                        {k: np.asarray(v) for k, v in jeng.scales.items()})
    kernels.reset_launch_counts()
    xt = torch.from_numpy(x)
    got = eng(xt)
    ref = jlogits["int8"]
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    assert _rel(got.numpy(), ref) < 1e-5
    # the int8 forward tracks the float graph (measured 0.030 and 0.035; the JAX engine's own test: 0.06)
    assert _rel(got.numpy(), eng.float_reference(xt).numpy()) < 0.06
    assert kernels.int8_matmul_requant.launches == 0  # twins on the CPU


def test_routes_and_stems_agree_bit_for_bit(pair):
    name, model, jeng, x, _ = pair
    xt = torch.from_numpy(x)
    scales = {k: np.asarray(v) for k, v in jeng.scales.items()}
    outs = {}
    for conv1x1 in (None, "kernel", "stock"):
        for s2d2 in (True, False):
            eng = models.Int8ResNet.from_model(model, conv1x1=conv1x1, use_s2d2_stem=s2d2)
            outs[(conv1x1, s2d2)] = models.int8_scales_from_numpy(eng, scales)(xt)
    first = outs[(None, True)]
    for key, out in outs.items():
        assert torch.equal(out, first), key
    # the stock route's epilogue carried in bfloat16 (the JAX engine's knob, off by default) moves some int8 values
    eng = models.int8_scales_from_numpy(models.Int8ResNet.from_model(model, conv1x1="stock"), scales)
    eng.bf16_epilogue = True
    assert 0 < _rel(eng(xt).numpy(), first.numpy()) < 5e-2
    if name == "resnext50_32x4d":
        eng = models.Int8ResNet.from_model(model)
        spec = eng.convs["layer1_0/c0"]
        assert spec.is_1x1 and eng._takes_kernel(spec, torch.zeros((1, 1, 1, 64), dtype=torch.int8))
        assert not eng.convs["layer1_0/c1"].is_1x1 and eng.convs["layer1_0/c1"].groups == 32
        assert not eng._takes_kernel(spec, torch.zeros((1, 1, 1, 8), dtype=torch.int8))  # K 8: the stock route
    with pytest.raises(ValueError, match="conv1x1"):
        models.Int8ResNet.from_model(model, conv1x1="pallas")


def test_uncalibrated_raises_and_weights_are_int8(pair):
    _, model, _, x, _ = pair
    eng = models.Int8ResNet.from_model(model)
    with pytest.raises(RuntimeError, match="calibrate"):
        eng(torch.from_numpy(x))
    for k, spec in eng.convs.items():
        assert spec.qw.dtype == torch.int8 and spec.w_scale.dtype == torch.float32, k
