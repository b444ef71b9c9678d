"""The port's ``Int8ViT`` (``models/quantization_vit.py``) against the JAX
package's ``Int8ViT`` on the CPU, with the Pallas kernels in interpret mode and
the port's kernels as their plain twins.

A tiny ViT (patch 16, 2 layers, 4 heads, D 256, MLP 512, 64x64 images, 10
classes) is initialised by the JAX package (seed 0) and carried into the port
with ``models.vit_state_dict_from_numpy``; both engines calibrate on the same
images.  The float graphs sum their products in other orders and round their
bfloat16 intermediates after them, so an activation may sit one bfloat16 step
(2^-8) apart and a site's max |x| with it: measured, each scale within 3.3e-2
of JAX's and the median of a site within 1.6e-3 (held to 5e-2 and 5e-3), the
embedding equal bit for bit outside the jitted graph.  Carried across with
``models.int8_scales_from_numpy``, the JAX engine's scales give int8 weights
equal to its own and logits within 1e-4 of max |logit| of its own (measured
2.3e-7).  With each engine's own scales the logits differ by 1.4e-2 (held to
2e-2), as much as each engine's int8 logits differ from its float graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.models.quantization_vit import Int8ViT as JaxInt8ViT
from cpu_vision_tpu.models.vision_transformer import VisionTransformer as JaxViT
from cpu_vision_tpu_torch import models
from cpu_vision_tpu_torch.ops import kernels

LAYERS, HEADS = 2, 4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jm = JaxViT(16, LAYERS, HEADS, 256, 512, num_classes=10, dtype=jnp.bfloat16)
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    jeng = JaxInt8ViT.from_model(jm, variables).calibrate([jnp.asarray(x)])
    model = models.VisionTransformer(16, LAYERS, HEADS, 256, 512, num_classes=10, dtype=torch.bfloat16, image_size=64)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model.load_state_dict(models.vit_state_dict_from_numpy(params, LAYERS, HEADS))
    logits = {"int8": np.asarray(jeng(jnp.asarray(x))), "float": np.asarray(jeng.float_reference(jnp.asarray(x)))}
    return jeng, model, x, logits


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def test_calibrated_scales_match_jax(setup):
    jeng, model, x, jlogits = setup
    eng = models.Int8ViT.from_model(model).calibrate([torch.from_numpy(x)])
    assert set(eng.scales) == set(jeng.scales) and len(eng.scales) == 4 * LAYERS
    for k, v in jeng.scales.items():
        rel = np.abs(eng.scales[k].numpy() - np.asarray(v)) / np.asarray(v)
        assert rel.max() < 5e-2 and np.median(rel) < 5e-3, (k, rel.max(), np.median(rel))
    assert _rel(eng.float_reference(torch.from_numpy(x)).numpy(), jlogits["float"]) < 2e-2
    assert _rel(eng(torch.from_numpy(x)).numpy(), jlogits["int8"]) < 2e-2


def test_carried_scales_give_jax_weights_and_logits(setup):
    jeng, model, x, jlogits = setup
    eng = models.int8_scales_from_numpy(models.Int8ViT.from_model(model),
                                        {k: np.asarray(v) for k, v in jeng.scales.items()})
    for ly, jly in zip(eng.layers, jeng.layers):
        for name in ("qw_qkv", "qw_o", "qw1", "qw2"):
            np.testing.assert_array_equal(getattr(ly, name).numpy(), np.asarray(getattr(jly, name)), err_msg=name)
        for name in ("s_qkv", "s_o", "s1", "s2"):
            np.testing.assert_array_equal(getattr(ly, name).numpy(), np.asarray(getattr(jly, name)), err_msg=name)
    kernels.reset_launch_counts()
    got = eng(torch.from_numpy(x))
    ref = jlogits["int8"]
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    assert _rel(got.numpy(), ref) < 1e-4
    # the int8 forward tracks the float graph as the JAX engine's does (measured 0.014; its test: 0.05)
    assert _rel(got.numpy(), eng.float_reference(torch.from_numpy(x)).numpy()) < 0.05
    assert kernels.mlp_block_int8.launches == 0 and kernels.attention_block_int8.launches == 0  # twins on the CPU


def test_routes(setup):
    _, model, x, _ = setup
    eng = models.Int8ViT.from_model(model)
    assert eng.routes() == ("kernel", "kernel")  # D 256, head dim 64, hidden 512
    eng.calibrate([torch.from_numpy(x)])
    plain = models.Int8ViT.from_model(model, route="plain").set_scales(eng.scales)
    assert plain.routes() == ("plain", "plain")
    assert torch.equal(eng(torch.from_numpy(x)), plain(torch.from_numpy(x)))  # the same twins on the CPU
    with pytest.raises(ValueError, match="route"):
        models.Int8ViT.from_model(model, route="flash")
    narrow = models.VisionTransformer(16, 1, 8, 256, 512, num_classes=10, dtype=torch.bfloat16, image_size=64)
    assert models.Int8ViT.from_model(narrow).routes() == ("plain", "kernel")  # head dim 32


def test_uncalibrated_raises(setup):
    _, model, x, _ = setup
    eng = models.Int8ViT.from_model(model)
    with pytest.raises(RuntimeError, match="calibrate"):
        eng(torch.from_numpy(x))
    for ly in eng.layers:
        assert all(getattr(ly, n).dtype == torch.int8 for n in ("qw_qkv", "qw_o", "qw1", "qw2"))
