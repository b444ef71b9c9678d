"""The port's Swin Transformer (``cpu_vision_tpu_torch.models.swin`` and
``swin_padded``) against the JAX package's, with parameters carried across in
both directions.

Small models (embed dim 16, depths (2, 2), heads (2, 4), window 4, 32x32
images) on the CPU, where the port's kernel routes run the kernels' plain
twins and the JAX package's run its Pallas kernels in interpret mode.
Float32 logits agree within 1e-4: every product sums in another order on
each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.models import swin as jswin
from cpu_vision_tpu.models import swin_padded as jpadded
from cpu_vision_tpu.models import torch_weights
from cpu_vision_tpu_torch import models
from cpu_vision_tpu_torch.models import swin as tswin
from cpu_vision_tpu_torch.ops import kernels

CFG = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4)
DEPTHS, CLASSES = CFG["depths"], 9


def _port(v2=False, dtype=torch.float32, **kw):
    return models.SwinTransformer(**CFG, num_classes=CLASSES, v2=v2, dtype=dtype, **kw)


def _jax(v2=False, dtype=jnp.float32, **kw):
    return jswin.SwinTransformer(**CFG, num_classes=CLASSES, v2=v2, dtype=dtype, **kw)


def _randomised_state(rng, model):
    """A state_dict with every entry random, so that no zero bias hides a
    mapping error; LayerNorm weights around 1, logit scales around ln 10."""
    sd = model.state_dict()
    for key, value in sd.items():
        draw = rng.normal(0, 0.1, tuple(value.shape)).astype(np.float32)
        shift = 1.0 if key.endswith(("norm1.weight", "norm2.weight", "norm.weight", "features.0.2.weight")) else \
            2.3 if key.endswith("logit_scale") else 0.0
        value.copy_(torch.from_numpy(draw + shift))
    return sd


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def images(rng):
    return rng.random((2, 32, 32, 3), dtype=np.float32)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_port_parameters_run_in_the_jax_model(rng, images, v2):
    model = _port(v2, generator=torch.Generator().manual_seed(0))
    sd = _randomised_state(rng, model)
    ref = np.asarray(_jax(v2).apply(torch_weights.swin_from_torch(sd, DEPTHS), jnp.asarray(images)))
    out = model(torch.from_numpy(images))
    assert out.shape == (2, CLASSES) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    # 8x8 and 4x4 maps in windows of 4: the odd blocks of the first stage are shifted and masked, the second
    # stage's window covers its map, so its shift is 0
    blocks = model.blocks()
    assert [b.geometry(8, 8)[2:] for b in blocks[:2]] == [(0, 0), (2, 2)] and blocks[3].geometry(4, 4)[2:] == (0, 0)
    assert all(v == 0 for v in kernels.launch_counts().values())  # CPU tensors launch nothing


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_jax_parameters_run_in_the_port(images, v2):
    variables = _jax(v2).init(jax.random.PRNGKey(0), jnp.asarray(images))
    # flax starts biases at zero; make them count
    variables = jax.tree_util.tree_map(lambda a: a + 0.05 * jnp.cos(jnp.arange(a.size).reshape(a.shape)), variables)
    ref = np.asarray(_jax(v2).apply(variables, jnp.asarray(images)))
    model = _port(v2)
    model.load_state_dict(models.swin_state_dict_from_numpy(_numpy_tree(variables), DEPTHS))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(), ref, atol=1e-4)
    sd = models.swin_state_dict_from_numpy(_numpy_tree(variables["params"]), DEPTHS)  # the params tree itself
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in sd.items())


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_converters_round_trip(rng, v2):
    sd = _randomised_state(rng, _port(v2))
    params = _numpy_tree(torch_weights.swin_from_torch(sd, DEPTHS))
    back = models.swin_state_dict_from_numpy(params, DEPTHS)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert torch.equal(back[key], value), key
    again = _numpy_tree(torch_weights.swin_from_torch(back, DEPTHS))
    flat, flat_again = jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(again)
    assert len(flat) == len(flat_again) and all(np.array_equal(a, b) for a, b in zip(flat, flat_again))


def test_state_dict_keys_are_torchvisions():
    v1, v2 = set(_port().state_dict()), set(_port(True).state_dict())
    block = "features.3.1."
    shared = {"features.0.0.weight", "features.0.0.bias", "features.0.2.weight", "features.0.2.bias",
              "features.2.reduction.weight", "features.2.norm.weight", "features.2.norm.bias", "norm.weight", "norm.bias",
              "head.weight", "head.bias", block + "norm1.weight", block + "attn.qkv.weight", block + "attn.qkv.bias",
              block + "attn.proj.weight", block + "attn.proj.bias", block + "norm2.bias", block + "mlp.0.weight",
              block + "mlp.0.bias", block + "mlp.3.weight", block + "mlp.3.bias"}
    assert shared <= v1 and shared <= v2
    assert block + "attn.relative_position_bias_table" in v1 and len(v1) == 11 + 13 * 4
    assert {block + "attn.logit_scale", block + "attn.cpb_mlp.0.weight", block + "attn.cpb_mlp.0.bias",
            block + "attn.cpb_mlp.2.weight"} <= v2 and len(v2) == 11 + 16 * 4
    sd = _port().state_dict()
    assert sd["features.0.0.weight"].shape == (16, 3, 4, 4) and sd["features.2.reduction.weight"].shape == (32, 64)
    assert sd["features.1.0.attn.relative_position_bias_table"].shape == (49, 2)


@pytest.mark.parametrize("attention,mlp,v2", [
    (None, None, False), ("block", "block", False), ("block", "plain", False), ("plain", "block", False),
    ("plain", "plain", False), (None, None, True), ("block", "plain", True), ("plain", "block", True),
    ("plain", "plain", True)])
def test_routes_agree_with_jax(rng, images, monkeypatch, attention, mlp, v2):
    # the JAX side: its fused kernels for "block" (and None, which picks them at this size), in interpret mode
    monkeypatch.setattr(jswin, "FUSED_ATTENTION", attention in (None, "block"))
    monkeypatch.setattr(jswin, "FUSED_MLP", mlp in (None, "block"))
    model = _port(v2, attention=attention, mlp=mlp)
    sd = _randomised_state(rng, model)
    ref = np.asarray(_jax(v2).apply(torch_weights.swin_from_torch(sd, DEPTHS), jnp.asarray(images)))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(), ref, atol=1e-4)
    assert model.routes(2, 32, 32) == [(attention or "block", mlp or "block")] * 4


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_padded_maps_take_the_plain_route_and_match_jax(rng, v2):
    """40x40 images: 10x10 and 5x5 maps are padded to 12x12 and 8x8 for windows of 4, and 5x5 is padded to 6x6
    before it is merged."""
    images = rng.random((2, 40, 40, 3), dtype=np.float32)
    model = _port(v2)
    sd = _randomised_state(rng, model)
    ref = np.asarray(_jax(v2).apply(torch_weights.swin_from_torch(sd, DEPTHS), jnp.asarray(images)))
    np.testing.assert_allclose(model(torch.from_numpy(images)).numpy(), ref, atol=1e-4)
    assert model.routes(2, 40, 40) == [("plain", "block")] * 4
    assert model.blocks()[1].geometry(10, 10) == (12, 12, 2, 2) and model.blocks()[3].geometry(5, 5) == (8, 8, 2, 2)
    # the rule belongs to None alone: an explicit kernel route raises where its kernel does not take the map
    asked = _port(v2, attention="block")
    with pytest.raises(ValueError, match='attention="block"'):
        asked(torch.from_numpy(images))
    with pytest.raises(ValueError, match='attention="block"'):
        asked.routes(2, 40, 40)
    assert asked.routes(2, 32, 32) == [("block", "block")] * 4


@pytest.mark.parametrize("attention,mlp", [(None, None), ("plain", "plain")])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_bfloat16_matches_jax(rng, images, monkeypatch, attention, mlp, v2):
    monkeypatch.setattr(jswin, "FUSED_ATTENTION", attention is None)
    monkeypatch.setattr(jswin, "FUSED_MLP", mlp is None)
    model = _port(v2, torch.bfloat16, attention=attention, mlp=mlp)
    sd = _randomised_state(rng, model)
    ref = _jax(v2, jnp.bfloat16).apply(torch_weights.swin_from_torch(sd, DEPTHS), jnp.asarray(images))
    out = model(torch.from_numpy(images))
    assert out.dtype == torch.bfloat16
    # bfloat16 logits come in steps of 2^-8 of their value: 2e-2·(1 + |ref|), as the kernels' own tolerance
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2e-2, rtol=2e-2)


# the last stage's 384 channels need no padding, as Swin-T's: final norm and head keep their native size
PADDED = dict(embed_dim=96, depths=(1, 1, 1), num_heads=(3, 6, 12), window_size=2)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("attention,mlp", [(None, None), ("plain", "plain")])
def test_padded_swin_matches_the_native_one_and_jax(rng, images, attention, mlp, v2):
    native = models.SwinTransformer(**PADDED, num_classes=CLASSES, v2=v2, attention=attention, mlp=mlp)
    sd = _randomised_state(rng, native)
    padded = models.SwinTransformer(**PADDED, num_classes=CLASSES, v2=v2, pad_channels=True, attention=attention, mlp=mlp)
    padded_sd = models.pad_swin_state_dict(sd, 96, PADDED["depths"], PADDED["num_heads"], v2)
    padded.load_state_dict(padded_sd)
    x = torch.from_numpy(images)
    np.testing.assert_allclose(padded(x).numpy(), native(x).numpy(), atol=1e-4)
    assert padded.blocks()[0].dim == 128 and padded.blocks()[0].num_heads == 4 and padded.blocks()[0].mlp_dim == 384
    assert padded.blocks()[1].dim == 256 and padded.blocks()[1].num_heads == 8
    # the JAX package's converter pads the same native parameters to the same layout
    variables = jpadded.pad_swin_variables(torch_weights.swin_from_torch(sd, PADDED["depths"]), 96, PADDED["depths"],
                                           PADDED["num_heads"], v2)
    back = models.swin_state_dict_from_numpy(_numpy_tree(variables), PADDED["depths"])
    assert set(back) == set(padded_sd) and all(torch.equal(back[k], v) for k, v in padded_sd.items())
    jmodel = jswin.SwinTransformer(**PADDED, num_classes=CLASSES, v2=v2, pad_channels=True)
    np.testing.assert_allclose(padded(x).numpy(), np.asarray(jmodel.apply(variables, jnp.asarray(images))), atol=1e-4)


def test_swin_t_padded_keeps_the_padded_lanes_at_zero_from_construction():
    model = models.get_model("swin_t_padded", device="cpu", num_classes=5, generator=torch.Generator().manual_seed(0))
    native = models.get_model("swin_t", device="cpu", num_classes=5, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert sd["features.0.0.weight"].shape == (128, 3, 4, 4) and bool((sd["features.0.0.weight"][96:] == 0).all())
    assert bool((sd["features.1.0.norm1.weight"][96:] == 0).all()) and sd["features.1.0.mlp.0.weight"].shape == (384, 128)
    assert torch.equal(sd["features.1.0.attn.qkv.weight"][128:224, :96], native.state_dict()["features.1.0.attn.qkv.weight"][96:192])
    assert torch.equal(sd["features.5.0.attn.qkv.weight"], native.state_dict()["features.5.0.attn.qkv.weight"])
    block = model.blocks()[0]
    assert (block.dim, block.real_dim, block.num_heads) == (128, 96, 4) and isinstance(block.norm1, models.MaskedLayerNorm)
    stem = model.features[0]
    x = stem[2](stem[0](torch.rand(1, 8, 8, 3)))
    assert bool((x[..., 96:] == 0).all()) and bool((block(x)[..., 96:] == 0).all())


@pytest.mark.parametrize("name,dtype,size,batch", [
    ("swin_t", torch.bfloat16, 224, 256), ("swin_t", torch.float32, 224, 32), ("swin_b", torch.bfloat16, 224, 64),
    ("swin_v2_t", torch.bfloat16, 256, 64), ("swin_v2_b", torch.float32, 256, 8), ("swin_s", torch.float32, 232, 4)])
def test_default_routes_copy_the_jax_rules(name, dtype, size, batch):
    """The rules are held against the JAX block's own decisions: its formulas, evaluated by the JAX package's
    ``pick_group`` and the conditions of ``models/swin.py:263-269`` and ``:322-323``."""
    from cpu_vision_tpu.ops.pallas.swin_attention import pick_group

    dim, depths, heads, window = {"swin_t": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7), "swin_s": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7),
                                  "swin_b": (128, (2, 2, 18, 2), (4, 8, 16, 32), 7), "swin_v2_t": (96, (2, 2, 6, 2), (3, 6, 12, 24), 8),
                                  "swin_v2_b": (128, (2, 2, 18, 2), (4, 8, 16, 32), 8)}[name]
    it = 2 if dtype == torch.bfloat16 else 4
    side = size // 4
    for stage, nh in enumerate(heads):
        c, dh = dim * 2 ** stage, 4 * dim * 2 ** stage
        for shift in (0, window // 2):
            block = tswin.SwinBlock(c, nh, window, shift, dtype=dtype)
            ph, pw, sh, sw = block.geometry(side, side)
            nw_img, nsq = (ph // window) * (pw // window), window * window
            gsel = pick_group(batch * nw_img, nw_img, nh, sh + sw > 0)
            attn = ((ph, pw) == (side, side) and c % 8 == 0 and
                    (4 * c * c * it + nh * nsq * nsq * 4 + 2 * gsel * nsq * c * (4 + it) + nsq * 3 * c * 4) <= 12_500_000)
            mlp = c % 8 == 0 and (2 * c * dh * it <= 10_000_000 or dh % 256 == 0)
            assert block.routes(batch, side, side) == ("block" if attn else "plain", "block" if mlp else "plain")
            assert tswin.pick_group(batch * nw_img, nw_img, nh, sh + sw > 0) == gsel
        side = (side + 1) // 2
    if size == 224:  # Swin at 224 never pads, so every block of the served configurations runs both kernels
        model_routes = tswin.SwinBlock(dim, heads[0], window, 0, dtype=dtype).routes(batch, 56, 56)
        assert model_routes == ("block", "block")


def test_constants_are_built_once_and_follow_the_parameters(rng, images):
    model = _port(True)
    x = torch.from_numpy(images)
    block = model.blocks()[1]
    first = model(x)
    w_qkv, b_qkv, w_o, bias, logit_scale = block.attn.constants()
    assert w_qkv.shape == (16, 48) and w_o.shape == (16, 16) and bias.shape == (2, 16, 16) and logit_scale.shape == (2,)
    assert torch.equal(w_qkv, block.attn.qkv.weight.t()) and bool((b_qkv[16:32] == 0).all())  # v2 zeroes the key bias
    assert float(bias.min()) >= 0 and float(bias.max()) <= 16  # 16 · sigmoid
    model(x)
    assert block.attn.constants()[0] is w_qkv  # not rebuilt at every forward
    sd = _randomised_state(rng, model)  # in-place writes, as load_state_dict makes them
    assert block.attn.constants()[0] is not w_qkv
    assert not torch.equal(model(x), first)
    other = _port(True)
    other.load_state_dict(sd)
    assert torch.equal(other(x), model(x))


def test_helpers_match_jax():
    for ws in (2, 4, 7):
        assert np.array_equal(tswin._relative_position_index(ws), jswin._relative_position_index(ws))
        np.testing.assert_allclose(tswin._log_cpb_coords(ws), jswin._log_cpb_coords(ws), atol=1e-7)
    for args in ((8, 8, 4, 2, 2), (12, 8, 4, 2, 0), (14, 14, 7, 3, 3)):
        assert np.array_equal(tswin._shift_mask(*args).numpy(), np.asarray(jswin._shift_mask(*args)))
    x = torch.arange(2 * 8 * 12 * 3, dtype=torch.float32).reshape(2, 8, 12, 3)
    windows = tswin._window_partition(x, 4)
    assert np.array_equal(windows.numpy(), np.asarray(jswin._window_partition(jnp.asarray(x.numpy()), 4)))
    assert torch.equal(tswin._window_reverse(windows, 4, 2, 8, 12), x)


def test_masked_layer_norm_and_patch_merging_match_jax(rng):
    x = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
    x[..., 12:] = 0
    ln = models.MaskedLayerNorm(16, 12)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(rng.standard_normal(16).astype(np.float32)))
        ln.bias.copy_(torch.from_numpy(rng.standard_normal(16).astype(np.float32)))
    ref = jswin.MaskedLayerNorm(12).apply({"params": {"scale": jnp.asarray(ln.weight.detach().numpy()),
                                                      "bias": jnp.asarray(ln.bias.detach().numpy())}}, jnp.asarray(x))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(), np.asarray(ref), atol=1e-5)
    for v2 in (False, True):  # an odd map is padded before it is merged
        merging = models.PatchMerging(16, 32, v2)
        params = {"Dense_0": {"kernel": jnp.asarray(merging.reduction.weight.detach().numpy().T)},
                  "LayerNorm_0": {"scale": jnp.ones(merging.norm.weight.shape), "bias": jnp.zeros(merging.norm.bias.shape)}}
        ref = jswin.PatchMerging(32, v2).apply({"params": params}, jnp.asarray(x))
        out = merging(torch.from_numpy(x))
        assert out.shape == (2, 3, 4, 32)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("name,params,blocks,last_heads", [
    ("swin_t", 28288354, 12, 24), ("swin_s", 49606258, 24, 24), ("swin_b", 87768224, 24, 32),
    ("swin_v2_t", 28351570, 12, 24), ("swin_v2_s", 49737442, 24, 24), ("swin_v2_b", 87930848, 24, 32)])
def test_registered_models_have_the_references_parameter_counts(name, params, blocks, last_heads):
    model = models.get_model(name, device="cpu")  # the counts torchvision publishes for the same names
    assert sum(p.numel() for p in model.parameters()) == params
    assert len(model.blocks()) == blocks and model.blocks()[-1].num_heads == last_heads
    assert model.v2 == ("v2" in name) and model.window_size == (8 if model.v2 else 7)
    assert next(model.parameters()).device.type == "cpu" and not model.training


def test_registry_and_bad_arguments():
    assert models.list_models("swin*") == ["swin_b", "swin_s", "swin_t", "swin_t_padded", "swin_v2_b", "swin_v2_s", "swin_v2_t"]
    model = models.SwinTransformer(96, (1, 1), (3, 6), 8, num_classes=5, v2=True)
    assert model(torch.zeros(1, 64, 64, 3)).shape == (1, 5) and not model.training
    built = models.get_model("swin_t", device="cpu", num_classes=3, generator=torch.Generator().manual_seed(0))
    assert isinstance(built, models.SwinTransformer) and next(built.parameters()).device.type == "cpu"
    assert len(built.blocks()) == 12 and built.blocks()[11].num_heads == 24 and built.head.weight.shape == (3, 768)
    with pytest.raises(ValueError):
        _port(attention="flash")
    with pytest.raises(ValueError):
        _port(mlp="xla")
    with pytest.raises(TypeError):
        _port(dtype=torch.float16)
    with pytest.raises(ValueError):
        _port()(torch.zeros(1, 30, 30, 3))  # sides must be multiples of the 4x4 patch
    with pytest.raises(NotImplementedError):
        _port()(torch.zeros(1, 32, 32, 3), train=True)
    with pytest.raises(NotImplementedError):
        models.StochasticDepth(0.1)(torch.zeros(1), train=True)
    assert models.StochasticDepth(0.1)(torch.ones(2)).sum() == 2
