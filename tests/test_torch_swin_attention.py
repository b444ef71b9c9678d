"""The port's fused Swin window attention
(``cpu_vision_tpu_torch.ops.kernels.swin_attention``) against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

On CPU tensors the wrapper runs its plain twin.  The shapes are the stage
shapes Swin-T runs, so both Pallas kernels are hit: the head-packed one
(heads · S ≤ 700) and the per-head one.  Tolerances: float32
``rtol = atol = 2e-5`` (the products sum in another order on each side),
``2e-4`` where per-head logit scales spread the logits over ±100; bfloat16
``3e-2``: the packed Pallas kernel rounds exp() before the division by the
softmax sum, the port after it.  The CUDA kernels are held against the twin
on the card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.models.swin import _shift_mask
from cpu_vision_tpu.ops.pallas import swin_attention as jsa
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import swin_attention as tsa

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rng, nw, s, c, heads, v2, masked, nw_img):
    ws = int(round(s ** 0.5))
    side = int(round(nw_img ** 0.5)) * ws
    return dict(
        x=rng.standard_normal((nw, s, c)).astype(np.float32),
        ln_g=rng.uniform(0.5, 1.5, c).astype(np.float32),
        ln_b=(rng.standard_normal(c) * 0.1).astype(np.float32),
        w_qkv=(rng.standard_normal((c, 3 * c)) * 0.05).astype(np.float32),
        b_qkv=(rng.standard_normal(3 * c) * 0.02).astype(np.float32),
        w_o=(rng.standard_normal((c, c)) * 0.05).astype(np.float32),
        b_o=(rng.standard_normal(c) * 0.02).astype(np.float32),
        rel_bias=(rng.standard_normal((heads, s, s)) * 0.3).astype(np.float32),
        mask=np.asarray(_shift_mask(side, side, ws, ws // 2, ws // 2)) if masked else None,
        logit_scale=rng.uniform(0.5, 2.0, heads).astype(np.float32) if v2 else None)


def _both(inputs, dtype="float32"):
    """The inputs as JAX arrays and as CPU tensors: ``x`` and the two weights
    in ``dtype``, everything else float32."""
    def cast(name, value, array, table):
        return None if value is None else array(value).astype(table[dtype]) if name in ("x", "w_qkv", "w_o") else array(value)

    jargs = [cast(k, v, jnp.asarray, JDT) for k, v in inputs.items()]
    targs = [None if v is None else torch.from_numpy(np.array(v)).to(TDT[dtype] if k in ("x", "w_qkv", "w_o") else torch.float32)
             for k, v in inputs.items()]
    return jargs, targs


def _assert_close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "nw,s,c,heads,v2,masked,nw_img",
    [
        (64, 49, 96, 3, False, False, 64),    # swin_t stage 1
        (64, 49, 96, 3, False, True, 64),     # stage 1 shifted
        (16, 49, 192, 6, False, True, 16),    # stage 2 shifted
        (8, 49, 384, 12, False, False, 4),    # stage 3, 2 images
        (4, 49, 768, 24, False, True, 1),     # stage 4 shifted
        (16, 64, 96, 3, True, False, 16),     # v2, window 8
        (16, 64, 96, 3, True, True, 16),      # v2 shifted
        (8, 49, 192, 6, True, True, 4),       # v2 with an odd S
    ],
)
def test_window_attention_block_matches_pallas_interpret(nw, s, c, heads, v2, masked, nw_img):
    rng = np.random.default_rng(0)
    jargs, targs = _both(_inputs(rng, nw, s, c, heads, v2, masked, nw_img))
    scale = float((c // heads) ** -0.5)
    ref = jsa.window_attention_block(*jargs, heads, scale, 1e-5, v2, nw_img, True)
    out = kernels.window_attention_block(*targs, heads, scale, 1e-5, v2, nw_img)
    assert out.dtype == torch.float32 and out.shape == (nw, s, c)
    _assert_close(out, ref, 2e-5)
    _assert_close(out, jsa._ref_math(*jargs, heads, scale, 1e-5, v2, nw_img, jnp.float32), 2e-5)
    assert kernels.launch_counts()["window_attention_block"] == 0  # CPU tensors launch nothing


def test_per_head_softmax_under_an_extreme_spread_of_logit_scales():
    """v2 with per-head logit scales 100, 0.01 and 1: a row maximum taken over
    all heads would underflow the quiet heads to zero."""
    rng = np.random.default_rng(7)
    nw, s, c, heads, nw_img = 16, 64, 96, 3, 16
    inputs = _inputs(rng, nw, s, c, heads, True, False, nw_img)
    inputs["logit_scale"] = np.array([100.0, 0.01, 1.0], np.float32)
    inputs["rel_bias"] *= 0.0
    jargs, targs = _both(inputs)
    scale = float((c // heads) ** -0.5)
    ref = jsa.window_attention_block(*jargs, heads, scale, 1e-5, True, nw_img, True)
    _assert_close(kernels.window_attention_block(*targs, heads, scale, 1e-5, True, nw_img), ref, 2e-4)


def test_per_head_softmax_under_a_constant_bias_offset_per_head():
    """v1: a large constant offset of one head's bias changes no softmax."""
    rng = np.random.default_rng(8)
    nw, s, c, heads, nw_img = 64, 49, 96, 3, 64
    inputs = _inputs(rng, nw, s, c, heads, False, False, nw_img)
    inputs["rel_bias"] += np.array([0.0, -150.0, 120.0], np.float32)[:, None, None]
    jargs, targs = _both(inputs)
    scale = float((c // heads) ** -0.5)
    ref = jsa.window_attention_block(*jargs, heads, scale, 1e-5, False, nw_img, True)
    _assert_close(kernels.window_attention_block(*targs, heads, scale, 1e-5, False, nw_img), ref, 2e-4)


@pytest.mark.parametrize("v2", [False, True])
def test_ln_count_matches_pallas_interpret(v2):
    """A zero-padded channel layout: 96 real channels (3 heads) in 128 lanes (4 heads)."""
    rng = np.random.default_rng(3)
    nw, s, c, heads, nw_img, real = 8, 49, 128, 4, 4, 96
    inputs = _inputs(rng, nw, s, c, heads, v2, True, nw_img)
    for name in ("x", "ln_g", "ln_b", "b_o"):
        inputs[name][..., real:] = 0
    inputs["w_qkv"][real:] = 0
    inputs["w_o"][:, real:] = 0
    jargs, targs = _both(inputs)
    scale = float((c // heads) ** -0.5)
    ref = jsa.window_attention_block(*jargs, heads, scale, 1e-5, v2, nw_img, True, real)
    out = kernels.window_attention_block(*targs, heads, scale, 1e-5, v2, nw_img, real)
    _assert_close(out, ref, 2e-5)
    assert bool((out[..., real:] == 0).all())  # the padded lanes stay zero


@pytest.mark.parametrize("v2,masked", [(False, True), (True, False)])
def test_bfloat16_matches_pallas_interpret(v2, masked):
    rng = np.random.default_rng(1)
    nw, s, c, heads, nw_img = 16, 49, 192, 6, 16
    jargs, targs = _both(_inputs(rng, nw, s, c, heads, v2, masked, nw_img), "bfloat16")
    scale = float((c // heads) ** -0.5)
    ref = jsa.window_attention_block(*jargs, heads, scale, 1e-5, v2, nw_img, True)
    out = kernels.window_attention_block(*targs, heads, scale, 1e-5, v2, nw_img)
    assert out.dtype == torch.bfloat16
    _assert_close(out, ref, 3e-2)
    _assert_close(tsa.window_attention_block_plain(*targs, heads, scale, 1e-5, v2, nw_img),
                  jsa._ref_math(*jargs, heads, scale, 1e-5, v2, nw_img, jnp.bfloat16), 3e-2)


def test_bad_arguments_raise():
    rng = np.random.default_rng(0)
    _, args = _both(_inputs(rng, 4, 16, 64, 2, True, True, 4))
    tail = (2, 0.2, 1e-5, True, 4)
    with pytest.raises(ValueError):  # 2-D input
        kernels.window_attention_block(args[0][0], *args[1:], *tail)
    with pytest.raises(ValueError):  # 64 channels are no multiple of 3 heads
        kernels.window_attention_block(*args, 3, 0.2, 1e-5, True, 4)
    with pytest.raises(ValueError):  # rel_bias of the wrong shape
        kernels.window_attention_block(*args[:7], args[7][:, :8], *args[8:], *tail)
    with pytest.raises(ValueError):  # 4 windows are no whole number of images of 3
        kernels.window_attention_block(*args[:8], None, args[9], 2, 0.2, 1e-5, True, 3)
    with pytest.raises(ValueError):  # v2 without a logit scale
        kernels.window_attention_block(*args[:9], None, *tail)
    with pytest.raises(ValueError):  # ln_count past C
        kernels.window_attention_block(*args, *tail, 65)
    with pytest.raises(TypeError):
        kernels.window_attention_block(args[0].long(), *args[1:], *tail)
    with pytest.raises(ValueError):
        kernels.window_attention_block(*(None if t is None else t.to("meta") for t in args), *tail)
