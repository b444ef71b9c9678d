"""The port's int8 transformer sub-blocks (``ops/kernels/int8_transformer.py``)
against the JAX package's Pallas kernels (``ops/pallas/int8_transformer.py``,
interpret mode) on the CPU, where the wrappers run their plain twins.

The same inputs, made from a seed with numpy, and the same int8 weights and
scales (quantised once, by the JAX ``quantize_weight``) go to both sides.  The
int8 products are exact on both; LayerNorm statistics, the exponentials and
the float32 sums of the attention core round differently, so a quantised
activation near a rounding half may land one step apart.  Measured on these
seeds, max |a - b| / max |b|: 3.6e-3 (MLP) and 3.8e-3 (attention) with
per-channel scales, under 1e-9 with one scale a tensor; held to 1e-2, tighter
than the JAX tests' own 0.02 (MLP) and 0.03 (attention) against the float
math.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops.pallas import int8_transformer as jit8
from cpu_vision_tpu.ops.pallas.transformer_block import _gelu_f32, _ln_f32
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import int8_transformer as tit8

TOL = 1e-2


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


def _t(a):
    return torch.from_numpy(np.array(a))


def _ln_params(rng, d):
    return rng.uniform(0.5, 1.5, d).astype(np.float32), (rng.standard_normal(d) * 0.1).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_weight_matches_jax(rng, dtype):
    w = (rng.standard_normal((96, 40)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # a zero column takes the 1e-8 floor
    q, s = jit8.quantize_weight(jnp.asarray(w))
    tq, ts = tit8.quantize_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))


@pytest.mark.parametrize("m_tok,d,dh,per_channel", [(70, 256, 512, True), (70, 256, 512, False), (24, 1280, 5120, True)],
                         ids=["per-channel", "per-tensor", "vit-h-widths"])
def test_mlp_block_int8_matches_jax(rng, m_tok, d, dh, per_channel):
    """At ViT-H's widths the JAX kernel sums four float32 partials of hidden blocks of 1280
    (``_pick_block_dh``), the port one int32 sum: measured 8.6e-5 of max |out|, one of 30,720
    bfloat16 outputs a step apart."""
    x = jnp.asarray(rng.standard_normal((m_tok, d)), jnp.bfloat16)
    g, b = _ln_params(rng, d)
    w1 = (rng.standard_normal((d, dh)) * (0.05 if d == 256 else d ** -0.5)).astype(np.float32)
    b1 = (rng.standard_normal(dh) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((dh, d)) * (0.05 if d == 256 else dh ** -0.5)).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    h = _ln_f32(x.astype(jnp.float32), g, b, 1e-6)
    f = _gelu_f32(h @ w1 + b1)
    a1, a2 = jnp.max(jnp.abs(h), axis=0) / 127.0, jnp.max(jnp.abs(f), axis=0) / 127.0
    if not per_channel:
        a1, a2 = jnp.max(a1), jnp.max(a2)
    qw1, s1 = jit8.quantize_weight(w1 * jnp.broadcast_to(a1, (d,))[:, None])
    qw2, s2 = jit8.quantize_weight(w2 * jnp.broadcast_to(a2, (dh,))[:, None])
    ref = jit8.mlp_block_int8(x, g, b, qw1, s1, b1, qw2, s2, b2, a1, a2, interpret=True)
    xt = _t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    got = kernels.mlp_block_int8(xt, *map(_t, (g, b, qw1, s1, b1, qw2, s2, b2, a1, a2)))
    assert got.dtype == torch.bfloat16 and got.shape == (m_tok, d)
    assert _rel(got.float().numpy(), ref.astype(jnp.float32)) < TOL
    assert kernels.mlp_block_int8.launches == 0


@pytest.mark.parametrize("per_channel", [True, False])
def test_attention_block_int8_matches_jax(rng, per_channel):
    n, s, d, heads = 2, 33, 256, 4
    hd = d // heads
    x = jnp.asarray(rng.standard_normal((n, s, d)), jnp.bfloat16)
    g, b = _ln_params(rng, d)
    wqkv = (rng.standard_normal((d, 3 * d)) * 0.05).astype(np.float32)
    bqkv = (rng.standard_normal(3 * d) * 0.1).astype(np.float32)
    wo = (rng.standard_normal((d, d)) * 0.05).astype(np.float32)
    bo = (rng.standard_normal(d) * 0.1).astype(np.float32)
    scale = 1.0 / float(hd) ** 0.5
    h = _ln_f32(x.astype(jnp.float32), g, b, 1e-6).reshape(-1, d)
    qkv = (h @ wqkv + bqkv).reshape(n, s, 3 * d)
    q, k, v = [t.reshape(n, s, heads, hd) for t in jnp.split(qkv, 3, -1)]
    p = jnp.exp(jnp.einsum("nqhd,nkhd->nhqk", q, k) * scale)
    o = jnp.einsum("nhqk,nkhd->nqhd", p / p.sum(-1, keepdims=True), v).reshape(-1, d)
    a1, ao = jnp.max(jnp.abs(h), axis=0) / 127.0, jnp.max(jnp.abs(o), axis=0) / 127.0
    if not per_channel:
        a1, ao = jnp.max(a1), jnp.max(ao)
    qwqkv, sqkv = jit8.quantize_weight(wqkv * jnp.broadcast_to(a1, (d,))[:, None])
    qwo, so = jit8.quantize_weight(wo * jnp.broadcast_to(ao, (d,))[:, None])
    ref = jit8.attention_block_int8(x, g, b, qwqkv, sqkv, bqkv, qwo, so, bo, a1, ao, heads, scale, interpret=True)
    xt = _t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    got = kernels.attention_block_int8(xt, *map(_t, (g, b, qwqkv, sqkv, bqkv, qwo, so, bo, a1, ao)), heads, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (n, s, d)
    assert _rel(got.float().numpy(), ref.astype(jnp.float32)) < TOL
    assert kernels.attention_block_int8.launches == 0 and kernels.attention_block_int8.kernel_launches == 0


def test_float32_input_keeps_its_dtype(rng):
    d, dh = 256, 256
    x = torch.from_numpy(rng.standard_normal((5, d)).astype(np.float32))
    qw1, s1 = tit8.quantize_weight(torch.from_numpy((rng.standard_normal((d, dh)) * 0.05).astype(np.float32)))
    qw2, s2 = tit8.quantize_weight(torch.from_numpy((rng.standard_normal((dh, d)) * 0.05).astype(np.float32)))
    ones, zeros = torch.ones(d), torch.zeros(d)
    out = kernels.mlp_block_int8(x, ones, zeros, qw1, s1, torch.zeros(dh), qw2, s2, zeros, 0.03, 0.01)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_domains_and_bad_arguments(rng):
    assert tit8.mlp_kernel_takes(768, 3072) and tit8.mlp_kernel_takes(1280, 5120) and tit8.mlp_kernel_takes(1024, 4096)
    assert not tit8.mlp_kernel_takes(640, 2560) and not tit8.mlp_kernel_takes(768, 3000)
    assert tit8.attention_kernel_takes(768, 12) and tit8.attention_kernel_takes(1280, 16)
    assert not tit8.attention_kernel_takes(384, 12) and not tit8.attention_kernel_takes(768, 7)
    x = torch.zeros((4, 256))
    qw, s = tit8.quantize_weight(torch.ones((256, 256)))
    with pytest.raises(ValueError):
        kernels.mlp_block_int8(x, torch.ones(256), torch.zeros(256), qw, s, torch.zeros(256), qw[:128], s, torch.zeros(256),
                               1.0, 1.0)
    with pytest.raises(TypeError):
        kernels.mlp_block_int8(x, torch.ones(256), torch.zeros(256), qw.float(), s, torch.zeros(256), qw, s,
                               torch.zeros(256), 1.0, 1.0)
