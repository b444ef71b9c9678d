"""The port's fused transformer sub-blocks
(``cpu_vision_tpu_torch.ops.kernels.transformer_block``) against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

On CPU tensors the wrappers run their plain twins.  Tolerances: float32
``2e-5·(1 + |ref|)`` (the matrix products sum in another order on each side);
bfloat16 weights ``2e-2·(1 + |ref|)`` (one bfloat16 step is 2^-8 of the
value, and the two sides round a few activations on opposite sides of a
step).  The CUDA kernels are held against the twins on the card by
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops.pallas import transformer_block as jtb
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import transformer_block as ttb

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _mlp_inputs(rng, m, d, dh):
    return dict(x=rng.standard_normal((m, d)).astype(np.float32),
                ln_g=(1 + 0.2 * rng.standard_normal(d)).astype(np.float32),
                ln_b=(0.1 * rng.standard_normal(d)).astype(np.float32),
                w1=(rng.standard_normal((d, dh)) * d ** -0.5).astype(np.float32),
                b1=(0.1 * rng.standard_normal(dh)).astype(np.float32),
                w2=(rng.standard_normal((dh, d)) * dh ** -0.5).astype(np.float32),
                b2=(0.1 * rng.standard_normal(d)).astype(np.float32))


def _attn_inputs(rng, n, s, d):
    return dict(x=rng.standard_normal((n, s, d)).astype(np.float32),
                ln_g=(1 + 0.2 * rng.standard_normal(d)).astype(np.float32),
                ln_b=(0.1 * rng.standard_normal(d)).astype(np.float32),
                w_qkv=(rng.standard_normal((d, 3 * d)) * d ** -0.5).astype(np.float32),
                b_qkv=(0.1 * rng.standard_normal(3 * d)).astype(np.float32),
                w_o=(rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32),
                b_o=(0.1 * rng.standard_normal(d)).astype(np.float32))


def _both(inputs, weights, wdtype, xdtype="float32"):
    """The inputs as JAX arrays and as CPU tensors; ``weights`` in ``wdtype``,
    ``x`` in ``xdtype``, LayerNorm parameters and biases float32."""
    def dtype_of(name):
        return wdtype if name in weights else xdtype if name == "x" else "float32"

    jax_args = [jnp.asarray(v).astype(JDT[dtype_of(k)]) for k, v in inputs.items()]
    torch_args = [torch.from_numpy(v).to(TDT[dtype_of(k)]) for k, v in inputs.items()]
    return jax_args, torch_args


def _assert_close(out, ref, tol):
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    assert out.shape == ref.shape
    assert np.all(np.abs(out - ref) <= tol + tol * np.abs(ref)), float(np.abs(out - ref).max())


@pytest.mark.parametrize("wdtype,xdtype", [("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("m,d,dh,block_m", [(64, 128, 256, 32), (37, 128, 512, 16), (5, 256, 256, 8)],
                         ids=["even", "ragged", "short"])
def test_mlp_block_matches_pallas_interpret(rng, m, d, dh, block_m, wdtype, xdtype):
    jargs, targs = _both(_mlp_inputs(rng, m, d, dh), ("w1", "w2"), wdtype, xdtype)
    ref = jtb.mlp_block(*jargs, 1e-6, block_m, True)
    out = kernels.mlp_block(*targs, 1e-6)
    assert out.dtype == TDT[xdtype]
    _assert_close(out, ref, TOL[wdtype])
    assert kernels.launch_counts()["mlp_block"] == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("post_norm,ln_count", [(True, 0), (False, 96), (True, 96)],
                         ids=["post_norm", "ln_count", "post_norm+ln_count"])
def test_mlp_block_twin_options_match_pallas_interpret(rng, post_norm, ln_count, wdtype):
    inputs = _mlp_inputs(rng, 24, 128, 256)
    if ln_count:  # a zero-padded channel layout: real channels first
        for name in ("x", "ln_g", "ln_b", "b2"):
            inputs[name][..., ln_count:] = 0
        inputs["w1"][ln_count:] = 0
        inputs["w2"][:, ln_count:] = 0
    jargs, targs = _both(inputs, ("w1", "w2"), wdtype)
    ref = jtb.mlp_block(*jargs, 1e-6, 8, True, post_norm, ln_count)
    out = ttb.mlp_block_plain(*targs, 1e-6, post_norm, ln_count)
    _assert_close(out, ref, TOL[wdtype])
    _assert_close(kernels.mlp_block(*targs, 1e-6, post_norm, ln_count), ref, TOL[wdtype])


@pytest.mark.parametrize("wdtype,xdtype", [("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("n,s,d,heads", [(2, 17, 128, 4), (1, 50, 128, 2), (3, 5, 64, 4)])
def test_attention_block_matches_pallas_interpret(rng, n, s, d, heads, wdtype, xdtype):
    jargs, targs = _both(_attn_inputs(rng, n, s, d), ("w_qkv", "w_o"), wdtype, xdtype)
    scale = (d // heads) ** -0.5
    ref = jtb.attention_block(*jargs, heads, scale, 1e-6, True)
    out = kernels.attention_block(*targs, heads, scale, 1e-6)
    assert out.dtype == TDT[xdtype]
    _assert_close(out, ref, TOL[wdtype])
    _assert_close(ttb.attention_block_plain(*targs, heads, scale, 1e-6), ref, TOL[wdtype])
    assert kernels.launch_counts()["attention_block"] == 0


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_twins_match_the_jax_reference_math(rng, wdtype):
    jargs, targs = _both(_mlp_inputs(rng, 19, 128, 256), ("w1", "w2"), wdtype)
    _assert_close(ttb.mlp_block_plain(*targs), jtb._ref_math(*jargs, 1e-6, JDT[wdtype]), TOL[wdtype])
    jargs, targs = _both(_attn_inputs(rng, 2, 9, 64), ("w_qkv", "w_o"), wdtype)
    _assert_close(ttb.attention_block_plain(*targs, 4, 0.25),
                  jtb._attn_ref_math(*jargs, 4, 0.25, 1e-6, JDT[wdtype]), TOL[wdtype])


def test_erf_gelu_and_layer_norm_helpers_match_jax(rng):
    h = (3 * rng.standard_normal((7, 33))).astype(np.float32)
    np.testing.assert_allclose(ttb._erf_f32(torch.from_numpy(h)).numpy(), np.asarray(jtb._erf_f32(jnp.asarray(h))),
                               atol=5e-7)  # a few float32 steps near 1: exp and the divide round differently
    np.testing.assert_allclose(ttb._gelu_f32(torch.from_numpy(h)).numpy(), np.asarray(jtb._gelu_f32(jnp.asarray(h))),
                               atol=1e-6)
    np.testing.assert_allclose(ttb._erf_f32(torch.from_numpy(h)).numpy(), torch.erf(torch.from_numpy(h)).numpy(),
                               atol=5e-7)  # the polynomial's own bound is 1.5e-7, plus float32 rounding
    g, b = rng.standard_normal(33).astype(np.float32), rng.standard_normal(33).astype(np.float32)
    for count in (0, 20):
        ref = jtb._ln_f32(jnp.asarray(h), jnp.asarray(g), jnp.asarray(b), 1e-6, count)
        out = ttb._ln_f32(torch.from_numpy(h), torch.from_numpy(g), torch.from_numpy(b), 1e-6, count)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bad_arguments_raise(rng):
    mlp = [torch.from_numpy(v) for v in _mlp_inputs(rng, 4, 128, 256).values()]
    with pytest.raises(ValueError):  # 3-D input
        kernels.mlp_block(mlp[0][None], *mlp[1:])
    with pytest.raises(ValueError):  # w2 does not match w1
        kernels.mlp_block(*mlp[:5], mlp[5][:, :64], mlp[6])
    with pytest.raises(ValueError):  # bias of the wrong length
        kernels.mlp_block(*mlp[:4], mlp[4][:8], *mlp[5:])
    with pytest.raises(TypeError):
        kernels.mlp_block(mlp[0].long(), *mlp[1:])
    with pytest.raises(ValueError):
        kernels.mlp_block(*(t.to("meta") for t in mlp))
    attn = [torch.from_numpy(v) for v in _attn_inputs(rng, 1, 4, 64).values()]
    with pytest.raises(ValueError):  # 64 is not a multiple of 5 heads
        kernels.attention_block(*attn, 5, 0.25)
    with pytest.raises(ValueError):  # 2-D input
        kernels.attention_block(attn[0][0], *attn[1:], 4, 0.25)
    with pytest.raises(ValueError):  # w_o of the wrong shape
        kernels.attention_block(*attn[:5], attn[5][:, :32], attn[6], 4, 0.25)
