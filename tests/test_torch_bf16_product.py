"""The bfloat16 product of the transformer blocks (``kernels.bf16_product``,
``csrc/ln_gemm.cuh:tc_gemm_kernel`` on the card) on the CPU.

Its twin against the JAX package's own math on the same numpy inputs: the
Pallas kernels' ``jnp.dot(..., preferred_element_type=float32)`` of bfloat16
operands, plus the bias, then ``_gelu_f32`` or the residual, rounded once to
the output type; held to ``2e-2·(1 + |ref|)`` in bfloat16 (one step is 2^-8
of the value, and the sums run in other orders) and ``2e-5·(1 + |ref|)`` with
a float32 output.  And the chain the bf16 blocks launch on the card (LayerNorm
rows rounded to bf16, the product with gelu, the product with the residual,
or into a float32 branch for the post-norm) against ``mlp_block_plain`` and
``cn_mlp_block_plain``: the same operations, so the same bits.  The kernel
itself is held against the twin on the card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops.pallas import transformer_block as jtb
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import transformer_block as ttb

EPILOGUES = ["bias", "bias_f32", "gelu", "residual", "residual_gamma"]


def _inputs(rng, m, k, n):
    return dict(a=rng.standard_normal((m, k)).astype(np.float32),
                w=(rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32),
                bias=(0.1 * rng.standard_normal(n)).astype(np.float32),
                resid=rng.standard_normal((m, n)).astype(np.float32),
                gamma=(0.5 * rng.standard_normal(n)).astype(np.float32))


def _jax_product(inp, epilogue):
    a, w = (jnp.asarray(inp[k]).astype(jnp.bfloat16) for k in ("a", "w"))
    acc = jnp.dot(a, w, preferred_element_type=jnp.float32) + jnp.asarray(inp["bias"])
    if epilogue == "gelu":
        acc = jtb._gelu_f32(acc)
    elif epilogue.startswith("residual"):
        if epilogue == "residual_gamma":
            acc = acc * jnp.asarray(inp["gamma"])
        acc = jnp.asarray(inp["resid"]).astype(jnp.bfloat16).astype(jnp.float32) + acc
    return np.asarray(acc.astype(jnp.float32 if epilogue == "bias_f32" else jnp.bfloat16).astype(jnp.float32))


def _torch_product(inp, epilogue):
    a, w = (torch.from_numpy(inp[k]).bfloat16() for k in ("a", "w"))
    resid = torch.from_numpy(inp["resid"]).bfloat16() if epilogue.startswith("residual") else None
    gamma = torch.from_numpy(inp["gamma"]) if epilogue == "residual_gamma" else None
    out_dtype = torch.float32 if epilogue == "bias_f32" else torch.bfloat16
    return kernels.bf16_product(a, w, torch.from_numpy(inp["bias"]), epilogue.split("_")[0], resid, gamma, out_dtype)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (37, 96, 288), (129, 64, 136)])
def test_product_twin_matches_the_jax_math(rng, m, k, n, epilogue):
    inp = _inputs(rng, m, k, n)
    out = _torch_product(inp, epilogue)
    assert out.shape == (m, n) and out.dtype == (torch.float32 if epilogue == "bias_f32" else torch.bfloat16)
    ref = _jax_product(inp, epilogue)
    tol = 2e-5 if epilogue == "bias_f32" else 2e-2
    err = np.abs(out.float().numpy() - ref)
    assert np.all(err <= tol + tol * np.abs(ref)), float(err.max())
    assert kernels.bf16_product.launches == 0  # CPU tensors: the twin, no launch


def _ln_rows(x, g, b, eps, count=0):
    """What the row pass writes: LayerNorm in float32, rounded to bfloat16."""
    return ttb._ln_f32(x.float(), g, b, eps, count).bfloat16()


@pytest.mark.parametrize("post_norm,ln_count", [(False, 0), (False, 80), (True, 0), (True, 80)],
                         ids=["pre_norm", "ln_count", "post_norm", "post_norm_ln_count"])
def test_the_mlp_chain_of_products_is_the_twin(rng, post_norm, ln_count):
    m, d, dh = 41, 96, 384
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).bfloat16()
    g, b = (torch.from_numpy((s * rng.standard_normal(d) + c).astype(np.float32)) for s, c in ((0.2, 1.0), (0.1, 0.0)))
    w1 = torch.from_numpy((rng.standard_normal((d, dh)) * d ** -0.5).astype(np.float32)).bfloat16()
    w2 = torch.from_numpy((rng.standard_normal((dh, d)) * dh ** -0.5).astype(np.float32)).bfloat16()
    b1, b2 = (torch.from_numpy((0.1 * rng.standard_normal(n)).astype(np.float32)) for n in (dh, d))
    hidden = kernels.bf16_product(x if post_norm else _ln_rows(x, g, b, 1e-5, ln_count), w1, b1, "gelu")
    if post_norm:
        branch = kernels.bf16_product(hidden, w2, b2, out_dtype=torch.float32)
        chain = (x.float() + ttb._ln_f32(branch, g, b, 1e-5, ln_count)).bfloat16()
    else:
        chain = kernels.bf16_product(hidden, w2, b2, "residual", x)
    assert torch.equal(chain, kernels.mlp_block_plain(x, g, b, w1, b1, w2, b2, 1e-5, post_norm, ln_count))


def test_the_convnext_chain_of_products_is_the_twin(rng):
    m, d, dh = 29, 192, 768
    y, res = (torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).bfloat16() for _ in range(2))
    g, b, b2, gamma = (torch.from_numpy((0.3 * rng.standard_normal(d) + 0.5).astype(np.float32)) for _ in range(4))
    b1 = torch.from_numpy((0.1 * rng.standard_normal(dh)).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((d, dh)) * d ** -0.5).astype(np.float32)).bfloat16()
    w2 = torch.from_numpy((rng.standard_normal((dh, d)) * dh ** -0.5).astype(np.float32)).bfloat16()
    hidden = kernels.bf16_product(_ln_rows(y, g, b, 1e-6), w1, b1, "gelu")
    chain = kernels.bf16_product(hidden, w2, b2, "residual", res, gamma)
    assert torch.equal(chain, kernels.cn_mlp_block_plain(y, res, g, b, w1, b1, w2, b2, gamma, 1e-6))


def test_product_refuses_what_it_does_not_take(rng):
    inp = _inputs(rng, 8, 32, 16)
    a, w, bias = torch.from_numpy(inp["a"]).bfloat16(), torch.from_numpy(inp["w"]).bfloat16(), torch.from_numpy(inp["bias"])
    resid = torch.from_numpy(inp["resid"]).bfloat16()
    with pytest.raises(TypeError):  # float32 operands: the f32 blocks keep their scalar kernels
        kernels.bf16_product(a.float(), w.float(), bias)
    with pytest.raises(ValueError):  # inner sizes differ
        kernels.bf16_product(a, w[:16], bias)
    with pytest.raises(ValueError):
        kernels.bf16_product(a, w, bias, "relu")
    with pytest.raises(ValueError):  # the residual epilogue needs resid, and only it takes one
        kernels.bf16_product(a, w, bias, "residual")
    with pytest.raises(ValueError):
        kernels.bf16_product(a, w, bias, "gelu", resid)
    with pytest.raises(ValueError):  # a float32 output with the bias epilogue only
        kernels.bf16_product(a, w, bias, "gelu", out_dtype=torch.float32)
    with pytest.raises(ValueError):  # resid of another shape
        kernels.bf16_product(a, w, bias, "residual", resid[:4])
