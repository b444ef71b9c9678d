"""Gradients of the port's kernel wrappers (``flash_mha``, ``attention_block``,
``mlp_block``, ``fused_conv3x3_relu_pool``) against ``jax.grad`` of the JAX
package's functions on the same numpy inputs and the same random cotangent.

The JAX functions run their Pallas kernels in interpret mode forward and
their ``custom_vjp`` backward; the JAX conv stage has no backward of its own,
so its XLA route (``backend="xla"``) is differentiated.  On CPU tensors the
port's wrappers run their twins forward and differentiate the twins in the
backward (``ops.kernels._grad``), as they do on the card after the kernel.
Tolerances: float32 ``1e-4·(1 + |ref|)`` (sums in other orders);
bfloat16 ``2e-2·(1 + |ref|)`` (one bfloat16 step is 2^-8 of the value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops.pallas import conv_block as jcb
from cpu_vision_tpu.ops.pallas import flash_attention as jfa
from cpu_vision_tpu.ops.pallas import transformer_block as jtb
from cpu_vision_tpu_torch import _dtype
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import _grad
from cpu_vision_tpu_torch.ops.kernels import transformer_block as ttb

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _normal(rng, shape, std=1.0, mean=0.0):
    return (mean + std * rng.standard_normal(shape)).astype(np.float32)


def _jax_grads(fn, inputs, dtypes, cotangent):
    args = [jnp.asarray(v, JDT[dt]) for v, dt in zip(inputs, dtypes)]

    def loss(*a):
        return jnp.sum(fn(*a).astype(jnp.float32) * jnp.asarray(cotangent))

    return jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(*args)


def _port_grads(fn, inputs, dtypes, cotangent):
    args = [torch.from_numpy(v).to(TDT[dt]).requires_grad_() for v, dt in zip(inputs, dtypes)]
    out = fn(*args)
    out.backward(torch.from_numpy(cotangent).to(out.dtype))
    return out, [a.grad for a in args]


def _assert_grads(grads, refs, dtypes, tol):
    for g, r, dt in zip(grads, refs, dtypes):
        assert g.dtype == TDT[dt]  # each gradient in its input's dtype
        r = np.asarray(r.astype(jnp.float32))
        diff = np.abs(g.float().numpy() - r)
        assert g.shape == r.shape and np.all(diff <= tol * (1 + np.abs(r))), float(diff.max())


@pytest.mark.parametrize("s,hd,dtype", [(17, 16, "float32"), (17, 16, "bfloat16"), (50, 64, "float32")])
def test_flash_mha_grads_match_jax(rng, s, hd, dtype):
    q, k, v = (_normal(rng, (2, s, 3, hd)) for _ in range(3))
    g = _normal(rng, (2, 3, s, hd))
    scale = hd ** -0.5
    refs = _jax_grads(lambda *a: jfa.flash_mha(*a, scale, True), (q, k, v), [dtype] * 3, g)
    out, grads = _port_grads(lambda *a: kernels.flash_mha(*a, scale), (q, k, v), [dtype] * 3, g)
    assert out.grad_fn is not None
    _assert_grads(grads, refs, [dtype] * 3, TOL[dtype])


def _mlp_inputs(rng, m, d, dh):
    return (_normal(rng, (m, d)), _normal(rng, d, 0.2, 1.0), _normal(rng, d, 0.1), _normal(rng, (d, dh), d ** -0.5),
            _normal(rng, dh, 0.1), _normal(rng, (dh, d), dh ** -0.5), _normal(rng, d, 0.1))


@pytest.mark.parametrize("post_norm,ln_count,wdtype", [(False, 0, "float32"), (False, 0, "bfloat16"),
                                                      (True, 0, "float32"), (False, 96, "float32")])
def test_mlp_block_grads_match_jax(rng, post_norm, ln_count, wdtype):
    inputs = _mlp_inputs(rng, 24, 128, 256)
    dtypes = [wdtype, "float32", "float32", wdtype, "float32", wdtype, "float32"]
    g = _normal(rng, (24, 128))
    refs = _jax_grads(lambda *a: jtb.mlp_block(*a, 1e-6, 8, True, post_norm, ln_count), inputs, dtypes, g)
    _, grads = _port_grads(lambda *a: kernels.mlp_block(*a, 1e-6, post_norm, ln_count), inputs, dtypes, g)
    _assert_grads(grads, refs, dtypes, TOL[wdtype])


@pytest.mark.parametrize("n,s,d,heads,wdtype", [(2, 17, 64, 4, "float32"), (2, 17, 64, 4, "bfloat16"),
                                                (1, 50, 128, 2, "float32")])
def test_attention_block_grads_match_jax(rng, n, s, d, heads, wdtype):
    inputs = (_normal(rng, (n, s, d)), _normal(rng, d, 0.2, 1.0), _normal(rng, d, 0.1), _normal(rng, (d, 3 * d), d ** -0.5),
              _normal(rng, 3 * d, 0.1), _normal(rng, (d, d), d ** -0.5), _normal(rng, d, 0.1))
    dtypes = [wdtype, "float32", "float32", wdtype, "float32", wdtype, "float32"]
    g = _normal(rng, (n, s, d))
    scale = (d // heads) ** -0.5
    refs = _jax_grads(lambda *a: jtb.attention_block(*a, heads, scale, 1e-6, True), inputs, dtypes, g)
    _, grads = _port_grads(lambda *a: kernels.attention_block(*a, heads, scale, 1e-6), inputs, dtypes, g)
    _assert_grads(grads, refs, dtypes, TOL[wdtype])


@pytest.mark.parametrize("shape,cout", [((2, 8, 10, 3), 8), ((1, 6, 6, 16), 4)])
def test_conv_stage_grads_match_jax(rng, shape, cout):
    inputs = (_normal(rng, shape), _normal(rng, (3, 3, shape[3], cout), (9 * shape[3]) ** -0.5), _normal(rng, cout, 0.1))
    g = _normal(rng, (shape[0], shape[1] // 2, shape[2] // 2, cout))
    refs = _jax_grads(lambda *a: jcb.conv3x3_relu_pool(*a, backend="xla"), inputs, ["float32"] * 3, g)
    _, grads = _port_grads(kernels.fused_conv3x3_relu_pool, inputs, ["float32"] * 3, g)
    _assert_grads(grads, refs, ["float32"] * 3, TOL["float32"])


def test_serving_keeps_no_graph(rng):
    x, ln_g, ln_b, w1, b1, w2, b2 = (torch.from_numpy(a).requires_grad_() for a in _mlp_inputs(rng, 8, 128, 256))
    with torch.no_grad():
        assert kernels.mlp_block(x, ln_g, ln_b, w1, b1, w2, b2).grad_fn is None
    frozen = [t.detach() for t in (x, ln_g, ln_b, w1, b1, w2, b2)]
    assert kernels.mlp_block(*frozen).grad_fn is None  # no input asks for a gradient: nothing is saved
    out = kernels.mlp_block(x, ln_g, ln_b, w1, b1, w2, b2)
    assert type(out.grad_fn).__name__ == "_RecomputeBackwardBackward"
    # only the inputs are saved, not the (tokens, Dh) activations
    assert [t.shape for t in out.grad_fn.saved_tensors] == [t.shape for t in (x, ln_g, ln_b, w1, b1, w2, b2)]
    # a gradient asked of one input only
    out = kernels.mlp_block(x.detach(), ln_g.detach(), ln_b.detach(), w1, b1.detach(), w2.detach(), b2.detach())
    (gw1,) = torch.autograd.grad(out.sum(), [w1])
    ref = torch.autograd.grad(ttb.mlp_block_plain(x.detach(), ln_g, ln_b, w1, b1, w2, b2).sum(), [w1])[0]
    assert torch.equal(gw1, ref)


def test_twin_gelu_derivative_matches_exact_gelu():
    # the twins' erf is a polynomial (|err| < 1.5e-7) written to match the kernels' forward; its derivative
    # stays within 1e-6 of the exact gelu's, which the JAX package's plain routes differentiate
    h = torch.linspace(-8, 8, 40001, dtype=torch.float32, requires_grad=True)
    ttb._gelu_f32(h).sum().backward()
    ref = jax.vmap(jax.grad(lambda v: jax.nn.gelu(v, approximate=False)))(jnp.asarray(h.detach().numpy()))
    assert np.abs(h.grad.numpy() - np.asarray(ref)).max() <= 1e-6


@pytest.mark.parametrize("dtype,tf32", [(torch.float32, False), (torch.bfloat16, True)])
def test_backward_products_take_the_compute_dtype(dtype, tf32):
    """The recomputed backward runs its products in full float32 for a float32 twin and lets TF32 multiply a
    bfloat16 twin's values (exact), inside a caller's full-float32 block as the train step has it; the caller's
    switch is restored after."""
    seen = []

    def twin(x):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return x * 2.0

    x = torch.ones(3, requires_grad=True)
    with _dtype.full_float32():
        out = _grad.recompute_backward(twin, twin, x, dtype=dtype)
        out.sum().backward()
        assert not torch.backends.cuda.matmul.allow_tf32
    assert seen == [False, tf32] and torch.equal(x.grad, torch.full((3,), 2.0))


def test_float32_products_restores_the_switch():
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for start in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = start
            with _dtype.float32_products(torch.bfloat16):
                assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cuda.matmul.allow_tf32 == start
            with pytest.raises(KeyError), _dtype.float32_products(torch.float32):
                assert not torch.backends.cuda.matmul.allow_tf32
                raise KeyError("restored after an error too")
            assert torch.backends.cuda.matmul.allow_tf32 == start
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
