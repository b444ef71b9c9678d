"""Gradients of the port's kernel wrappers (``flash_mha``, ``attention_block``,
``mlp_block``, ``cn_mlp_block``, ``window_attention_block``,
``depthwise_conv2d``, ``fused_conv3x3_relu_pool``) against ``jax.grad`` of the
JAX package's functions on the same numpy inputs and the same random
cotangent, and the plain versions of the bfloat16 blocks' backward kernels
(``ln_backward_plain``, ``mlp_gelu_backward_plain``,
``attention_core_backward_plain`` and the blocks' ``*_backward_plain``)
against autograd of the twins and against ``jax.grad``.

The JAX functions run their Pallas kernels in interpret mode forward and
their ``custom_vjp`` backward; the JAX conv stage has no backward of its own,
so its XLA route (``backend="xla"``) is differentiated.  On CPU tensors the
port's wrappers run their twins forward; the backward either differentiates
the twins (``ops.kernels._grad.recompute_backward``) or, for the bfloat16
blocks the card's backward takes, runs the plain versions of its kernels
(``_grad.explicit_backward``), as the card runs the kernels.
Tolerances: float32 ``1e-4·(1 + |ref|)`` (sums in other orders);
bfloat16 ``2e-2·(1 + |ref|)`` (one bfloat16 step is 2^-8 of the value).  The
plain versions against autograd of the twins: float32 ``1e-5·(1 + |ref|)``;
bfloat16 by the card test's rules (``tests/test_torch_cuda.py::
test_kernel_routes_give_the_plain_routes_gradients``): ``1e-2·(1 + |ref|)``,
and no further from the float32 function's gradient than 1.5 times the twin's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.models.swin import _shift_mask
from cpu_vision_tpu.ops.pallas import conv_block as jcb
from cpu_vision_tpu.ops.pallas import depthwise as jdw
from cpu_vision_tpu.ops.pallas import flash_attention as jfa
from cpu_vision_tpu.ops.pallas import swin_attention as jsa
from cpu_vision_tpu.ops.pallas import transformer_block as jtb
from cpu_vision_tpu_torch import _dtype
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import _grad
from cpu_vision_tpu_torch.ops.kernels import flash_attention as tfa
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


@pytest.mark.parametrize("s,hd,dtype", [(17, 16, "float32"), (17, 16, "bfloat16"), (50, 64, "float32"),
                                        (17, 64, "bfloat16"), (70, 64, "bfloat16")])  # the last two: Kernel B's route
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
                                                (1, 50, 128, 2, "float32"),
                                                (2, 17, 128, 2, "bfloat16"), (1, 70, 64, 1, "bfloat16")])  # head dim 64
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


# ------------------------------------------------ rows 12-14: cn_mlp_block, window attention, depthwise


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_cn_mlp_block_grads_match_jax(rng, wdtype):
    y, ln_g, ln_b, w1, b1, w2, b2 = _mlp_inputs(rng, 24, 128, 256)
    inputs = (y, _normal(rng, (24, 128)), ln_g, ln_b, w1, b1, w2, b2, _normal(rng, 128, 0.5))
    dtypes = [wdtype, wdtype, "float32", "float32", wdtype, "float32", wdtype, "float32", "float32"]
    g = _normal(rng, (24, 128))
    refs = _jax_grads(lambda *a: jtb.cn_mlp_block(*a, 1e-6, 8, True), inputs, dtypes, g)
    out, grads = _port_grads(lambda *a: kernels.cn_mlp_block(*a, 1e-6), inputs, dtypes, g)
    assert out.grad_fn is not None
    _assert_grads(grads, refs, dtypes, TOL[wdtype])


def _window_inputs(rng, nw, s, c, heads, v2, masked, nw_img):
    ws = int(round(s ** 0.5))
    side = int(round(nw_img ** 0.5)) * ws
    diff = [_normal(rng, (nw, s, c)), rng.uniform(0.5, 1.5, c).astype(np.float32), _normal(rng, c, 0.1),
            _normal(rng, (c, 3 * c), 0.05), _normal(rng, 3 * c, 0.02), _normal(rng, (c, c), 0.05), _normal(rng, c, 0.02),
            _normal(rng, (heads, s, s), 0.3)]
    if v2:
        diff.append(rng.uniform(0.5, 2.0, heads).astype(np.float32))
    mask = np.asarray(_shift_mask(side, side, ws, ws // 2, ws // 2)) if masked else None
    return diff, mask


@pytest.mark.parametrize("v2,masked", [(False, True), (True, False)], ids=["v1_masked", "v2"])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_window_attention_block_grads_match_jax(rng, v2, masked, wdtype):
    """Row 13: the gradients of every input but the mask (a constant of the JAX ``_bwd``; the port's wrapper
    detaches it), v1 with the shift mask, v2 with its logit scale."""
    nw, s, c, heads, nw_img = 8, 16, 64, 2, 4
    inputs, mask = _window_inputs(rng, nw, s, c, heads, v2, masked, nw_img)
    dtypes = [wdtype, "float32", "float32", wdtype, "float32", wdtype] + ["float32"] * (len(inputs) - 6)
    g = _normal(rng, (nw, s, c))
    scale = (c // heads) ** -0.5

    def jfn(*a):
        ls = a[8] if v2 else None
        return jsa.window_attention_block(*a[:8], None if mask is None else jnp.asarray(mask), ls, heads, scale, 1e-5,
                                          v2, nw_img, True)

    t_mask = None if mask is None else torch.from_numpy(mask.copy()).requires_grad_()

    def tfn(*a):
        ls = a[8] if v2 else None
        return kernels.window_attention_block(*a[:8], t_mask, ls, heads, scale, 1e-5, v2, nw_img)

    refs = _jax_grads(jfn, inputs, dtypes, g)
    out, grads = _port_grads(tfn, inputs, dtypes, g)
    assert out.grad_fn is not None
    _assert_grads(grads, refs, dtypes, TOL[wdtype])
    assert t_mask is None or t_mask.grad is None  # the mask gets no gradient


@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_depthwise_conv2d_grads_match_jax(rng, k, use_bias):
    """Row 14, float32: the input's, the taps' and (with a bias) the bias's gradients against ``jax.grad`` through the
    JAX ``custom_vjp``; bfloat16 at 7 taps below."""
    x, taps, bias = _normal(rng, (2, 9, 14, 24)), _normal(rng, (k, k, 24), 1.0 / k), _normal(rng, 24)
    g = _normal(rng, (2, 9, 14, 24))
    inputs = (x, taps, bias) if use_bias else (x, taps)
    refs = _jax_grads(lambda *a: jdw.depthwise_conv2d(*a[:2], a[2] if use_bias else jnp.zeros(24), use_bias, True),
                      inputs, ["float32"] * len(inputs), g)
    _, grads = _port_grads(lambda *a: kernels.depthwise_conv2d(*a[:2], a[2] if use_bias else None, use_bias), inputs,
                           ["float32"] * len(inputs), g)
    _assert_grads(grads, refs, ["float32"] * len(inputs), TOL["float32"])


def test_depthwise_conv2d_grads_match_jax_bfloat16(rng):
    x, taps, bias = _normal(rng, (2, 9, 14, 24)), _normal(rng, (7, 7, 24), 1.0 / 7), _normal(rng, 24)
    g = _normal(rng, (2, 9, 14, 24))
    dtypes = ["bfloat16", "bfloat16", "float32"]
    refs = _jax_grads(lambda *a: jdw.depthwise_conv2d(*a, True, True), (x, taps, bias), dtypes, g)
    _, grads = _port_grads(kernels.depthwise_conv2d, (x, taps, bias), dtypes, g)
    _assert_grads(grads, refs, dtypes, TOL["bfloat16"])


# ---------------------------------------- the plain versions of the bf16 blocks' backward kernels


def _twin_grads(fn, args, cotangent):
    args = [a.detach().requires_grad_(a.dtype.is_floating_point) for a in args]
    fn(*args).backward(cotangent)
    return [a.grad for a in args]


def _assert_plain_rules(got, fn, args, cotangent, dtype):
    """``got`` against autograd of the twin ``fn`` (their products alike: float32 on the CPU): float32 within
    1e-5·(1 + |ref|); bfloat16 within 1e-2·(1 + |ref|) and no further from the float32 function's gradient than 1.5
    times the twin's."""
    ref = _twin_grads(fn, args, cotangent)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        err = (g.float() - r.float()).abs()
        assert bool((err <= tol * (1 + r.float().abs())).all()), float(err.max())
    if dtype == torch.bfloat16:
        truth = _twin_grads(fn, [a.float() for a in args], cotangent.float())
        for g, r, t in zip(got, ref, truth):
            t = t.double()
            assert float((g.double() - t).norm()) <= 1.5 * float((r.double() - t).norm()) + 1e-6 * float(t.norm())


def _tensors(arrays, dtypes):
    return [torch.from_numpy(a).to(TDT[d]) for a, d in zip(arrays, dtypes)]


@pytest.mark.parametrize("m,d,resid", [(7, 64, True), (33, 96, False), (2, 128, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_backward_plain_matches_autograd_and_jax(rng, m, d, resid, dtype):
    x, ln_g, ln_b, dh, r = (_normal(rng, (m, d)), _normal(rng, d, 0.2, 1.0), _normal(rng, d, 0.1),
                            _normal(rng, (m, d)), _normal(rng, (m, d)))
    tx, tg, tdh, tr = _tensors((x, ln_g, dh, r), [dtype, "float32", dtype, dtype])
    got = kernels.ln_backward_plain(tx, tg, tdh, tr if resid else None, 1e-6)
    assert got[0].dtype == TDT[dtype] and got[1].dtype == got[2].dtype == torch.float32

    ref = _twin_grads(lambda xx, gg, bb: ttb._ln_f32(xx.float(), gg, bb, 1e-6), [tx, tg, torch.from_numpy(ln_b)],
                      tdh.float())
    tol = 1e-5 if dtype == "float32" else 1e-2
    want_dx = ref[0].float() + (tr.float() if resid else 0)
    for g, w in ((got[0].float(), want_dx.to(TDT[dtype]).float()), (got[1], ref[1]), (got[2], ref[2])):
        assert bool(((g - w).abs() <= tol * (1 + w.abs())).all()), float((g - w).abs().max())
    # against jax.grad of the JAX package's LayerNorm
    jref = jax.grad(lambda a, b, c: jnp.sum(jtb._ln_f32(a, b, c, 1e-6) * jnp.asarray(tdh.float().numpy())),
                    argnums=(0, 1, 2))(jnp.asarray(tx.float().numpy()), jnp.asarray(ln_g), jnp.asarray(ln_b))
    jdx = np.asarray(jref[0]) + (tr.float().numpy() if resid else 0)
    for g, w in ((got[0].float().numpy(), jdx), (got[1].numpy(), np.asarray(jref[1])), (got[2].numpy(), np.asarray(jref[2]))):
        assert np.all(np.abs(g - w) <= TOL[dtype] * (1 + np.abs(w))), float(np.abs(g - w).max())


@pytest.mark.parametrize("m,dh", [(5, 64), (37, 192)])
def test_mlp_gelu_backward_plain_matches_autograd_and_jax(rng, m, dh):
    """Kernel A's plain version in float32: du (the first half of du2; the second is 0), a and db1 against autograd of
    the twin's gelu and against ``jax.grad`` of the JAX package's; in bfloat16 du = hi + lo is ``da·gelu'(u)`` rounded
    to TF32, a the twin's bits."""
    da32, hw, b1 = (torch.from_numpy(_normal(rng, (m, dh))), torch.from_numpy(_normal(rng, (m, dh), 2.0)),
                    torch.from_numpy(_normal(rng, dh, 0.3)))
    du2, a, db1 = kernels.mlp_gelu_backward_plain(da32, hw, b1, torch.float32)
    u = (hw + b1).requires_grad_()
    ttb._gelu_f32(u).backward(da32)
    assert torch.equal(du2[:, dh:], torch.zeros(m, dh))
    for g, w in ((du2[:, :dh], u.grad), (a, ttb._gelu_f32(u.detach())), (db1, u.grad.sum(0))):
        assert bool(((g - w).abs() <= 1e-5 * (1 + w.abs())).all()), float((g - w).abs().max())
    jdu = jax.grad(lambda v: jnp.sum(jtb._gelu_f32(v) * jnp.asarray(da32.numpy())))(jnp.asarray(u.detach().numpy()))
    np.testing.assert_allclose(du2[:, :dh].numpy(), np.asarray(jdu), rtol=TOL["float32"], atol=TOL["float32"])
    du2, a, db1 = kernels.mlp_gelu_backward_plain(da32, hw, b1)
    assert du2.dtype == a.dtype == torch.bfloat16 and db1.dtype == torch.float32
    t = (du2[:, :dh].float() + du2[:, dh:].float())
    assert torch.equal(t, ttb._tf32_rna(t)) and torch.equal(du2[:, :dh], t.to(torch.bfloat16))
    want = da32.to(torch.bfloat16).float() * ttb._gelu_grad_f32(u.detach())
    assert bool(((t - want).abs() <= 2 ** -11 * want.abs()).all())
    assert torch.equal(a, ttb._gelu_f32(u.detach()).to(torch.bfloat16))


@pytest.mark.parametrize("n,s,heads", [(2, 7, 1), (1, 33, 2), (1, 70, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_core_backward_plain_matches_twin_and_jax(rng, n, s, heads, dtype):
    q, k, v = (_normal(rng, (n, s, heads, 64)) for _ in range(3))
    do = _normal(rng, (n, heads, s, 64))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    got = kernels.attention_core_backward_plain(tq, tk, tv, tdo, 0.125)
    _assert_plain_rules(got, lambda *a: tfa.flash_mha_plain(*a, 0.125), [tq, tk, tv], tdo, dtype)
    dt = "float32" if dtype == torch.float32 else "bfloat16"
    refs = _jax_grads(lambda *a: jfa.flash_mha(*a, 0.125, True), (q, k, v), [dt] * 3, tdo.float().numpy())
    _assert_grads(got, refs, [dt] * 3, TOL[dt])


@pytest.mark.parametrize("m,d,dh,cn", [(7, 64, 128, False), (33, 96, 192, False), (19, 128, 256, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_block_backward_plain_matches_twin_and_jax(rng, m, d, dh, cn, dtype):
    arrays = list(_mlp_inputs(rng, m, d, dh))
    dts = [dtype, torch.float32, torch.float32, dtype, torch.float32, dtype, torch.float32]
    args = [torch.from_numpy(a).to(t) for a, t in zip(arrays, dts)]
    g = torch.from_numpy(_normal(rng, (m, d))).to(dtype)
    if cn:
        ls = torch.from_numpy(_normal(rng, d, 0.5))
        res = torch.from_numpy(_normal(rng, (m, d))).to(dtype)
        got = kernels.mlp_block_backward_plain(*args, g, 1e-6, layer_scale=ls)
        twin_args = [args[0], res, *args[1:], ls]
        twin = _twin_grads(lambda *a: ttb.cn_mlp_block_plain(*a, 1e-6), twin_args, g)
        assert torch.equal(twin[1], g)  # the residual's gradient is g itself
        _assert_plain_rules(list(got), lambda y, *a: ttb.cn_mlp_block_plain(y, res, *a, 1e-6), [args[0], *args[1:], ls],
                            g, dtype)
        jdts = ["float32" if t == torch.float32 else "bfloat16" for t in [dtype, dtype, *dts[1:], torch.float32]]
        jarrays = [arrays[0], res.float().numpy(), *arrays[1:], ls.numpy()]
        refs = _jax_grads(lambda *a: jtb.cn_mlp_block(*a, 1e-6, 8, True), jarrays, jdts, g.float().numpy())
        refs = [refs[0], *refs[2:]]
        jdts = [jdts[0], *jdts[2:]]
    else:
        got = kernels.mlp_block_backward_plain(*args, g, 1e-6)
        _assert_plain_rules(list(got), lambda *a: ttb.mlp_block_plain(*a, 1e-6), args, g, dtype)
        jdts = ["float32" if t == torch.float32 else "bfloat16" for t in dts]
        refs = _jax_grads(lambda *a: jtb.mlp_block(*a, 1e-6, 8, True), arrays, jdts, g.float().numpy())
    _assert_grads(got, refs, jdts, TOL["float32" if dtype == torch.float32 else "bfloat16"])


@pytest.mark.parametrize("n,s,d,heads", [(2, 7, 64, 1), (1, 33, 128, 2), (1, 70, 64, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_block_backward_plain_matches_twin_and_jax(rng, n, s, d, heads, dtype):
    arrays = [_normal(rng, (n, s, d)), _normal(rng, d, 0.2, 1.0), _normal(rng, d, 0.1),
              _normal(rng, (d, 3 * d), d ** -0.5), _normal(rng, 3 * d, 0.1), _normal(rng, (d, d), d ** -0.5),
              _normal(rng, d, 0.1)]
    dts = [dtype, torch.float32, torch.float32, dtype, torch.float32, dtype, torch.float32]
    args = [torch.from_numpy(a).to(t) for a, t in zip(arrays, dts)]
    g = torch.from_numpy(_normal(rng, (n, s, d))).to(dtype)
    got = kernels.attention_block_backward_plain(*args, g, heads, 0.125)
    _assert_plain_rules(list(got), lambda *a: ttb.attention_block_plain(*a, heads, 0.125), args, g, dtype)
    jdts = ["float32" if t == torch.float32 else "bfloat16" for t in dts]
    refs = _jax_grads(lambda *a: jtb.attention_block(*a, heads, 0.125, 1e-6, True), arrays, jdts, g.float().numpy())
    _assert_grads(got, refs, jdts, TOL["float32" if dtype == torch.float32 else "bfloat16"])


def test_backward_route_is_chosen_by_the_arguments(rng):
    """bfloat16 blocks take the card's backward (``explicit_backward``, attention at any S), float32, post_norm,
    ln_count, head dims other than 64 and the window and conv kernels the recomputed twin; depthwise its own
    backward."""
    def kind(out):
        return type(out.grad_fn).__name__

    x, ln_g, ln_b, w1, b1, w2, b2 = (torch.from_numpy(a).requires_grad_() for a in _mlp_inputs(rng, 8, 128, 256))
    bf = [t.detach().to(torch.bfloat16).requires_grad_() for t in (x, w1, w2)]
    assert kind(kernels.mlp_block(bf[0], ln_g, ln_b, bf[1], b1, bf[2], b2)) == "_ExplicitBackwardBackward"
    assert kind(kernels.mlp_block(x, ln_g, ln_b, w1, b1, w2, b2)) == "_RecomputeBackwardBackward"
    assert kind(kernels.mlp_block(bf[0], ln_g, ln_b, bf[1], b1, bf[2], b2, post_norm=True)) == "_RecomputeBackwardBackward"
    assert kind(kernels.mlp_block(bf[0], ln_g, ln_b, bf[1], b1, bf[2], b2, ln_count=96)) == "_RecomputeBackwardBackward"
    assert kind(kernels.cn_mlp_block(bf[0], bf[0], ln_g, ln_b, bf[1], b1, bf[2], b2, b2)) == "_ExplicitBackwardBackward"
    q = torch.zeros((1, 5, 2, 64), dtype=torch.bfloat16, requires_grad=True)
    assert kind(kernels.flash_mha(q, q, q, 0.125)) == "_ExplicitBackwardBackward"
    assert kind(kernels.flash_mha(q.float(), q.float(), q.float(), 0.125)) == "_RecomputeBackwardBackward"
    q16 = torch.zeros((1, 5, 2, 16), dtype=torch.bfloat16, requires_grad=True)
    assert kind(kernels.flash_mha(q16, q16, q16, 0.25)) == "_RecomputeBackwardBackward"
    for s in (257, 577):  # past the first Kernel B's cap of 256: the streamed Kernel B takes any S
        long = torch.zeros((1, s, 1, 64), dtype=torch.bfloat16, requires_grad=True)
        assert kind(kernels.flash_mha(long, long, long, 0.125)) == "_ExplicitBackwardBackward"
    dw = kernels.depthwise_conv2d(torch.zeros((1, 5, 5, 4), requires_grad=True), torch.zeros((3, 3, 4)), None)
    assert kind(dw) == "_ExplicitBackwardBackward"
    # only the inputs are saved, not the recomputed activations
    out = kernels.mlp_block(bf[0], ln_g, ln_b, bf[1], b1, bf[2], b2)
    assert [t.shape for t in out.grad_fn.saved_tensors] == [t.shape for t in (x, ln_g, ln_b, w1, b1, w2, b2)]
