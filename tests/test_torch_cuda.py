"""The port's CUDA kernels on the card, held against their plain PyTorch
twins and the op-by-op paths on the same inputs.

Every test here needs an NVIDIA card and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Class maps and blur, blur+Sobel and Harris maps must be equal to the twins'
bit for bit: kernel and twin run the same float32 operations in the same
order, without FMA contraction.  The fused convolution sums over input
channels in another order than its twin's matrix products, and with fused
multiply-adds: it is held to ``1e-5 + 1e-5·|twin|``.  The transformer
kernels (``flash_mha``, ``attention_block``, ``mlp_block``, ``cn_mlp_block``,
``window_attention_block``) sum their products in other orders than the twins'
matrix products, with fused multiply-adds: float32 is held to
``2e-4 + 2e-4·|twin|``, bfloat16 (compared in bfloat16, where one step is 2^-8
of the value) to ``2e-2 + 2e-2·|twin|``.  The depthwise convolution sums its
taps in the twin's order, with fused multiply-adds: ``1e-5 + 1e-5·|twin|`` in
float32, ``2e-2·(1 + |twin|)`` in bfloat16.
"""

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch import graft_entry, models, ops
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import conv_block, depthwise, flash_attention, stencil, swin_attention, transformer_block

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.reset_launch_counts()
    yield torch.device("cuda")
    kernels.reset_launch_counts()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _class_map(rng, shape, device):
    maps = torch.from_numpy(rng.random(shape, dtype=np.float32))
    return stencil.canny_stage1_plain(maps, stencil.gaussian_taps(5, 1.4), 0.05, 0.2).to(device)


@pytest.mark.parametrize("shape", [(1, 6, 9), (2, 67, 131), (1, 256, 300)])
def test_kernels_match_twins(cuda, rng, shape):
    maps = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    cls = kernels.canny_stage1(maps, 0.08, 0.15)
    assert torch.equal(cls, stencil.canny_stage1_plain(maps, stencil.gaussian_taps(5, 1.4), 0.08, 0.15))
    for sweeps in (1, 4, 16):
        assert torch.equal(kernels.hysteresis_sweeps(cls, sweeps), stencil.hysteresis_sweeps_plain(cls, sweeps))
    assert torch.equal(kernels.fused_blur_sobel(maps[..., None])[..., 0],
                       stencil.fused_blur_sobel_plain(maps, stencil.gaussian_taps(5, 1.5)))
    assert torch.equal(kernels.harris_response_fused(maps[..., None])[..., 0],
                       stencil.harris_response_fused_plain(maps, stencil.gaussian_taps(5, 1.0), 0.04))
    assert torch.equal(kernels.fused_gaussian_blur(maps[..., None])[..., 0],
                       stencil.fused_gaussian_blur_plain(maps, stencil.gaussian_taps(5, 1.5)))
    assert kernels.launch_counts() == {
        "canny_stage1": 1, "canny_stage1_in_tile": 0, "hysteresis_sweeps": 3, "fused_blur_sobel": 1,
        "harris_response_fused": 1, "fused_gaussian_blur": 1, "fused_conv3x3_relu_pool": 0,
        "flash_mha": 0, "attention_block": 0, "mlp_block": 0, "cn_mlp_block": 0, "window_attention_block": 0,
        "depthwise_conv2d": 0}


@pytest.mark.parametrize("ks,sigma", [(3, 0.8), (7, 2.0), (9, 3.0)])
def test_kernels_match_twins_other_taps(cuda, rng, ks, sigma):
    maps = torch.from_numpy(rng.random((2, 45, 70), dtype=np.float32)).to(cuda)
    taps = stencil.gaussian_taps(ks, sigma)
    assert torch.equal(kernels.canny_stage1(maps, 0.1, 0.2, ks, sigma),
                       stencil.canny_stage1_plain(maps, taps, 0.1, 0.2))
    assert torch.equal(kernels.fused_blur_sobel(maps[..., None], ks, sigma)[..., 0],
                       stencil.fused_blur_sobel_plain(maps, taps))
    assert torch.equal(kernels.harris_response_fused(maps[..., None], 0.05, ks, sigma)[..., 0],
                       stencil.harris_response_fused_plain(maps, taps, 0.05))
    assert torch.equal(kernels.fused_gaussian_blur(maps[..., None], ks, sigma)[..., 0],
                       stencil.fused_gaussian_blur_plain(maps, taps))


@pytest.mark.parametrize("shape", [(2, 40, 56, 3), (33, 70), (5, 7, 2)])
def test_gaussian_blur_matches_op_by_op(cuda, rng, shape):
    # other taps (last bit) and the op-by-op order of sums: atol 1e-5, as the
    # JAX package holds its Pallas kernel to ops.gaussian_blur
    img = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    out = kernels.fused_gaussian_blur(img, 5, 1.5)
    assert out.shape == img.shape and kernels.launch_counts()["fused_gaussian_blur"] == 1
    assert torch.allclose(out, ops.gaussian_blur(img, 5, 1.5), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,low,high", [((1, 6, 9), 0.1, 0.2), ((2, 67, 131), 0.05, 0.2),
                                            ((1, 256, 300), 0.02, 0.3), ((1, 96, 120), 0.3, 0.6)])
def test_in_tile_hysteresis_matches_twin_and_fixpoint(cuda, rng, shape, low, high):
    maps = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    taps = stencil.gaussian_taps(5, 1.4)
    cls = kernels.canny_stage1(maps, low, high, in_tile_hysteresis=True)
    assert kernels.launch_counts()["canny_stage1_in_tile"] == 1 and kernels.launch_counts()["canny_stage1"] == 0
    assert torch.equal(cls, stencil.canny_stage1_plain(maps, taps, low, high, in_tile=stencil.IN_TILE))
    # the class map depends on the tiling; the global fixpoint does not
    base = kernels.canny_stage1(maps, low, high)
    assert torch.equal(kernels.hysteresis_fixpoint(cls), kernels.hysteresis_fixpoint(base))
    assert bool(((cls == 2) >= (base == 2)).all()) and torch.equal(cls >= 1, base >= 1)


CONV_SHAPES = [((2, 28, 28, 3), 16), ((1, 64, 48, 8), 32), ((3, 30, 30, 1), 4), ((2, 14, 14, 32), 64),
               ((1, 2, 2, 1), 1), ((1, 18, 34, 5), 33), ((2, 6, 50, 89), 7)]


@pytest.mark.parametrize("shape,cout", CONV_SHAPES)
def test_conv_block_matches_twin_and_stock(cuda, rng, shape, cout):
    x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    w = torch.from_numpy(rng.normal(0, 0.3, (3, 3, shape[-1], cout)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.normal(0, 0.1, (cout,)).astype(np.float32)).to(cuda)
    out = kernels.fused_conv3x3_relu_pool(x, w, b)
    assert kernels.launch_counts()["fused_conv3x3_relu_pool"] == 1
    assert out.shape == (shape[0], shape[1] // 2, shape[2] // 2, cout)
    for ref in (conv_block.fused_conv3x3_relu_pool_plain(x, w, b), kernels.conv3x3_relu_pool(x, w, b, "stock")):
        assert bool(((out - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()), float((out - ref).abs().max())
    assert torch.equal(out, kernels.conv3x3_relu_pool(x, w, b))  # None: the kernel on a CUDA tensor


def test_conv_block_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 4, 4, conv_block.MAX_CIN + 1, device=cuda)
    w = torch.zeros(3, 3, conv_block.MAX_CIN + 1, 2, device=cuda)
    with pytest.raises(ValueError):
        kernels.fused_conv3x3_relu_pool(x, w, torch.zeros(2, device=cuda))
    with pytest.raises(ValueError):
        kernels.fused_conv3x3_relu_pool(x[:, :3, :, :3], w[:, :, :3], torch.zeros(2, device=cuda))
    assert kernels.launch_counts()["fused_conv3x3_relu_pool"] == 0


def test_cnn_forward_runs_the_kernel(cuda, rng):
    gen = torch.Generator().manual_seed(0)
    params = ops.cnn_init(gen, (28, 28), 1, (8, 16), 32, 10)
    images = rng.random((4, 28, 28, 1), dtype=np.float32)
    logits = ops.cnn_forward(params, images)  # numpy in: runs on the card
    assert logits.device.type == "cuda" and logits.shape == (4, 10)
    assert kernels.launch_counts()["fused_conv3x3_relu_pool"] == 2
    x = torch.from_numpy(images).to(cuda)
    for backend in ("plain", "stock"):
        assert torch.allclose(logits, ops.cnn_forward(params, x, backend=backend), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("max_sweeps", [None, 0, 1, 5, 13])
def test_fixpoint_matches_op_by_op(cuda, rng, max_sweeps):
    cls = _class_map(rng, (2, 96, 160), cuda)
    out = kernels.hysteresis_fixpoint(cls, max_sweeps)
    assert torch.equal(out == 2, ops.hysteresis(cls == 2, cls >= 1, max_sweeps))


@pytest.mark.parametrize("shape", [(70, 90), (2, 70, 90, 1), (40, 50, 3)])
def test_canny_runs_kernels_and_matches_op_by_op(cuda, rng, shape):
    img = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    out = ops.canny(img, 0.1, 0.2)
    counts = kernels.launch_counts()
    assert counts["canny_stage1"] == 1 and counts["hysteresis_sweeps"] >= 1
    assert out.device.type == "cuda"
    assert tuple(out.shape) == (shape[:2] + (1,) if len(shape) == 3 else shape)  # RGB -> one channel
    assert torch.equal(out, ops.canny(img, 0.1, 0.2, backend="plain"))


def test_numpy_input_runs_on_the_card(cuda, rng):
    out = ops.canny(rng.random((40, 50), dtype=np.float32), 0.1, 0.2)
    assert out.device.type == "cuda"
    assert kernels.launch_counts()["canny_stage1"] == 1


def test_refused_launch_raises(cuda):
    x = torch.zeros(1, 8, 8, device=cuda)
    taps = stencil._c_taps(stencil.gaussian_taps(5, 1.5))
    with pytest.raises(RuntimeError):  # kernel size 0: the launcher refuses it
        stencil._launch("cvt_blur_sobel", x, x.data_ptr(), x.data_ptr(), 1, 8, 8, taps, 0)


# ------------------------------------------------------- transformer kernels

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


def _normal(rng, shape, dtype, device, std=1.0, mean=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32)).to(device=device, dtype=dtype)


def _close(out, ref, dtype):
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs()
    assert bool((err <= TOL[dtype] + TOL[dtype] * ref.float().abs()).all()), float(err.max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 197, 12, 64), (1, 257, 2, 80), (3, 17, 2, 16), (2, 64, 4, 64)])
def test_flash_mha_matches_twin(cuda, rng, shape, dtype):
    q, k, v = (_normal(rng, shape, dtype, cuda) for _ in range(3))
    scale = shape[-1] ** -0.5
    out = kernels.flash_mha(q, k, v, scale)
    assert kernels.launch_counts()["flash_mha"] == 1
    assert out.shape == (shape[0], shape[2], shape[1], shape[3])  # (N, H, S, hd)
    _close(out, kernels.flash_mha_plain(q, k, v, scale), dtype)


def _attention_args(rng, n, s, d, heads, dtype, device):
    return (_normal(rng, (n, s, d), dtype, device), _normal(rng, (d,), torch.float32, device, 0.2, 1.0),
            _normal(rng, (d,), torch.float32, device, 0.1), _normal(rng, (d, 3 * d), dtype, device, d ** -0.5),
            _normal(rng, (3 * d,), torch.float32, device, 0.1), _normal(rng, (d, d), dtype, device, d ** -0.5),
            _normal(rng, (d,), torch.float32, device, 0.1), heads, (d // heads) ** -0.5, 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,s,d,heads", [(2, 197, 768, 12), (3, 50, 128, 2), (1, 17, 64, 4), (1, 130, 1280, 16)])
def test_attention_block_matches_twin(cuda, rng, n, s, d, heads, dtype):
    args = _attention_args(rng, n, s, d, heads, dtype, cuda)
    out = kernels.attention_block(*args)
    assert kernels.launch_counts()["attention_block"] == 1 and kernels.attention_block.kernel_launches == 3
    _close(out, kernels.attention_block_plain(*args), dtype)


def _mlp_args(rng, m, d, dh, dtype, device):
    return (_normal(rng, (m, d), dtype, device), _normal(rng, (d,), torch.float32, device, 0.2, 1.0),
            _normal(rng, (d,), torch.float32, device, 0.1), _normal(rng, (d, dh), dtype, device, d ** -0.5),
            _normal(rng, (dh,), torch.float32, device, 0.1), _normal(rng, (dh, d), dtype, device, dh ** -0.5),
            _normal(rng, (d,), torch.float32, device, 0.1), 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d,dh", [(394, 768, 3072), (37, 256, 512), (1, 1280, 256), (65, 1024, 512), (32, 256, 256)])
def test_mlp_block_matches_twin(cuda, rng, m, d, dh, dtype):
    args = _mlp_args(rng, m, d, dh, dtype, cuda)
    out = kernels.mlp_block(*args)
    assert kernels.launch_counts()["mlp_block"] == 1
    _close(out, kernels.mlp_block_plain(*args), dtype)


def test_transformer_kernels_refuse_what_they_do_not_take(cuda, rng):
    q = _normal(rng, (1, 9, 2, 24), torch.float32, cuda)
    with pytest.raises(ValueError):  # no instantiation for head dim 24
        kernels.flash_mha(q, q, q, 0.2)
    wide = _normal(rng, (1, 9, 2, 128), torch.float32, cuda)[..., :64]
    with pytest.raises(ValueError):  # not contiguous
        kernels.flash_mha(wide, wide, wide, 0.2)
    with pytest.raises(TypeError):
        kernels.flash_mha(q.double(), q.double(), q.double(), 0.2)
    mlp = _mlp_args(rng, 8, 256, 256, torch.float32, cuda)
    with pytest.raises(ValueError):  # ln_count past D
        kernels.mlp_block(*mlp, ln_count=257)
    with pytest.raises(ValueError):  # D = 320 has no instantiation
        kernels.mlp_block(*_mlp_args(rng, 8, 320, 256, torch.float32, cuda))
    with pytest.raises(ValueError):  # the hidden dim is no multiple of 64
        kernels.mlp_block(*_mlp_args(rng, 8, 256, 96, torch.float32, cuda))
    with pytest.raises(ValueError):  # past D 512 the hidden dim is a multiple of 256
        kernels.mlp_block(*_mlp_args(rng, 8, 768, 384, torch.float32, cuda))
    with pytest.raises(TypeError):  # x and the weights in two dtypes
        kernels.mlp_block(mlp[0].bfloat16(), *mlp[1:])
    with pytest.raises(ValueError):  # x not contiguous
        kernels.mlp_block(_normal(rng, (8, 512), torch.float32, cuda)[:, :256], *mlp[1:])
    attn = _attention_args(rng, 1, 9, 96, 4, torch.float32, cuda)  # head dim 24
    with pytest.raises(ValueError):
        kernels.attention_block(*attn)
    attn = _attention_args(rng, 1, 9, 64, 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        kernels.attention_block(attn[0].bfloat16(), *attn[1:])
    counts = kernels.launch_counts()
    assert counts["flash_mha"] == counts["attention_block"] == counts["mlp_block"] == 0
    assert 24 not in flash_attention.HEAD_DIMS and 320 not in transformer_block.MLP_DIMS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", transformer_block.MLP_DIMS)
def test_mlp_block_takes_every_width_at_four_times_the_hidden_dim(cuda, rng, d, dtype):
    args = _mlp_args(rng, 45, d, 4 * d, dtype, cuda)
    out = kernels.mlp_block(*args)
    assert kernels.launch_counts()["mlp_block"] == 1
    _close(out, kernels.mlp_block_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d,dh,post_norm,ln_count", [(70, 96, 384, True, 0), (33, 128, 384, False, 96),
                                                       (33, 128, 384, True, 96), (19, 768, 3072, True, 0),
                                                       (21, 1536, 256, True, 1000)])
def test_mlp_block_options_match_twin(cuda, rng, m, d, dh, post_norm, ln_count, dtype):
    args = list(_mlp_args(rng, m, d, dh, dtype, cuda))
    if ln_count:  # a zero-padded channel layout: real channels first
        for i in (0, 1, 2, 6):
            args[i][..., ln_count:] = 0
        args[3][ln_count:] = 0
        args[5][:, ln_count:] = 0
    args[7] = 1e-5
    out = kernels.mlp_block(*args, post_norm, ln_count)
    assert kernels.launch_counts()["mlp_block"] == 1
    _close(out, kernels.mlp_block_plain(*args, post_norm, ln_count), dtype)
    if ln_count:
        assert bool((out[:, ln_count:] == 0).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d", [(3137, 96), (50, 192), (197, 384), (49, 768), (9, 1536)])
def test_cn_mlp_block_matches_twin(cuda, rng, m, d, dtype):
    mlp = _mlp_args(rng, m, d, 4 * d, dtype, cuda)
    args = (mlp[0], _normal(rng, (m, d), dtype, cuda), *mlp[1:7], _normal(rng, (d,), torch.float32, cuda, 0.5), 1e-6)
    out = kernels.cn_mlp_block(*args)
    counts = kernels.launch_counts()
    assert counts["cn_mlp_block"] == 1 and counts["mlp_block"] == 0
    _close(out, kernels.cn_mlp_block_plain(*args), dtype)
    with pytest.raises(TypeError):  # the residual in another dtype than the weights
        kernels.cn_mlp_block(args[0], args[1].double(), *args[2:])


def _window_args(rng, nw, s, c, v2, masked, nw_img, dtype, device, ln_count=0):
    heads = c // 32
    mask = None
    if masked:
        mask = torch.from_numpy(np.where(rng.random((nw_img, s, s)) < 0.3, -100.0, 0.0).astype(np.float32)).to(device)
    logit_scale = torch.from_numpy(rng.uniform(0.5, 2.0, heads).astype(np.float32)).to(device) if v2 else None
    args = [_normal(rng, (nw, s, c), dtype, device), _normal(rng, (c,), torch.float32, device, 0.2, 1.0),
            _normal(rng, (c,), torch.float32, device, 0.1), _normal(rng, (c, 3 * c), dtype, device, c ** -0.5),
            _normal(rng, (3 * c,), torch.float32, device, 0.1), _normal(rng, (c, c), dtype, device, c ** -0.5),
            _normal(rng, (c,), torch.float32, device, 0.1), _normal(rng, (heads, s, s), torch.float32, device, 0.3),
            mask, logit_scale, heads, 32 ** -0.5, 1e-5, v2, nw_img, ln_count]
    if ln_count:
        for i in (0, 1, 2, 6):
            args[i][..., ln_count:] = 0
        args[3][ln_count:] = 0
        args[5][:, ln_count:] = 0
    return args


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("nw,s,c,masked,nw_img,ln_count", [
    (128, 49, 96, True, 64, 0), (8, 49, 192, False, 4, 0), (6, 49, 384, True, 2, 0), (2, 49, 768, True, 1, 0),
    (12, 64, 96, True, 4, 0), (5, 16, 64, False, 1, 0), (9, 1, 32, False, 3, 0), (8, 49, 128, True, 4, 96)])
def test_window_attention_block_matches_twin(cuda, rng, nw, s, c, masked, nw_img, ln_count, v2, dtype):
    args = _window_args(rng, nw, s, c, v2, masked, nw_img, dtype, cuda, ln_count)
    out = kernels.window_attention_block(*args)
    assert kernels.launch_counts()["window_attention_block"] == 1
    assert kernels.window_attention_block.kernel_launches == (4 if v2 else 3)
    _close(out, kernels.window_attention_block_plain(*args), dtype)
    if ln_count:
        assert bool((out[..., ln_count:] == 0).all())


def test_window_attention_block_keeps_a_row_maximum_per_head(cuda, rng):
    """Per-head logit scales of 100, 0.01 and 1 (v2) and per-head bias offsets
    of 0, -150 and 120 (v1): float32 within 2e-4·(1 + |twin|) all the same."""
    args = _window_args(rng, 16, 64, 96, True, False, 16, torch.float32, cuda)
    args[9] = torch.tensor([100.0, 0.01, 1.0], device=cuda)
    args[7] = torch.zeros_like(args[7])
    _close(kernels.window_attention_block(*args), kernels.window_attention_block_plain(*args), torch.float32)
    args = _window_args(rng, 64, 49, 96, False, False, 64, torch.float32, cuda)
    args[7] = args[7] + torch.tensor([0.0, -150.0, 120.0], device=cuda)[:, None, None]
    _close(kernels.window_attention_block(*args), kernels.window_attention_block_plain(*args), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("use_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape,k", [((2, 56, 56, 96), 7), ((3, 7, 7, 768), 7), ((1, 14, 14, 384), 7), ((2, 9, 19, 40), 3),
                                     ((1, 33, 17, 8), 5), ((2, 1, 1, 32), 7)])
def test_depthwise_conv2d_matches_twin(cuda, rng, shape, k, use_bias, dtype):
    x = _normal(rng, shape, dtype, cuda)
    taps = _normal(rng, (k, k, shape[3]), dtype, cuda, 1.0 / k)
    bias = _normal(rng, (shape[3],), torch.float32, cuda)
    out = kernels.depthwise_conv2d(x, taps, bias, use_bias)
    assert kernels.launch_counts()["depthwise_conv2d"] == 1
    assert kernels.launch_counts_by_shape()["depthwise_conv2d"] == {(tuple(shape), dtype): 1}
    ref = kernels.depthwise_conv2d_plain(x, taps, bias, use_bias)
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype and bool(torch.isfinite(out).all())
    err, scale = (out.float() - ref.float()).abs(), ref.float().abs()
    assert bool((err <= (1e-5 + 1e-5 * scale if dtype == torch.float32 else 2e-2 * (1 + scale))).all()), float(err.max())


def test_new_kernels_refuse_what_they_do_not_take(cuda, rng):
    x = _normal(rng, (1, 8, 8, 32), torch.float32, cuda)
    with pytest.raises(ValueError):  # 3x5 taps: square kernels only
        kernels.depthwise_conv2d(x, _normal(rng, (3, 5, 32), torch.float32, cuda), None, False)
    with pytest.raises(ValueError):  # 9x9 has no instantiation
        kernels.depthwise_conv2d(x, _normal(rng, (9, 9, 32), torch.float32, cuda), None, False)
    with pytest.raises(TypeError):  # x and the taps in two dtypes
        kernels.depthwise_conv2d(x.bfloat16(), _normal(rng, (3, 3, 32), torch.float32, cuda), None, False)
    with pytest.raises(ValueError):  # not contiguous
        kernels.depthwise_conv2d(x.permute(0, 2, 1, 3), _normal(rng, (3, 3, 32), torch.float32, cuda), None, False)
    args = _window_args(rng, 2, 16, 64, False, False, 1, torch.float32, cuda)
    with pytest.raises(ValueError):  # head dim 16
        kernels.window_attention_block(*args[:10], 4, *args[11:])
    with pytest.raises(TypeError):  # x and the weights in two dtypes
        kernels.window_attention_block(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError):  # 81 tokens a window
        kernels.window_attention_block(*_window_args(rng, 1, 81, 32, False, False, 1, torch.float32, cuda))
    # an explicit kernel route never gives way to stock operators: a map that needs padding, a strided convolution
    swin = models.SwinTransformer(96, (1,), (3,), 7, num_classes=4, attention="block").to(cuda)
    with pytest.raises(ValueError, match='attention="block"'):
        swin(torch.zeros(1, 40, 40, 3, device=cuda))
    with pytest.raises(ValueError, match='backend="kernel"'):
        models.DepthwiseConv(32, (3, 3), strides=(2, 2), backend="kernel")
    counts = kernels.launch_counts()
    assert counts["depthwise_conv2d"] == counts["window_attention_block"] == 0
    assert 16 != swin_attention.HEAD_DIM and 9 not in depthwise.KERNEL_SIZES


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("v2,pad_channels,window,size", [(False, False, 7, 56), (True, False, 8, 64), (False, True, 7, 112)],
                         ids=["v1", "v2", "padded"])
def test_swin_routes_run_their_kernels(cuda, rng, v2, pad_channels, window, size, dtype):
    """Embed dim 96, so head dim 32: two stages of two blocks, the second of each shifted and masked."""
    kw = dict(embed_dim=96, depths=(2, 2), num_heads=(3, 6), window_size=window, num_classes=10, v2=v2, dtype=dtype)
    native = models.SwinTransformer(**kw, attention="plain", mlp="plain", generator=torch.Generator().manual_seed(0))
    state = native.state_dict()
    if pad_channels:
        # a third stage of 384 channels, which need no padding, so that final norm and head keep their size
        kw.update(depths=(2, 1, 1), num_heads=(3, 6, 12))
        native = models.SwinTransformer(**kw, attention="plain", mlp="plain", generator=torch.Generator().manual_seed(0))
        state = models.pad_swin_state_dict(native.state_dict(), 96, kw["depths"], kw["num_heads"])
    model = models.SwinTransformer(**kw, pad_channels=pad_channels).to(cuda)
    model.load_state_dict(state)
    images = rng.random((3, size, size, 3), dtype=np.float32)
    logits = model(images)  # numpy in: runs on the card
    counts = kernels.launch_counts()
    blocks = len(model.blocks())
    assert counts["window_attention_block"] == blocks and counts["mlp_block"] == blocks
    # the counts by shape: two blocks a stage of (tokens, channels) for the MLP and (windows, tokens, channels) windows
    dim, grid = (128 if pad_channels else 96), size // 4
    by_shape = kernels.launch_counts_by_shape()
    assert by_shape["mlp_block"][((3 * grid * grid, dim), dtype)] == 2
    assert by_shape["window_attention_block"][((3 * (grid // window) ** 2, window * window, dim), dtype)] == 2
    assert sum(by_shape["mlp_block"].values()) == blocks
    assert logits.device.type == "cuda" and logits.shape == (3, 10) and logits.dtype == dtype
    ref = native.to(cuda)(images)
    tol = 1e-3 if dtype == torch.float32 else 4e-2
    assert bool(((logits.float() - ref.float()).abs() <= tol + tol * ref.float().abs()).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("depthwise_route,expected", [("kernel", 3), ("stock", 0), (None, 0)])
def test_convnext_routes_run_their_kernels(cuda, rng, depthwise_route, expected, dtype):
    kw = dict(block_dims=(96, 192), block_depths=(1, 2), num_classes=10, dtype=dtype)
    model = models.ConvNeXt(**kw, depthwise=depthwise_route, generator=torch.Generator().manual_seed(0)).to(cuda)
    with torch.no_grad():
        for block in model.blocks():
            block.layer_scale.fill_(0.5)  # the initial 1e-6 would hide the branch
    plain = models.ConvNeXt(**kw, mlp="plain", depthwise="stock").to(cuda)
    plain.load_state_dict(model.state_dict())
    images = rng.random((3, 64, 64, 3), dtype=np.float32)
    logits = model(images)  # numpy in: runs on the card
    counts = kernels.launch_counts()
    assert counts["cn_mlp_block"] == 3 and counts["depthwise_conv2d"] == expected
    assert logits.device.type == "cuda" and logits.shape == (3, 10) and logits.dtype == dtype
    ref = plain(images)
    tol = 1e-3 if dtype == torch.float32 else 4e-2
    assert bool(((logits.float() - ref.float()).abs() <= tol + tol * ref.float().abs()).all())


@pytest.mark.parametrize("dtype,attention,mlp,expected", [
    (torch.float32, None, None, {"attention_block": 2, "mlp_block": 2, "flash_mha": 0}),
    (torch.float32, "flash", "block", {"attention_block": 0, "mlp_block": 2, "flash_mha": 2}),
    (torch.bfloat16, "block", "plain", {"attention_block": 2, "mlp_block": 0, "flash_mha": 0}),
    (torch.bfloat16, "flash", None, {"attention_block": 0, "mlp_block": 2, "flash_mha": 2}),
])
def test_vit_routes_run_their_kernels(cuda, rng, dtype, attention, mlp, expected):
    kw = dict(num_classes=10, image_size=32, dtype=dtype)
    model = models.VisionTransformer(8, 2, 4, 256, 512, attention=attention, mlp=mlp,
                                     generator=torch.Generator().manual_seed(0), **kw).to(cuda)
    plain = models.VisionTransformer(8, 2, 4, 256, 512, attention="plain", mlp="plain", **kw).to(cuda)
    plain.load_state_dict(model.state_dict())
    images = rng.random((3, 32, 32, 3), dtype=np.float32)
    logits = model(images)  # numpy in: runs on the card
    counts = kernels.launch_counts()
    assert {k: counts[k] for k in expected} == expected
    assert logits.device.type == "cuda" and logits.shape == (3, 10) and logits.dtype == dtype
    ref = plain(images)
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    assert bool(((logits.float() - ref.float()).abs() <= tol + tol * ref.float().abs()).all())


def test_resnet_entry_runs_on_the_card(cuda):
    forward, (model, images) = graft_entry.entry()
    logits = forward(model, images)
    assert logits.device.type == "cuda" and logits.shape == (4, 1000) and bool(torch.isfinite(logits).all())
    assert all(v == 0 for v in kernels.launch_counts().values())  # stock operators only
