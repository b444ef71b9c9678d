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
``window_attention_block``, and in bfloat16 their tensor-core product
``bf16_product`` alone) sum their products in other orders than the twins'
matrix products, with fused multiply-adds: float32 is held to
``2e-4 + 2e-4·|twin|``, bfloat16 (compared in bfloat16, where one step is 2^-8
of the value) to ``2e-2 + 2e-2·|twin|``.  The depthwise convolution sums its
taps in the twin's order, with fused multiply-adds: ``1e-5 + 1e-5·|twin|`` in
float32, ``2e-2·(1 + |twin|)`` in bfloat16, and gives the same bits twice.  NMS keep masks must equal the
twin's bit for bit (the IoUs are the same float32 operations in the same
order, without FMA contraction), and so must Faster R-CNN's float32
detections on the kernel route and on the plain one.  The int8 product with
its requantising epilogue (``int8_matmul_requant``) must equal its twin bit for
bit, int8 or float32 out (exact int32 sums, the same float32 epilogue without
FMA contraction), and so must the int8 ResNet's logits on its two 1x1 routes.
The int8 sub-blocks (``mlp_block_int8``, ``attention_block_int8``) take their
LayerNorm statistics and exponentials in other orders than their twins, so a
quantised activation near a rounding half may land one step apart: held to
``2e-2·(1 + |twin|)`` in bfloat16 (one step is 2^-8 of the value) and float32,
that is to a few int8 steps of the sub-block's output.  The weight gradient
``wgrad_matmul`` sums float32 products (exact for bfloat16 inputs) in another
order than its twin's float32 product: held to ``1e-5·max|twin|``, and two
calls must give the same bits, as must two calls of each wrapper that runs a
bfloat16 attention core on the tensor cores, and of the float32 MLP blocks.
The weight gradient (both dtypes) and the float32 MLP and attention blocks,
whose float32 products run on the tensor cores by split TF32, stand no further from the
float64 result on the same inputs than twice a float32 product with TF32 off
(``max|out - f64| / max|f64|``), and the float32 attention core at head dim
64 (split TF32 too) no further than twice the scalar float32 core it
replaced (``flash_attention._flash_mha_scalar``).  The gradients of the kernels' routes are
held to the plain routes' within ``1e-5 + 1e-5·|plain|`` in float32 and
``1e-2·(1 + |plain|)`` in bfloat16 (and no further from the float32
function's than 1.5 times the plain route's).  The bfloat16 blocks' backward
kernels (``attention_core_backward``, ``mlp_gelu_backward``,
``ln_backward_rows``) are held to their plain versions: the transformer
kernels' bfloat16 rule, Kernel A's outputs bit for bit.  The ``None`` routes of
ViT, Swin and NMS send a shape their kernel does not take to the plain route
(NMS at 13,601 boxes a problem); explicit routes still raise there.  Past the
grid's 65,535 on y and z (row tiles, images, frames) the launchers walk the
rest in pieces: the wrappers at the smallest inputs past that equal their
twins or themselves on the pieces, bit for bit.  The fused convolution (split
TF32 on the tensor cores) stands no further from the float64 stage than twice
its twin (TF32 off).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cpu_vision_tpu_torch import _dtype, graft_entry, models, ops, parallel
from cpu_vision_tpu_torch.ops import kernels, pointwise
from cpu_vision_tpu_torch.ops.kernels import (conv_block, depthwise, flash_attention, int8_matmul, int8_transformer, nms,
                                              stencil, swin_attention, transformer_block)

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
        "depthwise_conv2d": 0, "nms_sorted": 0, "int8_matmul_requant": 0, "mlp_block_int8": 0,
        "attention_block_int8": 0, "wgrad_matmul": 0, "bf16_product": 0, "mlp_gelu_backward": 0,
        "attention_core_backward": 0, "ln_backward_rows": 0}


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
               ((1, 2, 2, 1), 1), ((1, 18, 34, 5), 33), ((2, 6, 50, 89), 7),
               # past the 89 input channels of the kernel before: windows of 32 channels, two column tiles
               ((2, 10, 22, 100), 70), ((1, 16, 16, 120), 130)]


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
    """Any Cin is taken now (the window is staged 32 channels at a time); odd sizes, a bias of another width and
    float64 are refused."""
    x = torch.zeros(1, 4, 4, 90, device=cuda)
    w = torch.zeros(3, 3, 90, 2, device=cuda)
    with pytest.raises(ValueError):
        kernels.fused_conv3x3_relu_pool(x[:, :3, :, :3], w[:, :, :3], torch.zeros(2, device=cuda))
    with pytest.raises(ValueError):
        kernels.fused_conv3x3_relu_pool(x, w, torch.zeros(3, device=cuda))
    with pytest.raises(TypeError):
        kernels.fused_conv3x3_relu_pool(x.double(), w.double(), torch.zeros(2, device=cuda, dtype=torch.float64))
    assert kernels.launch_counts()["fused_conv3x3_relu_pool"] == 0
    assert kernels.fused_conv3x3_relu_pool(x, w, torch.zeros(2, device=cuda)).shape == (1, 2, 2, 2)


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


# Canny's kernels (canny_strip_kernel, hysteresis_bits_kernel): maps under the halo, one row, one column, widths
# on and off multiples of 4, 16 and 32, strips at the edges and between them, and the 1080p b8 scene's shape
CANNY_SHAPES = [(1, 5, 7), (1, 1, 40), (1, 33, 1), (2, 20, 37), (1, 40, 100), (1, 12, 32), (1, 9, 48),
                (1, 70, 392), (1, 7, 3008), (9, 10, 64), (8, 1080, 1920)]


@pytest.mark.parametrize("shape", CANNY_SHAPES)
def test_canny_kernels_match_twins(cuda, rng, shape):
    """canny_stage1 and hysteresis_sweeps at 1-16 sweeps equal their twins bit for bit, and both flags equal the
    twin's: any pixel changed, and the last sweep changed one."""
    maps = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    cls = kernels.canny_stage1(maps, 0.05, 0.2)
    assert torch.equal(cls, stencil.canny_stage1_plain(maps, stencil.gaussian_taps(5, 1.4), 0.05, 0.2))
    for sweeps in range(1, 17):
        changed, last = torch.zeros(1, dtype=torch.int32, device=cuda), torch.zeros(1, dtype=torch.int32, device=cuda)
        out = kernels.hysteresis_sweeps(cls, sweeps, changed=changed, last_changed=last)
        before, twin = stencil._sweeps_plain(cls, sweeps)
        assert torch.equal(out, twin), sweeps
        assert int(changed) == int(bool((twin != cls).any())) and int(last) == int(bool((twin != before).any()))
    assert kernels.launch_counts()["canny_stage1"] == 1 and kernels.launch_counts()["hysteresis_sweeps"] == 16


@pytest.mark.parametrize("ks", range(1, 32))
def test_canny_stage1_every_window(cuda, rng, ks):
    """K 1-31 (2 columns a lane, or 1 past K 15; the ring of W-blurred rows fixed or shifting), interior and border
    strips, rows aligned and not."""
    for shape in ((2, 70, 392), (1, 37, 131)):
        maps = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
        assert torch.equal(kernels.canny_stage1(maps, 0.02, 0.1, ks, 0.4 + 0.2 * ks),
                           stencil.canny_stage1_plain(maps, stencil.gaussian_taps(ks, 0.4 + 0.2 * ks), 0.02, 0.1))


@pytest.mark.parametrize("max_sweeps", [None, 0, 1, 3, 9])
def test_fixpoint_matches_op_by_op_at_full_size(cuda, rng, max_sweeps):
    """Noise at 1080p b8 takes tens of sweeps to its fixpoint: every pass but the last has a last sweep that
    changes something."""
    maps = torch.from_numpy(rng.random((8, 1080, 1920), dtype=np.float32)).to(cuda)
    cls = kernels.canny_stage1(maps, 0.3, 0.6)
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
        stencil._launch("cvt_blur_sobel", x, x.data_ptr(), x.data_ptr(), 1, 8, 8, taps, 0, 132)


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
@pytest.mark.parametrize("shape", [(2, 197, 12, 64), (1, 257, 2, 80), (3, 17, 2, 16), (2, 64, 4, 64),
                                   (2, 65, 4, 64), (3, 1, 2, 64)])  # one real key in the second tile; one key
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
@pytest.mark.parametrize("n,s,d,heads", [(2, 197, 768, 12), (3, 50, 128, 2), (1, 17, 64, 4), (1, 130, 1280, 16),
                                         (1, 33, 2048, 32),  # D 2048: a LayerNorm row wider than the pass holds
                                         (2, 65, 256, 4), (3, 1, 128, 2)])
def test_attention_block_matches_twin(cuda, rng, n, s, d, heads, dtype):
    args = _attention_args(rng, n, s, d, heads, dtype, cuda)
    out = kernels.attention_block(*args)
    assert kernels.launch_counts()["attention_block"] == 1
    assert kernels.attention_block.kernel_launches == 4  # LN rows, QKV product, core, output projection
    _close(out, kernels.attention_block_plain(*args), dtype)


def _mlp_args(rng, m, d, dh, dtype, device):
    return (_normal(rng, (m, d), dtype, device), _normal(rng, (d,), torch.float32, device, 0.2, 1.0),
            _normal(rng, (d,), torch.float32, device, 0.1), _normal(rng, (d, dh), dtype, device, d ** -0.5),
            _normal(rng, (dh,), torch.float32, device, 0.1), _normal(rng, (dh, d), dtype, device, dh ** -0.5),
            _normal(rng, (d,), torch.float32, device, 0.1), 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d,dh", [(394, 768, 3072), (37, 256, 512), (1, 1280, 256), (65, 1024, 512), (32, 256, 256),
                                    # hidden dims a multiple of 64, not of 256 (taken up to D 512): ragged last tiles
                                    (75, 96, 448), (75, 128, 320), (75, 192, 704), (75, 256, 64), (75, 384, 1600),
                                    (75, 512, 2112)])
def test_mlp_block_matches_twin(cuda, rng, m, d, dh, dtype):
    args = _mlp_args(rng, m, d, dh, dtype, cuda)
    out = kernels.mlp_block(*args)
    assert kernels.launch_counts()["mlp_block"] == 1
    assert kernels.mlp_block.kernel_launches == 3  # LN, two tensor-core products (split TF32 in float32)
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
    odd = _normal(rng, (1 + 9 * 2 * 64,), torch.bfloat16, cuda)[1:].view(1, 9, 2, 64)  # contiguous, 2 bytes off
    with pytest.raises(ValueError):  # the tensor-core core copies 16-byte chunks
        kernels.flash_mha(odd, odd, odd, 0.2)
    mlp = _mlp_args(rng, 8, 256, 256, torch.float32, cuda)
    with pytest.raises(ValueError):  # ln_count past D
        kernels.mlp_block(*mlp, ln_count=257)
    with pytest.raises(ValueError):  # D = 320 is not in MLP_DIMS
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
    assert kernels.cn_mlp_block.kernel_launches == 3



def _product_args(rng, m, k, n, epilogue, device):
    a = _normal(rng, (m, k), torch.bfloat16, device)
    w = _normal(rng, (k, n), torch.bfloat16, device, k ** -0.5)
    bias = _normal(rng, (n,), torch.float32, device, 0.1)
    resid = _normal(rng, (m, n), torch.bfloat16, device) if epilogue.startswith("residual") else None
    gamma = _normal(rng, (n,), torch.float32, device, 0.5) if epilogue == "residual_gamma" else None
    out_dtype = torch.float32 if epilogue == "bias_f32" else torch.bfloat16
    return (a, w, bias, epilogue.split("_")[0] if epilogue != "residual_gamma" else "residual", resid, gamma,
            out_dtype)


@pytest.mark.parametrize("epilogue", ["bias", "bias_f32", "gelu", "residual", "residual_gamma"])
@pytest.mark.parametrize("n", [96, 288, 3072])
@pytest.mark.parametrize("k", [96, 3072])
@pytest.mark.parametrize("m", [1, 127, 129, 50432])
def test_bf16_product_matches_twin(cuda, rng, m, k, n, epilogue):
    """The tensor-core product of the bf16 blocks against its twin, ragged in m (a last tile of 1 row), n (96 and
    288 of 128-column tiles) and k (96 is one and a half 64-wide steps); two calls give the same bits (no atomics)."""
    args = _product_args(rng, m, k, n, epilogue, cuda)
    out = kernels.bf16_product(*args)
    assert kernels.bf16_product.launches == 1
    ref = kernels.bf16_product_plain(*args)
    assert out.shape == ref.shape and out.dtype == ref.dtype == args[-1] and bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs()  # a float32 output too is held to the bf16 rule: bf16 operands
    assert bool((err <= TOL[torch.bfloat16] * (1 + ref.float().abs())).all()), float(err.max())
    assert torch.equal(kernels.bf16_product(*args), out)


def test_bf16_product_refuses_what_it_does_not_take(cuda, rng):
    """What only the card refuses (the arguments' own checks run on the CPU too: test_torch_bf16_product.py)."""
    a, w = _normal(rng, (8, 40), torch.bfloat16, cuda), _normal(rng, (40, 16), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):  # k = 40
        kernels.bf16_product(a, w, _normal(rng, (16,), torch.float32, cuda))
    a, w = _normal(rng, (8, 32), torch.bfloat16, cuda), _normal(rng, (32, 12), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):  # n = 12
        kernels.bf16_product(a, w, _normal(rng, (12,), torch.float32, cuda))
    assert kernels.bf16_product.launches == 0


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
    (12, 64, 96, True, 4, 0), (5, 16, 64, False, 1, 0), (9, 1, 32, False, 3, 0), (8, 49, 128, True, 4, 96),
    (64, 49, 96, True, 64, 0), (16, 64, 96, False, 16, 0)])  # Swin-T S1's widths, one image; Swin-v2-T's, unmasked
def test_window_attention_block_matches_twin(cuda, rng, nw, s, c, masked, nw_img, ln_count, v2, dtype):
    args = _window_args(rng, nw, s, c, v2, masked, nw_img, dtype, cuda, ln_count)
    out = kernels.window_attention_block(*args)
    assert kernels.launch_counts()["window_attention_block"] == 1
    # v1: LN rows first; v2: LN + residual last; bf16 v2: the v columns, then q and k in float64
    assert kernels.window_attention_block.kernel_launches == (5 if v2 and dtype == torch.bfloat16 else 4)
    _close(out, kernels.window_attention_block_plain(*args), dtype)
    if ln_count:
        assert bool((out[..., ln_count:] == 0).all())


def test_bf16_v2_window_block_over_seeds(cuda):
    """The bf16 v2 window block with a zero-padded channel layout at ``chip_smoke.py``'s held shape (4096, 49, 128),
    ``ln_count`` 96, the shift mask and logit scales drawn about e^2.3, over 24 draws of its inputs: every draw
    within the bf16 rule of the twin.  Both sides round q/|q| and k/|k| to bf16 from float32 QKV rows summed in other
    orders, so a rounding flip, times the logit scale, moves a score.  A draw past the rule is ``ROADMAP.md``'s open
    fault 1, which this test shows until it is fixed."""
    nw, s, c, nw_img, ln_count, dtype = 4096, 49, 128, 64, 96, torch.bfloat16
    mask = models.swin._shift_mask(56, 56, 7, 3, 3).to(cuda)
    errs = {}
    for seed in range(24):
        rng = np.random.default_rng(seed)
        args = _window_args(rng, nw, s, c, True, True, nw_img, dtype, cuda, ln_count)
        args[8] = mask
        args[9] = _normal(rng, (c // 32,), torch.float32, cuda, 0.5, 2.3)
        args[4][c:2 * c] = 0
        out, twin = kernels.window_attention_block(*args), kernels.window_attention_block_plain(*args)
        err = (out.float() - twin.float()).abs()
        errs[seed] = (float(err.max()), bool((err <= TOL[dtype] + TOL[dtype] * twin.float().abs()).all()))
    assert all(ok for _, ok in errs.values()), {k: v for k, v in errs.items() if not v[1]}


def _core_calls(rng, device):
    """{name: call} of each wrapper that runs a bf16 tensor-core attention core, at a ragged shape."""
    bf16 = torch.bfloat16
    qkv = [_normal(rng, (2, 197, 12, 64), bf16, device) for _ in range(3)]
    attn = _attention_args(rng, 2, 197, 768, 12, bf16, device)
    attn8 = _int8_attn_args(rng, 2, 197, 768, 12, bf16, device)
    v1 = _window_args(rng, 64, 49, 96, False, True, 64, bf16, device)
    v2 = _window_args(rng, 16, 64, 96, True, False, 16, bf16, device)
    return {"flash_mha": lambda: kernels.flash_mha(*qkv, 0.125),
            "attention_block": lambda: kernels.attention_block(*attn),
            "attention_block_int8": lambda: kernels.attention_block_int8(*attn8),
            "window_attention_block v1": lambda: kernels.window_attention_block(*v1),
            "window_attention_block v2": lambda: kernels.window_attention_block(*v2)}


@pytest.mark.parametrize("name", ["flash_mha", "attention_block", "attention_block_int8", "window_attention_block v1",
                                  "window_attention_block v2"])
def test_bf16_attention_cores_give_the_same_bits_twice(cuda, rng, name):
    """The cores sum in a fixed order without atomics: two calls on the same inputs are equal bit for bit."""
    call = _core_calls(rng, cuda)[name]
    first = call()
    assert torch.equal(call(), first)


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,k,use_bias", [((2, 9, 13, 40), 7, True), ((1, 9, 13, 200), 5, False),
                                              ((3, 7, 7, 200), 3, True), ((2, 9, 13, 42), 7, True),
                                              ((1, 23, 30, 96), 7, False)])
def test_depthwise_conv2d_off_its_tiles(cuda, rng, shape, k, use_bias, dtype):
    """Maps off the 7x7 patches, channel groups past C, C 42 (plain loads, not a multiple of 8 values) and an input
    off 16-byte alignment (plain loads): held to the twin, the same bits twice."""
    x = _normal(rng, shape, dtype, cuda)
    taps = _normal(rng, (k, k, shape[3]), dtype, cuda, 1.0 / k)
    bias = _normal(rng, (shape[3],), torch.float32, cuda)
    offset = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:].view(shape)  # contiguous, 2 or 4 bytes off
    offset.copy_(x)
    assert depthwise.kernel_info(offset, k)["vector_copies"] == 0
    assert depthwise.kernel_info(x, k)["vector_copies"] == (shape[3] % (8 if dtype == torch.bfloat16 else 4) == 0)
    ref = kernels.depthwise_conv2d_plain(x, taps, bias, use_bias)
    for inp in (x, offset):
        out = kernels.depthwise_conv2d(inp, taps, bias, use_bias)
        assert torch.equal(kernels.depthwise_conv2d(inp, taps, bias, use_bias), out)
        err, scale = (out.float() - ref.float()).abs(), ref.float().abs()
        assert bool((err <= (1e-5 + 1e-5 * scale if dtype == torch.float32 else 2e-2 * (1 + scale))).all()), \
            float(err.max())


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


def _nms_field(rng, p, n, extent=100.0, spread=30.0):
    ctr = rng.random((p, n, 2)) * extent
    wh = rng.random((p, n, 2)) * spread + 1
    return torch.from_numpy(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32))


@pytest.mark.parametrize("n", [1, 130, 300, 1000, 4096])
@pytest.mark.parametrize("p", [1, 8, 32])
def test_nms_sorted_matches_twin(cuda, rng, p, n):
    boxes = _nms_field(rng, p, n, extent=max(20.0, n ** 0.5 * 3)).to(cuda)
    for thr in (0.3, 0.5, 0.7):
        keep = kernels.nms_sorted(boxes, thr)
        assert keep.dtype == torch.bool and keep.shape == (p, n)
        assert torch.equal(keep, nms.nms_sorted_plain(boxes, thr))
    assert kernels.launch_counts_by_shape()["nms_sorted"] == {((p, n, 4), torch.float32): 3}


def test_nms_sorted_degenerate_and_offset_boxes(cuda, rng):
    same = torch.tensor([[10.0, 10.0, 30.0, 40.0]]).repeat(2, 100, 1)  # all identical: the first is kept
    flat = _nms_field(rng, 2, 100)
    flat[..., 2] = flat[..., 0]  # zero width: unions of 0 and below the 1e-12 floor
    crowd = _nms_field(rng, 4, 700, extent=20.0, spread=15.0)  # deep suppression chains
    for boxes in (same, flat, crowd, crowd.to(torch.bfloat16)):
        for thr in (0.3, 0.5, 0.7):
            got = kernels.nms_sorted(boxes.to(cuda), thr)
            assert torch.equal(got.cpu(), nms.nms_sorted_plain(boxes, thr))
    assert int(kernels.nms_sorted(same.to(cuda), 0.5).sum()) == 2
    # the class offsets of batched_nms at 90 classes on a 640 canvas, through ops.nms with unsorted scores
    boxes, scores = _nms_field(rng, 8, 4096, extent=600.0), torch.from_numpy(rng.random((8, 4096), dtype=np.float32))
    ids = torch.from_numpy(rng.integers(0, 90, (8, 4096)))
    got = ops.batched_nms(boxes.to(cuda), scores.to(cuda), ids.to(cuda), 0.5)
    assert torch.equal(got.cpu(), ops.batched_nms(boxes, scores, ids, 0.5))
    assert torch.equal(got, ops.batched_nms(boxes.to(cuda), scores.to(cuda), ids.to(cuda), 0.5, backend="plain"))


def test_nms_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="at most"):
        kernels.nms_sorted(torch.zeros((1, nms.MAX_BOXES + 1, 4), device=cuda), 0.5)
    with pytest.raises(ValueError, match="at most"):
        ops.nms(torch.zeros((nms.MAX_BOXES + 1, 4), device=cuda), torch.zeros(nms.MAX_BOXES + 1, device=cuda), 0.5,
                backend="kernel")
    with pytest.raises(ValueError, match="problems"):
        kernels.nms_sorted(torch.zeros((nms.MAX_PROBLEMS + 1, 2, 4), device=cuda), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        ops.nms(torch.zeros((5, 4)), torch.zeros(5), 0.5, backend="kernel")
    assert kernels.launch_counts()["nms_sorted"] == 0


def test_faster_rcnn_kernel_route_equals_plain(cuda, rng):
    """A small float32 forward (full width, 2 images of 320x320) with the
    three NMS calls (the four levels of 300 candidates, the max-pool level's
    75, the postprocess's 400) on the kernel and on the twin: equal detections."""
    torch.backends.cudnn.deterministic = True
    try:
        model = models.get_model("fasterrcnn_resnet50_fpn", num_classes=5, rpn_pre_nms_top_n=300,
                                 rpn_post_nms_top_n=100, max_detections=20, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.roi_heads.box_predictor.cls_score.weight.mul_(4.0)
        images = torch.from_numpy(rng.random((2, 320, 320, 3), dtype=np.float32)).to(cuda)
        with nms.recording() as calls:
            dets = model(images)
        counts = kernels.launch_counts_by_shape()["nms_sorted"]
        assert counts == {((8, 300, 4), torch.float32): 1, ((2, 75, 4), torch.float32): 1,
                          ((2, 400, 4), torch.float32): 1}, counts
        assert [(tuple(b.shape), thr) for b, thr in calls] == [((8, 300, 4), 0.7), ((2, 75, 4), 0.7),
                                                                ((2, 400, 4), 0.5)]
        model.set_nms("plain")
        plain = model(images)
        for key in dets:
            assert torch.equal(dets[key], plain[key]), key
        assert int(dets["valid"].sum()) > 0 and bool(torch.isfinite(dets["boxes"]).all())
        assert kernels.launch_counts()["nms_sorted"] == 3
    finally:
        torch.backends.cudnn.deterministic = False


# ------------------------------------------------------------ None routes stay in the kernels' domains


def test_nms_none_route_past_the_kernels_boxes(cuda, rng):
    """13,601 boxes in one problem: past MAX_BOXES the None route runs the twin
    (counted in plain_routes) where it used to raise; "kernel" still raises."""
    n = nms.MAX_BOXES + 1
    boxes, scores = _nms_field(rng, 1, n, extent=3000.0), torch.from_numpy(rng.random((1, n), dtype=np.float32))
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    got = ops.nms(boxes, scores, 0.5)
    assert kernels.nms_sorted.plain_routes == 1 and kernels.nms_sorted.launches == 0
    assert torch.equal(got, ops.nms(boxes, scores, 0.5, backend="plain"))
    with pytest.raises(ValueError, match="at most"):
        ops.nms(boxes, scores, 0.5, backend="kernel")


@pytest.mark.parametrize("d,heads,mlp_dim", [(640, 10, 2560), (384, 12, 1536)])
def test_vit_none_routes_run_off_the_kernels_domains(cuda, rng, d, heads, mlp_dim):
    """D 640 (outside MLP_DIMS) and head dim 32 ran into the kernels' refusals
    on the None route; now the sub-block that the kernel does not take runs
    stock operators, and an explicit route still raises."""
    model = models.VisionTransformer(16, 1, heads, d, mlp_dim, num_classes=10, image_size=32, dtype=torch.bfloat16,
                                     generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32)).to(cuda)
    out = model(x)
    plain = models.VisionTransformer(16, 1, heads, d, mlp_dim, num_classes=10, image_size=32, dtype=torch.bfloat16,
                                     attention="plain", mlp="plain").to(cuda)
    plain.load_state_dict(model.state_dict())
    assert torch.isfinite(out.float()).all() and _scaled_err(out, plain(x)) < 8e-2
    with pytest.raises(ValueError):
        models.VisionTransformer(16, 1, heads, d, mlp_dim, num_classes=10, image_size=32, dtype=torch.bfloat16,
                                 attention="block" if d == 384 else None, mlp="block" if d == 640 else None).to(cuda)(x)


def test_swin_none_routes_run_off_the_kernels_domains(cuda, rng):
    """Windows of 9 x 9 (81 tokens) and C 80 lie outside the window kernel's and the MLP kernel's domains."""
    model = models.SwinTransformer(40, (2,), (2,), 9, num_classes=5, dtype=torch.bfloat16,
                                   generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.from_numpy(rng.random((2, 36, 36, 3), dtype=np.float32)).to(cuda)
    out = model(x)
    assert torch.isfinite(out.float()).all() and kernels.window_attention_block.launches == 0
    assert kernels.mlp_block.launches == 0


# ------------------------------------------- past the launch grids (65,535 on y and z)

GRID = 65535  # a grid's y and z: row tiles, images, frames; the launchers walk more in pieces


def _randn(shape, dtype, device, seed, std=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def test_int8_matmul_requant_past_the_grid(cuda, rng):
    """65,535 x 128 + 1 rows (134 MB of int8): one row tile past the grid's y; the None route's kernel equals the
    twin bit for bit."""
    m = GRID * 128 + 1
    qx = torch.randint(-127, 128, (m, 16), dtype=torch.int8, device=cuda)
    qw = torch.from_numpy(rng.integers(-127, 128, (16, 8), dtype=np.int8)).to(cuda)
    sc, bias = torch.rand(8, device=cuda) * 1e-2 + 1e-3, torch.rand(8, device=cuda) - 0.5
    for out_scale in (None, torch.tensor(0.05)):
        got = kernels.int8_matmul_requant(qx, qw, sc, bias, out_scale, True)
        assert torch.equal(got, int8_matmul.int8_matmul_requant_plain(qx, qw, sc, bias, out_scale, True))
    assert kernels.launch_counts()["int8_matmul_requant"] == 2


@pytest.mark.parametrize("conv_channels,n,hw", [((32, 64), GRID + 1, 28), ((32, 128, 64), 4, 32)],
                         ids=["images_past_the_grid", "cin_128"])
def test_cnn_forward_past_the_old_limits(cuda, rng, conv_channels, n, hw):
    """cnn_forward on the None route at 65,536 28x28x1 images (205 MB) and with a 128-channel stage (32x32 images:
    three even stages), where the kernel it replaced refused (65,535 images; 89 input channels): within the conv
    stage's rule of the plain route (the twin on the card)."""
    params = ops.cnn_init(torch.Generator().manual_seed(0), (hw, hw), 1, conv_channels, 128, 10)
    x = _randn((n, hw, hw, 1), torch.float32, cuda, 3).abs()
    logits = ops.cnn_forward(params, x)
    assert kernels.launch_counts()["fused_conv3x3_relu_pool"] == len(conv_channels)
    assert torch.allclose(logits, ops.cnn_forward(params, x, backend="plain"), rtol=1e-5, atol=1e-5)


def test_stencils_past_the_grid(cuda, rng):
    """ops.canny (Canny's stage and hysteresis sweeps) and harris_response_fused on 65,536 frames of 12 x 10: past
    the grid's z, Canny the same bits as on the first 65,535 frames and the last one apart (on random frames a tie
    of gradient magnitudes may part the kernels from the plain route, whatever the grid), Harris the twin's."""
    maps = torch.rand((GRID + 1, 12, 10), device=cuda, generator=torch.Generator(device=cuda).manual_seed(16))
    edges = ops.canny(maps[..., None], 0.1, 0.2)
    counts = kernels.launch_counts()
    assert counts["canny_stage1"] == 1 and counts["hysteresis_sweeps"] >= 1
    pieces = torch.cat([ops.canny(maps[:GRID, ..., None], 0.1, 0.2), ops.canny(maps[GRID:, ..., None], 0.1, 0.2)])
    assert torch.equal(edges, pieces)
    resp = kernels.harris_response_fused(maps[..., None])[..., 0]
    assert torch.equal(resp, stencil.harris_response_fused_plain(maps, stencil.gaussian_taps(5, 1.0), 0.04))
    assert kernels.launch_counts()["harris_response_fused"] == 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_block_past_the_grid(cuda, dtype):
    """mlp_block at 65,535 x 128 + 1 tokens of D 96 (ConvNeXt-T's width): its two products run one row tile past
    the grid's y, and the rows give the same bits as the same block on the two pieces."""
    m, d, dh = GRID * 128 + 1, 96, 384
    x = _randn((m, d), dtype, cuda, 1)
    params = (_randn((d,), torch.float32, cuda, 2, 0.2) + 1, _randn((d,), torch.float32, cuda, 3, 0.1),
              _randn((d, dh), dtype, cuda, 4, d ** -0.5), _randn((dh,), torch.float32, cuda, 5, 0.1),
              _randn((dh, d), dtype, cuda, 6, dh ** -0.5), _randn((d,), torch.float32, cuda, 7, 0.1), 1e-6)
    with torch.no_grad():
        out = kernels.mlp_block(x, *params)
        cut = GRID * 128
        assert torch.equal(out[:cut], kernels.mlp_block(x[:cut], *params))
        assert torch.equal(out[cut:], kernels.mlp_block(x[cut:], *params))
    assert kernels.launch_counts()["mlp_block"] == 3


def test_mlp_block_int8_past_the_grid(cuda, rng):
    """mlp_block_int8 at 65,535 x 128 + 1 tokens of D 256: the same bits as on the two pieces."""
    m = GRID * 128 + 1
    _, *params = _int8_mlp_args(rng, 1, 256, 256, torch.bfloat16, cuda)
    x = _randn((m, 256), torch.bfloat16, cuda, 8)
    out = kernels.mlp_block_int8(x, *params)
    cut = GRID * 128
    assert torch.equal(out[:cut], kernels.mlp_block_int8(x[:cut], *params))
    assert torch.equal(out[cut:], kernels.mlp_block_int8(x[cut:], *params))


def test_mlp_gelu_backward_past_the_grid(cuda):
    """Kernel A at 65,535 x 64 + 1 rows (its row tiles of 64 on the grid's y): the activations and du's halves the
    plain version's bits; the upstream gradient is zero but on the last 65 rows, so that the bias gradient sums
    those rows alone and is held by the rule of test_mlp_gelu_backward_matches_plain."""
    m, dh = GRID * 64 + 1, 64
    da32 = torch.zeros((m, dh), device=cuda)
    da32[-65:] = _randn((65, dh), torch.float32, cuda, 9)
    hw, b1 = _randn((m, dh), torch.float32, cuda, 10, 2.0), _randn((dh,), torch.float32, cuda, 11, 0.3)
    du2, a, db1 = kernels.mlp_gelu_backward(da32, hw, b1)
    ref_du2, ref_a, ref_db1 = kernels.mlp_gelu_backward_plain(da32, hw, b1)
    assert torch.equal(a, ref_a) and torch.equal(du2, ref_du2)
    assert bool(((db1 - ref_db1).abs() <= 1e-5 * (1 + ref_db1.abs()) + 1e-5 * ref_db1.abs().max()).all())


@pytest.mark.parametrize("name", ["attention_block", "flash_mha", "attention_block_int8", "attention_core_backward"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_past_the_grid(cuda, rng, name, dtype):
    """65,536 sequences of 3 tokens at head dim 64, past the grid's z: each wrapper on the None route gives the
    same bits as on the first 65,535 and the last one apart (Kernel B: bfloat16 only)."""
    if name == "attention_core_backward" and dtype != torch.bfloat16:
        pytest.skip("Kernel B is the bfloat16 core's backward")
    n, s, d, heads = GRID + 1, 3, 128, 2
    if name.startswith("attention_block"):
        make, fn = ((_attention_args, kernels.attention_block) if name == "attention_block"
                    else (_int8_attn_args, kernels.attention_block_int8))
        params = make(rng, 1, s, d, heads, dtype, cuda)[1:]
        x = _randn((n, s, d), dtype, cuda, 12)
        call = lambda sl: fn(x[sl], *params)  # noqa: E731
    else:
        q, k, v = (_randn((n, s, heads, 64), dtype, cuda, seed) for seed in (12, 13, 14))
        do = _randn((n, heads, s, 64), dtype, cuda, 15)
        if name == "flash_mha":
            call = lambda sl: kernels.flash_mha(q[sl], k[sl], v[sl], 0.125)  # noqa: E731
        else:
            call = lambda sl: torch.cat([t.flatten(1) for t in  # noqa: E731
                                         kernels.attention_core_backward(q[sl], k[sl], v[sl], do[sl], 0.125)], 1)
    with torch.no_grad():
        out = call(slice(None))
        assert torch.equal(out[:GRID], call(slice(0, GRID)))
        assert torch.equal(out[GRID:], call(slice(GRID, None)))
    assert kernels.launch_counts()[name] == 3


def test_conv_block_stands_near_float64(cuda, rng):
    """The split-TF32 implicit GEMM at the CNN's four main-path stages (batch cut to 8 at 224x224): no further from
    the stage in float64 than twice its twin's float32 products (TF32 off)."""
    for shape, cout in (((8, 224, 224, 3), 32), ((8, 112, 112, 32), 64), ((64, 28, 28, 1), 32),
                        ((64, 14, 14, 32), 64)):
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
        w = torch.from_numpy(rng.normal(0, (2 / (9 * shape[-1])) ** 0.5, (3, 3, shape[-1], cout))
                             .astype(np.float32)).to(cuda)
        b = torch.from_numpy(rng.normal(0, 0.1, (cout,)).astype(np.float32)).to(cuda)
        y64 = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1), b.double(), padding=1)
        ref64 = F.max_pool2d(torch.relu(y64), 2).permute(0, 2, 3, 1)
        twin = conv_block.fused_conv3x3_relu_pool_plain(x, w, b)
        assert _f64_err(kernels.fused_conv3x3_relu_pool(x, w, b), ref64) <= 2 * _f64_err(twin, ref64), shape


def _scaled_err(a, b):
    return float(((a.float() - b.float()).abs() / (1 + b.float().abs())).max())


# ------------------------------------------------------------ int8 kernels


@pytest.mark.parametrize("m,k,n", [(300, 96, 200), (1000, 64, 256), (129, 2048, 1000), (17, 16, 7), (12544, 512, 2048),
                                   (4099, 48, 100)])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("quantised", [False, True])
def test_int8_matmul_requant_equals_twin(cuda, rng, m, k, n, relu, quantised):
    qx = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(cuda)
    qw = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(cuda)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32)).to(cuda)  # per-channel
    bias = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(cuda)
    out_scale = torch.tensor(0.02 * (k / 96) ** 0.5, device=cuda) if quantised else None
    got = kernels.int8_matmul_requant(qx, qw, scale, bias, out_scale, relu)
    torch.cuda.synchronize()
    want = int8_matmul.int8_matmul_requant_plain(qx, qw, scale, bias, out_scale, relu)
    assert got.dtype == (torch.int8 if quantised else torch.float32) and torch.equal(got, want)
    assert kernels.int8_matmul_requant.launches == 1
    # the transposed layout the engine stores costs no copy and gives the same product
    qwt = qw.t().contiguous()
    assert torch.equal(kernels.int8_matmul_requant(qx, qwt.t(), scale, bias, out_scale, relu), want)


def test_int8_matmul_requant_refuses(cuda):
    qx, qw = torch.zeros((8, 24), dtype=torch.int8, device=cuda), torch.zeros((24, 8), dtype=torch.int8, device=cuda)
    v = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        kernels.int8_matmul_requant(qx, qw, v, v)
    with pytest.raises(ValueError, match="aligned"):
        big = torch.zeros((9, 32), dtype=torch.int8, device=cuda)
        kernels.int8_matmul_requant(big.reshape(-1)[1:257].reshape(8, 32), qw[:16].repeat(2, 1), v, v)
    assert kernels.int8_matmul_requant.launches == 0


def _int8_mlp_args(rng, m, d, dh, dtype, device, per_channel=True):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    x = t(rng.standard_normal((m, d))).to(dtype)
    g, b = t(rng.uniform(0.5, 1.5, d)), t(rng.standard_normal(d) * 0.1)
    a1 = t(rng.uniform(0.02, 0.05, d) if per_channel else 0.04)
    a2 = t(rng.uniform(0.005, 0.02, dh) if per_channel else 0.015)
    qw1, s1 = int8_transformer.quantize_weight(t(rng.standard_normal((d, dh)) * d ** -0.5) * a1.reshape(-1, 1))
    qw2, s2 = int8_transformer.quantize_weight(t(rng.standard_normal((dh, d)) * dh ** -0.5) * a2.reshape(-1, 1))
    return x, g, b, qw1, s1, t(rng.standard_normal(dh) * 0.1), qw2, s2, t(rng.standard_normal(d) * 0.1), a1, a2


# the widths of every registered ViT (B: 768/3072, L: 1024/4096, H: 1280/5120), ragged token counts
@pytest.mark.parametrize("m,d,dh", [(197, 768, 3072), (50, 1024, 4096), (33, 1280, 5120), (70, 256, 512),
                                    (1, 512, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlp_block_int8_matches_twin(cuda, rng, m, d, dh, dtype):
    args = _int8_mlp_args(rng, m, d, dh, dtype, cuda)
    got = kernels.mlp_block_int8(*args)
    torch.cuda.synchronize()
    want = int8_transformer.mlp_block_int8_plain(*args)
    assert got.dtype == dtype and _scaled_err(got, want) <= 2e-2
    # LN rows to int8, the up- and the down-projection on wgmma s8
    assert kernels.mlp_block_int8.launches == 1 and kernels.mlp_block_int8.kernel_launches == 3
    assert torch.equal(got, kernels.mlp_block_int8(*args))  # exact int32 sums: the same bits twice


def test_mlp_block_int8_per_tensor_scales(cuda, rng):
    args = _int8_mlp_args(rng, 100, 768, 3072, torch.bfloat16, cuda, per_channel=False)
    assert _scaled_err(kernels.mlp_block_int8(*args), int8_transformer.mlp_block_int8_plain(*args)) <= 2e-2


def _int8_attn_args(rng, n, s, d, heads, dtype, device, per_channel=True):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    x = t(rng.standard_normal((n, s, d))).to(dtype)
    g, b = t(rng.uniform(0.5, 1.5, d)), t(rng.standard_normal(d) * 0.1)
    a1 = t(rng.uniform(0.02, 0.05, d) if per_channel else 0.04)
    ao = t(rng.uniform(0.01, 0.03, d) if per_channel else 0.02)
    qwqkv, sqkv = int8_transformer.quantize_weight(t(rng.standard_normal((d, 3 * d)) * d ** -0.5) * a1.reshape(-1, 1))
    qwo, so = int8_transformer.quantize_weight(t(rng.standard_normal((d, d)) * d ** -0.5) * ao.reshape(-1, 1))
    return (x, g, b, qwqkv, sqkv, t(rng.standard_normal(3 * d) * 0.1), qwo, so, t(rng.standard_normal(d) * 0.1), a1,
            ao, heads, (d // heads) ** -0.5)


@pytest.mark.parametrize("n,s,d,heads", [(4, 197, 768, 12), (2, 257, 1280, 16), (3, 50, 1024, 16), (2, 33, 256, 4),
                                         (1, 5, 64, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_block_int8_matches_twin(cuda, rng, n, s, d, heads, dtype):
    args = _int8_attn_args(rng, n, s, d, heads, dtype, cuda, per_channel=d != 64)
    got = kernels.attention_block_int8(*args)
    torch.cuda.synchronize()
    want = int8_transformer.attention_block_int8_plain(*args)
    assert got.dtype == dtype and _scaled_err(got, want) <= 2e-2
    # LN rows to int8, the QKV product, the core, the output product
    assert kernels.attention_block_int8.launches == 1 and kernels.attention_block_int8.kernel_launches == 4


def test_int8_transformer_kernels_refuse(cuda, rng):
    args = list(_int8_mlp_args(rng, 8, 256, 256, torch.bfloat16, cuda))
    with pytest.raises(ValueError, match="the kernel takes D"):
        kernels.mlp_block_int8(*_int8_mlp_args(rng, 8, 384, 256, torch.bfloat16, cuda))
    args[0] = args[0].to(torch.float16)
    with pytest.raises(TypeError):
        kernels.mlp_block_int8(*args)
    with pytest.raises(ValueError, match="head dims"):
        kernels.attention_block_int8(*_int8_attn_args(rng, 2, 9, 256, 8, torch.bfloat16, cuda))  # head dim 32
    assert kernels.mlp_block_int8.launches == 0 and kernels.attention_block_int8.launches == 0


def test_int8_engines_run_their_kernels(cuda, rng):
    """Int8ViT (2 layers, D 256) and Int8ResNet (resnet18, resnext50_32x4d) on the card: the kernels launch, and
    the ResNets' logits on the 1x1 kernel route equal the stock route's bit for bit."""
    x = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32)).to(cuda)
    vit = models.VisionTransformer(16, 2, 4, 256, 512, num_classes=10, dtype=torch.bfloat16, image_size=64,
                                   generator=torch.Generator().manual_seed(0)).to(cuda)
    eng = models.Int8ViT.from_model(vit).calibrate([x])
    out = eng(x)
    plain = models.Int8ViT.from_model(vit, route="plain").set_scales(eng.scales)(x)
    assert kernels.mlp_block_int8.launches == 2 and kernels.attention_block_int8.launches == 2
    assert _scaled_err(out, plain) < 2e-2 and bool(torch.isfinite(out).all())
    for name, launches in (("resnet50", 16 * 2 + 4), ("resnext50_32x4d", 16 * 2 + 4)):
        model = models.get_model(name, num_classes=10, generator=torch.Generator().manual_seed(0))
        gen = torch.Generator(device=cuda).manual_seed(1)  # else each block's last scale is 0
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.weight.uniform_(0.5, 1.5, generator=gen)
        eng = models.Int8ResNet.from_model(model).calibrate([x])
        kernels.reset_launch_counts()
        got = eng(x)
        assert kernels.int8_matmul_requant.launches == launches, (name, kernels.int8_matmul_requant.launches)
        stock = models.Int8ResNet.from_model(model, conv1x1="stock").set_scales(eng.scales)(x)
        assert torch.equal(got, stock), name


RESNET50_1X1 = [(401408, 64, 64), (401408, 64, 256), (401408, 256, 64), (401408, 256, 128),
                (100352, 128, 512), (100352, 512, 128), (100352, 256, 512), (100352, 512, 256),
                (25088, 256, 1024), (25088, 1024, 256), (25088, 512, 1024), (25088, 1024, 512)]


@pytest.mark.parametrize("m,cin,cout", RESNET50_1X1 + [(1, 3, 5), (31, 1, 1), (16383, 65, 129), (50000, 100, 60)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_matmul_matches_twin(cuda, m, cin, cout, dtype):
    from cpu_vision_tpu_torch.ops.kernels.wgrad_matmul import wgrad_matmul_plain

    gen = torch.Generator(device=cuda).manual_seed(m + cin + cout)
    x = torch.randn((m, cin), generator=gen, device=cuda).to(dtype)
    dy = torch.randn((m, cout), generator=gen, device=cuda).to(dtype)
    out = kernels.wgrad_matmul(x, dy)
    ref = wgrad_matmul_plain(x, dy)
    assert out.shape == (cin, cout) and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(kernels.wgrad_matmul(x, dy), out)  # deterministic: the same bits twice
    assert kernels.wgrad_matmul.launches_by_shape == {((m, cin), dtype): 2}


@pytest.mark.parametrize("name", ["mlp_block", "mlp_block post_norm", "cn_mlp_block"])
def test_f32_mlp_blocks_give_the_same_bits_twice(cuda, rng, name):
    """The split-TF32 products sum in a fixed order without atomics: two calls are equal bit for bit."""
    mlp = _mlp_args(rng, 300, 192, 768, torch.float32, cuda)
    call = {"mlp_block": lambda: kernels.mlp_block(*mlp),
            "mlp_block post_norm": lambda: kernels.mlp_block(*mlp, True),
            "cn_mlp_block": lambda: kernels.cn_mlp_block(mlp[0], mlp[0] * 0.5, *mlp[1:7], mlp[6], 1e-6)}[name]
    first = call()
    assert torch.equal(call(), first)


def _f64_err(out, ref64):
    return float((out.double() - ref64).abs().max() / ref64.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_matmul_stands_near_float64(cuda, dtype):
    """Split TF32 (float32) and bf16 wgmma (bfloat16), each stage's sums added into a float32 register sum: no
    further from the float64 product of the same inputs than twice torch.mm's float32 product (TF32 off)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((100352, 256), generator=gen, device=cuda).to(dtype)
    dy = torch.randn((100352, 512), generator=gen, device=cuda).to(dtype)
    ref64 = x.t().double() @ dy.double()
    with _dtype.full_float32():
        library = torch.mm(x.t().float(), dy.float())
    assert _f64_err(kernels.wgrad_matmul(x, dy), ref64) <= 2 * _f64_err(library, ref64)


def test_f32_mlp_block_stands_near_float64(cuda, rng):
    """The float32 MLP's split-TF32 products, at ViT-B/16's width: no further from the block in float64 (the
    twin's LayerNorm and erf polynomial) than twice the twin's float32 products (TF32 off)."""
    args = _mlp_args(rng, 4096, 768, 3072, torch.float32, cuda)
    x, ln_g, ln_b, w1, b1, w2, b2, eps = args
    h = transformer_block._ln_f32(x.double(), ln_g.double(), ln_b.double(), eps)
    ref64 = x.double() + transformer_block._gelu_f32(h @ w1.double() + b1.double()) @ w2.double() + b2.double()
    assert _f64_err(kernels.mlp_block(*args), ref64) <= 2 * _f64_err(kernels.mlp_block_plain(*args), ref64)


@pytest.mark.parametrize("block", ["attention_block", "window v1", "window v2", "window ln_count"])
def test_f32_attention_blocks_stand_near_float64(cuda, rng, block):
    """The float32 attention blocks' split-TF32 products: within the float32 rule of the twin, no further from the
    block in float64 than twice the twin (TF32 off), the same bits twice."""
    if block == "attention_block":
        args = _attention_args(rng, 4, 197, 768, 12, torch.float32, cuda)
        fn, twin, ref64 = kernels.attention_block, kernels.attention_block_plain, transformer_block._attention_block_f64
    else:
        v2, ln_count = block == "window v2", 96 if block == "window ln_count" else 0
        args = _window_args(rng, 128, 64 if v2 else 49, 128 if ln_count else 96, v2, True, 64, torch.float32, cuda,
                            ln_count)
        fn, twin = kernels.window_attention_block, kernels.window_attention_block_plain
        ref64 = swin_attention._window_attention_block_f64
    out, plain, exact = fn(*args), twin(*args), ref64(*args)
    _close(out, plain, torch.float32)
    assert torch.equal(fn(*args), out)
    assert _f64_err(out, exact) <= 2 * _f64_err(plain, exact), (_f64_err(out, exact), _f64_err(plain, exact))


def test_f32_window_block_stands_near_float64_over_seeds(cuda):
    """The float32 window block at the float32 Swin-T path's first-stage shape (batch 32: 2048 windows of 49 tokens,
    C 96, masked) over 24 draws of its inputs: no further from the block in float64 than twice the twin (TF32 off)
    on every draw (``ROADMAP.md`` queue 3 lists, as its open fault 2, another draw of this shape that was not)."""
    far = {}
    for seed in range(24):
        args = _window_args(np.random.default_rng(seed), 2048, 49, 96, False, True, 64, torch.float32, cuda)
        exact = swin_attention._window_attention_block_f64(*args)
        out, plain = kernels.window_attention_block(*args), kernels.window_attention_block_plain(*args)
        far[seed] = (_f64_err(out, exact), _f64_err(plain, exact))
    assert all(k <= 2 * t for k, t in far.values()), {s: v for s, v in far.items() if v[0] > 2 * v[1]}


# (seed, offset) of ``chip_smoke.py``'s checks' generator at the draw of ``ROADMAP.md``'s open fault 2, as its
# "fault 2 (open)" line prints them.  The offset a draw advances the generator by depends on the card's number of
# SMs: these are an H100 SXM's (132).
FAULT_2_DRAW = (0, 12968)


def test_f32_window_block_on_fault_2s_draw(cuda):
    """The float32 window block at the float32 Swin-T path's first-stage shape (2048 windows of 49 tokens, C 96, the
    shift mask), on the draw of ``ROADMAP.md``'s open fault 2, replayed from ``chip_smoke.py``'s checks' generator:
    no further from the block in float64 than twice the twin (TF32 off).  On an H100 it read 2.10 times, and this
    test stands failing until the fault is fixed."""
    gen = torch.Generator(device=cuda).manual_seed(FAULT_2_DRAW[0])
    gen.set_offset(FAULT_2_DRAW[1])

    def normal(shape, std=1.0, mean=0.0):  # chip_smoke.py's draws, in its window cases' order
        return torch.randn(shape, generator=gen, device=cuda) * std + mean

    args = [normal((2048, 49, 96)), normal((96,), 0.2, 1.0), normal((96,), 0.1), normal((96, 288), 96 ** -0.5),
            normal((288,), 0.1), normal((96, 96), 96 ** -0.5), normal((96,), 0.1), normal((3, 49, 49), 0.3),
            models.swin._shift_mask(56, 56, 7, 3, 3).to(cuda), None, 3, 32 ** -0.5, 1e-5, False, 64, 0]
    exact = swin_attention._window_attention_block_f64(*args)
    out, plain = kernels.window_attention_block(*args), kernels.window_attention_block_plain(*args)
    assert _f64_err(out, exact) <= 2 * _f64_err(plain, exact), (_f64_err(out, exact), _f64_err(plain, exact))


def test_f32_flash_core_stands_near_float64(cuda, rng):
    """The float32 core at head dim 64 by split TF32, at ViT-B/16 b64's (64, 197, 12, 64): within the float32 rule
    of the twin, no further from float64 than twice the scalar float32 core it replaced, the same bits twice."""
    q, k, v = (_normal(rng, (64, 197, 12, 64), torch.float32, cuda) for _ in range(3))
    out = kernels.flash_mha(q, k, v, 0.125)
    assert kernels.launch_counts()["flash_mha"] == 1
    _close(out, kernels.flash_mha_plain(q, k, v, 0.125), torch.float32)
    assert torch.equal(kernels.flash_mha(q, k, v, 0.125), out)
    p = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q.double(), k.double()) * 0.125, dim=-1)
    ref64 = torch.einsum("nhqk,nkhd->nhqd", p, v.double())
    assert _f64_err(out, ref64) <= 2 * _f64_err(flash_attention._flash_mha_scalar(q, k, v, 0.125), ref64)


def _grads(fn, args):
    args = [a.detach().requires_grad_(a.dtype.is_floating_point) for a in args]
    out = fn(*args)
    gen = torch.Generator(device=out.device).manual_seed(7)
    out.backward(torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype))
    return [a.grad for a in args]


def _assert_grads_equal(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(((g.float() - w.float()).abs() <= tol * (1 + w.float().abs())).all()), float((g - w).abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_routes_give_the_plain_routes_gradients(cuda, rng, dtype):
    """Rows 7, 9-14: the kernel forward, then the kernel routes' backward: in bfloat16 the card's own for rows 9-12
    (Kernel A, Kernel B, ``ln_backward_rows``, the tensor-core products), the twin's recomputed gradient for row 13,
    row 14's own (the forward kernel on the flipped taps), and in float32 the twins' for rows 9-13.  The plain route
    is the twin under autograd, its backward's products taken as the twin's own backward takes them
    (``float32_products``: in bfloat16, TF32 rounds a float32 cotangent to 10 mantissa bits).  In bfloat16 each
    gradient also stands no further from the float32 function's than 1.5 times the twin's with a full-float32
    backward does (norms over the tensor).  The window block's mask is a constant, as in the JAX ``_bwd``."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def normal(shape, dt=torch.float32, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=cuda) * std + mean).to(dt)

    tol = 1e-5 if dtype == torch.float32 else 1e-2

    def check(kernel, plain, args):
        got = _grads(kernel, args)
        with _dtype.float32_products(dtype):
            _assert_grads_equal(got, _grads(plain, args), tol)
        if dtype == torch.bfloat16:
            with _dtype.full_float32():
                full = _grads(plain, args)
                truth = _grads(plain, [a.float() for a in args])
            for g, f, t in zip(got, full, truth):
                t = t.double()
                assert float((g.double() - t).norm()) <= 1.5 * float((f.double() - t).norm()) + 1e-6 * float(t.norm())

    q, k, v = (normal((2, 197, 12, 64), dtype) for _ in range(3))
    check(lambda *a: kernels.flash_mha(*a, 0.125), lambda *a: flash_attention.flash_mha_plain(*a, 0.125), (q, k, v))
    d = 768
    attn = (normal((2, 197, d), dtype), normal(d, std=0.2, mean=1.0), normal(d, std=0.1),
            normal((d, 3 * d), dtype, d ** -0.5), normal(3 * d, std=0.1), normal((d, d), dtype, d ** -0.5),
            normal(d, std=0.1))
    check(lambda *a: kernels.attention_block(*a, 12, 0.125),
          lambda *a: transformer_block.attention_block_plain(*a, 12, 0.125), attn)
    mlp = (normal((394, d), dtype), normal(d, std=0.2, mean=1.0), normal(d, std=0.1),
           normal((d, 3072), dtype, d ** -0.5), normal(3072, std=0.1), normal((3072, d), dtype, 3072 ** -0.5),
           normal(d, std=0.1))
    check(kernels.mlp_block, transformer_block.mlp_block_plain, mlp)
    conv = (normal((4, 28, 28, 8)), normal((3, 3, 8, 16), std=0.1), normal(16, std=0.1))
    _assert_grads_equal(_grads(kernels.fused_conv3x3_relu_pool, conv),
                        _grads(conv_block.fused_conv3x3_relu_pool_plain, conv), 1e-5)
    # row 12: ConvNeXt's tail, with a residual of its own and a layer scale
    cn = (mlp[0], normal((394, d), dtype), *mlp[1:], normal(d, std=0.5))
    check(kernels.cn_mlp_block, transformer_block.cn_mlp_block_plain, cn)
    # row 13: Swin-T's first stage, v1 with the shift mask and v2 with its logit scale
    c, heads, s_len, nw_img = 96, 3, 49, 4
    for v2 in (False, True):
        mask = None if v2 else torch.where(torch.rand((nw_img, s_len, s_len), generator=gen, device=cuda) < 0.3,
                                           -100.0, 0.0)
        win = [normal((8, s_len, c), dtype), normal(c, std=0.2, mean=1.0), normal(c, std=0.1),
               normal((c, 3 * c), dtype, c ** -0.5), normal(3 * c, std=0.1), normal((c, c), dtype, c ** -0.5),
               normal(c, std=0.1), normal((heads, s_len, s_len), std=0.3)]
        if v2:
            win.append(normal(heads, std=0.5, mean=1.0))
        tail = (heads, 32 ** -0.5, 1e-5, v2, nw_img)

        def window(fn, *a, mask=mask, v2=v2, tail=tail):
            return fn(*a[:8], mask, a[8] if v2 else None, *tail)

        check(lambda *a: window(kernels.window_attention_block, *a),
              lambda *a: window(swin_attention.window_attention_block_plain, *a), win)
    # row 14: ConvNeXt's 7x7 depthwise convolution, with its bias
    dw = (normal((2, 14, 14, 96), dtype), normal((7, 7, 96), dtype, 1.0 / 7), normal(96))
    if dtype == torch.float32:
        _assert_grads_equal(_grads(kernels.depthwise_conv2d, dw), _grads(depthwise.depthwise_conv2d_plain, dw), 1e-5)
    else:
        check(kernels.depthwise_conv2d, depthwise.depthwise_conv2d_plain, dw)
    assert {name: kernels.launch_counts()[name] for name in
            ("flash_mha", "attention_block", "mlp_block", "fused_conv3x3_relu_pool", "cn_mlp_block",
             "window_attention_block", "depthwise_conv2d")} == {
        "flash_mha": 1, "attention_block": 1, "mlp_block": 1, "fused_conv3x3_relu_pool": 1, "cn_mlp_block": 1,
        "window_attention_block": 2, "depthwise_conv2d": 2}  # the depthwise backward's dx is one more launch
    backward = kernels.launch_counts()
    if dtype == torch.bfloat16:  # rows 9-12 on the card's backward: three cores, two MLP blocks
        assert (backward["attention_core_backward"], backward["mlp_gelu_backward"], backward["ln_backward_rows"]) == (
            2, 2, 3)
    else:
        assert backward["attention_core_backward"] == backward["mlp_gelu_backward"] == backward["ln_backward_rows"] == 0


@pytest.mark.parametrize("n,s,heads", [(128, 197, 12), (3, 65, 2), (2, 256, 4), (1, 1, 1), (5, 130, 3),
                                        (4, 197, 12), (2, 257, 16), (1, 577, 16)])
def test_attention_core_backward_matches_plain(cuda, rng, n, s, heads):
    """Kernel B at ViT-B/16 b128's core, ragged ones and past the first design's cap of S 256 (257; 577, a 384²
    input): dq, dk, dv and the joined heads within the bf16 rule of its plain version (whose TF32 products round ds
    as the kernel does), the same bits twice; two launches a call."""
    q, k, v = (_normal(rng, (n, s, heads, 64), torch.bfloat16, cuda) for _ in range(3))
    do = _normal(rng, (n, heads, s, 64), torch.bfloat16, cuda)
    o = torch.empty_like(q)
    got = kernels.attention_core_backward(q, k, v, do, 0.125, o=o)
    assert kernels.launch_counts()["attention_core_backward"] == 1
    assert kernels.attention_core_backward.kernel_launches == 2
    with _dtype.float32_products(torch.bfloat16):
        ref = kernels.attention_core_backward_plain(q, k, v, do, 0.125)
        joined = kernels.flash_mha_plain(q, k, v, 0.125).transpose(1, 2)
    for a, b in zip((*got, o), (*ref, joined.contiguous())):
        _close(a, b, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, kernels.attention_core_backward(q, k, v, do, 0.125)))


@pytest.mark.parametrize("m,dh", [(25216, 3072), (75, 448), (1, 64)])
def test_mlp_gelu_backward_matches_plain(cuda, rng, m, dh):
    """Kernel A at ViT-B/16 b128's hidden and ragged ones: the activations and du's two halves the plain version's
    bits (the same operators in the same order, none contracted), the bias gradient (sums over the rows in other
    orders) within 1e-5·(1 + |plain|) and 1e-5 of its largest."""
    da32, hw, b1 = (_normal(rng, (m, dh), torch.float32, cuda), _normal(rng, (m, dh), torch.float32, cuda, 2.0),
                    _normal(rng, (dh,), torch.float32, cuda, 0.3))
    du2, a, db1 = kernels.mlp_gelu_backward(da32, hw, b1)
    assert kernels.launch_counts()["mlp_gelu_backward"] == 1
    ref_du2, ref_a, ref_db1 = kernels.mlp_gelu_backward_plain(da32, hw, b1)
    assert torch.equal(a, ref_a) and torch.equal(du2, ref_du2)
    assert bool(((db1 - ref_db1).abs() <= 1e-5 * (1 + ref_db1.abs()) + 1e-5 * ref_db1.abs().max()).all()), float(
        (db1 - ref_db1).abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d,resid", [(25216, 768, True), (75, 96, True), (9, 2048, False), (1, 64, True)])
def test_ln_backward_rows_matches_plain(cuda, rng, m, d, resid, dtype):
    """ln_backward_rows at ViT-B/16 b128's rows and ragged ones: dx within the transformer kernels' rule, the
    parameters' gradients within 1e-5·(1 + |plain|) and 1e-5 of their largest, the same bits twice."""
    x, dh, r = (_normal(rng, (m, d), dtype, cuda) for _ in range(3))
    ln_g = _normal(rng, (d,), torch.float32, cuda, 0.2, 1.0)
    got = kernels.ln_backward_rows(x, ln_g, dh, r if resid else None)
    assert kernels.launch_counts()["ln_backward_rows"] == 1
    ref = kernels.ln_backward_plain(x, ln_g, dh, r if resid else None)
    _close(got[0], ref[0], dtype)
    for a, b in zip(got[1:], ref[1:]):
        assert bool(((a - b).abs() <= 1e-5 * (1 + b.abs()) + 1e-5 * b.abs().max()).all()), float((a - b).abs().max())
    assert all(torch.equal(a, b) for a, b in zip(got, kernels.ln_backward_rows(x, ln_g, dh, r if resid else None)))


@pytest.mark.parametrize("offset,chunks", [(0, 3), (1, 0)])
def test_ln_backward_rows_misaligned_view_takes_the_scalar_kernel(cuda, rng, offset, chunks):
    """ViT-B/16 b128's rows in bf16 take the vector kernel (three 16-byte chunks a lane); the same rows on a view
    one value off 16-byte alignment (contiguous all the same) take the scalar kernel, held to the same rules."""
    m, d = 25216, 768

    def rows():
        return _normal(rng, (m * d + offset,), torch.bfloat16, cuda)[offset:].view(m, d)

    x, dh, r = rows(), rows(), rows()
    ln_g = _normal(rng, (d,), torch.float32, cuda, 0.2, 1.0)
    assert transformer_block.ln_backward_info(x, ln_g, dh, r)["chunks_a_lane"] == chunks
    got = kernels.ln_backward_rows(x, ln_g, dh, r)
    ref = kernels.ln_backward_plain(x, ln_g, dh, r)
    _close(got[0], ref[0], torch.bfloat16)
    for a, b in zip(got[1:], ref[1:]):
        assert bool(((a - b).abs() <= 1e-5 * (1 + b.abs()) + 1e-5 * b.abs().max()).all()), float((a - b).abs().max())
    assert all(torch.equal(a, b) for a, b in zip(got, kernels.ln_backward_rows(x, ln_g, dh, r)))


def test_vit_train_step_runs_the_backward_kernels(cuda, rng, monkeypatch):
    """A bf16 ViT (D 256, head dim 64, 2 layers) step on the kernel routes: each MLP's backward launches Kernel A,
    each attention block's Kernel B, each of the four LayerNorms ln_backward_rows; no twin is recomputed."""
    twins = []
    for name in ("mlp_block_plain", "attention_block_plain"):
        twin = getattr(transformer_block, name)
        monkeypatch.setattr(transformer_block, name, lambda *a, twin=twin, **k: twins.append(twin) or twin(*a, **k))
    model = models.VisionTransformer(16, 2, 4, 256, 512, num_classes=10, dtype=torch.bfloat16, image_size=64,
                                     attention="block", mlp="block", generator=torch.Generator().manual_seed(0))
    step = parallel.make_train_step(
        lambda m, b: (torch.nn.functional.cross_entropy(m(b[0], train=True).float(), b[1]), {}))
    images = torch.from_numpy(rng.random((4, 64, 64, 3), dtype=np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 10, 4)).to(cuda)
    loss, _ = step(model.to(cuda), (images, labels))
    counts = kernels.launch_counts()
    assert bool(torch.isfinite(loss)) and not twins
    assert (counts["mlp_gelu_backward"], counts["attention_core_backward"], counts["ln_backward_rows"]) == (2, 2, 4)
    assert counts["mlp_block"] == counts["attention_block"] == 2


def test_cnn_forward_kernel_route_trains(cuda, rng):
    """Repair of the conv stage: on the card ``cnn_forward`` takes the fused kernel, and its gradients equal the
    plain route's (before, the kernel's output had no ``grad_fn``, and the conv weights got no gradient)."""
    params = ops.cnn_init(torch.Generator().manual_seed(0), (28, 28), 1, (32, 64), 128, 10)
    images = torch.from_numpy(rng.random((64, 28, 28, 1), dtype=np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 10, 64)).to(cuda)
    grads = {}
    for backend in ("kernel", "plain"):
        leaves = {f"{k}.{n}": t.detach().clone().requires_grad_() for k, v in params.items() for n, t in v.items()}
        tree = {k: {n: leaves[f"{k}.{n}"] for n in v} for k, v in params.items()}
        loss = torch.nn.functional.cross_entropy(ops.cnn_forward(tree, images, backend=backend), labels)
        loss.backward()
        grads[backend] = {name: t.grad for name, t in leaves.items()}
    assert kernels.launch_counts()["fused_conv3x3_relu_pool"] == 2
    for name, g in grads["kernel"].items():
        assert g is not None, name
        ref = grads["plain"][name]
        assert bool(((g - ref).abs() <= 1e-4 * (1 + ref.abs())).all()), (name, float((g - ref).abs().max()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1x1_weight_gradient_switches_to_the_kernel_at_16384_rows(cuda, rng, dtype):
    for rows, launches in ((pointwise.MIN_ROWS_FOR_KERNEL - 1, 0), (pointwise.MIN_ROWS_FOR_KERNEL, 1)):
        kernels.reset_launch_counts()
        gen = torch.Generator(device=cuda).manual_seed(rows)
        x = torch.randn((1, 1, rows, 64), generator=gen, device=cuda).to(dtype).requires_grad_()
        conv = ops.PointwiseConv(64, 96, dtype=dtype, generator=torch.Generator().manual_seed(0)).to(cuda)
        y = conv(x)
        g = torch.randn(y.shape, generator=gen, device=cuda).to(dtype)
        y.backward(g)
        assert kernels.wgrad_matmul.launches == launches, rows
        want = kernels.wgrad_matmul_plain(x.detach().reshape(-1, 64), g.reshape(-1, 96)).t()[:, :, None, None]
        got = conv.weight.grad
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + (0 if dtype == torch.float32 else
                                                                                    2 ** -8 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_vit_train_step_on_the_kernels(cuda, rng, dtype):
    """A small ViT (D 256, head dim 64, 2 layers) takes a training step on attention_block and mlp_block; its
    gradients are the plain routes' within 1e-4·(1 + |plain|) in float32, 5e-2·max|plain| a parameter in bfloat16."""
    images = torch.from_numpy(rng.random((4, 64, 64, 3), dtype=np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 10, 4)).to(cuda)
    grads = {}
    for route in ("block", "plain"):
        model = models.VisionTransformer(16, 2, 4, 256, 512, num_classes=10, dtype=dtype, image_size=64,
                                         attention=route, mlp=route, generator=torch.Generator().manual_seed(0))
        model = model.to(cuda)
        step = parallel.make_train_step(
            lambda m, b: (torch.nn.functional.cross_entropy(m(b[0], train=True).float(), b[1]), {}))
        kernels.reset_launch_counts()
        loss, _ = step(model, (images, labels))
        assert bool(torch.isfinite(loss))
        grads[route] = {n: p.grad for n, p in model.named_parameters()}
        if route == "block":
            assert kernels.launch_counts()["attention_block"] == 2 and kernels.launch_counts()["mlp_block"] == 2
    for name, g in grads["block"].items():
        ref = grads["plain"][name]
        if dtype == torch.float32:
            assert bool(((g - ref).abs() <= 1e-4 * (1 + ref.abs())).all()), (name, float((g - ref).abs().max()))
        else:
            assert float((g - ref).abs().max()) <= 5e-2 * float(ref.abs().max()), name


@pytest.mark.parametrize("name,kernel_kw,plain_kw,launched", [
    ("swin_t", {}, dict(attention="plain", mlp="plain"), ("window_attention_block", "mlp_block")),
    ("convnext_tiny", dict(depthwise="kernel"), dict(mlp="plain", depthwise="stock"),
     ("cn_mlp_block", "depthwise_conv2d"))])
def test_swin_convnext_train_step_kernel_routes_match_plain(cuda, rng, name, kernel_kw, plain_kw, launched):
    """Swin-T and ConvNeXt-T in bfloat16 take two seeded training steps (224², 8 images, SGD with momentum, the
    models' default stochastic depth drawn from generators of one seed): block 0 (probability 0) on the kernels, the
    rest on the plain routes (the JAX rule), beside the same steps on the plain routes.  As ``chip_smoke.py`` holds
    them at b128: the first loss within the bf16 model rule 8e-2·(1 + |plain|), the loss after the update within
    2e-3·(1 + |plain|) (at 8 images an update halves the loss and carries the routes further apart than at 128),
    and the first gradients within 1e-2·||plain|| over all parameters and over the stem's and block 0's.  (Not a
    parameter at a time: the plain route's attention takes its probabilities' gradient in bf16 where the kernel
    route's recomputed twin keeps float32, and single entries stray.)"""
    images = torch.from_numpy(rng.random((8, 224, 224, 3), dtype=np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 1000, 8)).to(cuda)
    state = models.get_model(name, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).state_dict()
    for key in state:  # at its initial 1e-6 the layer scale would hide ConvNeXt's branches
        if key.endswith("layer_scale"):
            state[key].fill_(0.25)
    losses, grads = {}, {}
    for route, kw in (("kernel", kernel_kw), ("plain", plain_kw)):
        model = models.get_model(name, dtype=torch.bfloat16, **kw)
        model.load_state_dict(state)
        gen = torch.Generator(device=cuda).manual_seed(3)
        step = parallel.make_train_step(
            lambda m, b: (torch.nn.functional.cross_entropy(m(b[0], train=True, generator=gen).float(), b[1]), {}),
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
        kernels.reset_launch_counts()
        losses[route] = [float(step(model, (images, labels))[0])]
        counts = kernels.launch_counts()
        assert all((counts[k] >= 1) == (route == "kernel") for k in launched), counts
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        grads[route] = {n: p.grad.double() for n, p in model.named_parameters()}
        losses[route].append(float(step(model, (images, labels))[0]))
    loss_gaps = [abs(k - p) / (1 + abs(p)) for k, p in zip(losses["kernel"], losses["plain"])]

    def l2_gap(keep):
        names = [n for n in grads["plain"] if keep(n)]
        return math.sqrt(sum(float((grads["kernel"][n] - grads["plain"][n]).square().sum()) for n in names)
                         / sum(float(grads["plain"][n].square().sum()) for n in names))

    gaps = (l2_gap(lambda n: True), l2_gap(lambda n: n.startswith(("features.0.", "features.1.0."))))
    assert loss_gaps[0] <= 8e-2 and loss_gaps[1] <= 2e-3 and max(gaps) <= 1e-2, (losses, loss_gaps, gaps)


def test_resnet_train_step_on_the_card(cuda, rng):
    """ResNet-18 in float32 (no TF32) trains with batch statistics; the running statistics move as flax's do."""
    model = models.get_model("resnet18", num_classes=10, generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(rng.random((8, 64, 64, 3), dtype=np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 10, 8)).to(cuda)
    with torch.no_grad(), _dtype.full_float32():
        conv1 = torch.nn.functional.conv2d(images.permute(0, 3, 1, 2), model.conv1.weight, stride=2, padding=3)
    mean, var = conv1.mean(dim=(0, 2, 3)), conv1.var(dim=(0, 2, 3), unbiased=False)
    step = parallel.make_train_step(lambda m, b: (torch.nn.functional.cross_entropy(m(b[0], train=True), b[1]), {}))
    loss, _ = step(model, (images, labels))
    assert bool(torch.isfinite(loss)) and all(p.grad is not None for p in model.parameters())
    torch.testing.assert_close(model.bn1.running_mean, 0.1 * mean, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(model.bn1.running_var, 0.9 + 0.1 * var, rtol=1e-4, atol=1e-5)
