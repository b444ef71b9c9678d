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
multiply-adds: it is held to ``1e-5 + 1e-5·|twin|``.
"""

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch import ops
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import conv_block, stencil

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
        "harris_response_fused": 1, "fused_gaussian_blur": 1, "fused_conv3x3_relu_pool": 0}


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
