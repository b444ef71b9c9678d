"""The port's CUDA kernels on the card, held against their plain PyTorch
twins and the op-by-op paths on the same inputs.

Every test here needs an NVIDIA card and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Class maps and blur+Sobel/Harris maps must be equal to the twins' bit for
bit: kernel and twin run the same float32 operations in the same order,
without FMA contraction.
"""

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch import ops
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import stencil

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
    assert kernels.launch_counts() == {
        "canny_stage1": 1, "hysteresis_sweeps": 3, "fused_blur_sobel": 1, "harris_response_fused": 1}


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
