"""The port's fused stencil kernels (``cpu_vision_tpu_torch.ops.kernels``)
against the JAX package's Pallas kernels run in interpret mode.

On CPU tensors the wrappers run their plain twins, which hold the Pallas
kernels' order of operations: class maps must be equal, and blur+Sobel and
Harris agree within ``atol=1e-5`` (as the JAX tests hold the Pallas kernels
to their XLA oracles; XLA contracts some products and sums into FMAs when it
compiles the kernel body, torch's eager ops do not).  The CUDA kernels are
held against these twins on the card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops import edges as jedges
from cpu_vision_tpu.ops.pallas import stencil as js
from cpu_vision_tpu_torch.ops import kernels

SHAPES = [(64, 96), (72, 130), (33, 257), (6, 9), (67, 131)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _counts():
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


# ------------------------------------------------------- plain twins vs JAX


@pytest.mark.parametrize("shape", SHAPES)
def test_blur_sobel_matches_pallas(rng, shape):
    img = rng.random(shape, dtype=np.float32)
    ref = np.asarray(js.fused_blur_sobel(jnp.asarray(img), 5, 1.5, interpret=True))
    np.testing.assert_allclose(kernels.fused_blur_sobel(_t(img), 5, 1.5).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("shape,ks,sigma", [((2, 40, 48, 3), 5, 1.5), ((48, 64), 7, 2.0)])
def test_blur_sobel_batched_rgb_and_kernel7(rng, shape, ks, sigma):
    img = rng.random(shape, dtype=np.float32)
    ref = np.asarray(js.fused_blur_sobel(jnp.asarray(img), ks, sigma, interpret=True))
    out = kernels.fused_blur_sobel(_t(img), ks, sigma)
    assert out.shape == img.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 96), (50, 70), (6, 9), (67, 131), (20, 24, 3)])
def test_harris_matches_pallas(rng, shape):
    img = rng.random(shape, dtype=np.float32)
    ref = np.asarray(js.harris_response_fused(jnp.asarray(img), interpret=True))
    np.testing.assert_allclose(kernels.harris_response_fused(_t(img)).numpy(), ref, atol=1e-5)


@pytest.mark.parametrize(
    "shape,low,high",
    [((1, 40, 40), 0.2, 0.5), ((1, 64, 96), 0.1, 0.2), ((2, 96, 160), 0.1, 0.2), ((1, 6, 9), 0.1, 0.2),
     ((1, 67, 131), 0.08, 0.15), ((1, 33, 257), 0.3, 0.6)],
)
def test_canny_stage1_matches_pallas_exactly(rng, shape, low, high):
    maps = rng.random(shape, dtype=np.float32)
    ref = np.asarray(js.canny_stage1(jnp.asarray(maps), low, high, interpret=True))
    out = kernels.canny_stage1(_t(maps), low, high)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.fixture(scope="module")
def class_maps():
    rng = np.random.default_rng(1)
    out = []
    for shape, low, high in (((2, 96, 160), 0.1, 0.2), ((1, 67, 131), 0.08, 0.15)):
        maps = rng.random(shape, dtype=np.float32)
        out.append(np.asarray(js.canny_stage1(jnp.asarray(maps), low, high, interpret=True)))
    return out


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("sweeps", [1, 3, 4])
def test_hysteresis_sweeps_matches_pallas_exactly(class_maps, which, sweeps):
    cls = class_maps[which]
    ref = np.asarray(js.hysteresis_sweeps(jnp.asarray(cls, jnp.float32), sweeps, interpret=True))
    out = kernels.hysteresis_sweeps(_t(cls), sweeps)
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.uint8))


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("max_sweeps", [None, 0, 1, 3, 9, 20])
def test_fixpoint_matches_xla_hysteresis(class_maps, which, max_sweeps):
    # a reflected border adds no growth, so even a bounded number of sweeps
    # equals the zero-filled XLA loop's bounded iterations
    cls = class_maps[which]
    ref = np.asarray(jedges.hysteresis(jnp.asarray(cls == 2), jnp.asarray(cls >= 1), max_sweeps))
    out = kernels.hysteresis_fixpoint(_t(cls), max_sweeps)
    np.testing.assert_array_equal(out.numpy() == 2, ref)


def test_changed_flag_and_out_buffer(class_maps):
    cls = _t(class_maps[0])
    flag = torch.zeros(1, dtype=torch.int32)
    out = torch.empty_like(cls)
    res = kernels.hysteresis_sweeps(cls, 2, changed=flag, out=out)
    assert res is out and int(flag) == int(bool((out != cls).any()))
    fixed = kernels.hysteresis_fixpoint(cls)
    flag.zero_()
    kernels.hysteresis_sweeps(fixed, 4, changed=flag)
    assert int(flag) == 0


def test_cpu_tensors_launch_nothing(rng):
    img = _t(rng.random((2, 30, 40, 1), dtype=np.float32))
    kernels.fused_canny(img)
    kernels.fused_blur_sobel(img)
    kernels.harris_response_fused(img)
    assert set(kernels.launch_counts().values()) == {0}


def test_wrappers_reject_bad_arguments():
    maps = torch.rand(1, 8, 8)
    with pytest.raises(NotImplementedError):
        kernels.canny_stage1(maps, 0.1, 0.2, in_tile_hysteresis=True)
    with pytest.raises(ValueError):
        kernels.canny_stage1(maps[0], 0.1, 0.2)
    with pytest.raises(TypeError):
        kernels.canny_stage1(maps.double(), 0.1, 0.2)
    with pytest.raises(ValueError):
        kernels.canny_stage1(maps, 0.1, 0.2, kernel_size=33)
    cls = torch.zeros(1, 8, 8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        kernels.hysteresis_sweeps(cls, 17)
    with pytest.raises(ValueError):
        kernels.hysteresis_sweeps(cls, 2, out=cls)
    with pytest.raises(ValueError):
        kernels.fused_blur_sobel(torch.empty(8, 8, device="meta"))
