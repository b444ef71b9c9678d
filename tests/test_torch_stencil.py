"""The port's fused stencil kernels (``cpu_vision_tpu_torch.ops.kernels``)
against the JAX package's Pallas kernels run in interpret mode.

On CPU tensors the wrappers run their plain twins, which hold the Pallas
kernels' order of operations: class maps must be equal, and blur+Sobel and
Harris agree within ``atol=1e-5`` (as the JAX tests hold the Pallas kernels
to their XLA oracles; XLA contracts some products and sums into FMAs when it
compiles the kernel body, torch's eager ops do not); the blur alone agrees
within ``1e-6``.  With ``in_tile_hysteresis`` the class map depends on the
tiling, so only its global hysteresis fixpoint is compared, exactly.  The
CUDA kernels are held against these twins on the card by
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu import ops as jops
from cpu_vision_tpu.ops import edges as jedges
from cpu_vision_tpu.ops.pallas import stencil as js
from cpu_vision_tpu_torch import ops as tops
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import stencil

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


@pytest.mark.parametrize("shape,ks,sigma", [((64, 96), 5, 1.5), ((2, 40, 56, 3), 5, 1.5), ((6, 9), 5, 1.5),
                                            ((33, 257), 7, 2.0), ((67, 131, 2), 3, 0.8)])
def test_gaussian_blur_matches_pallas_and_op_by_op(rng, shape, ks, sigma):
    img = rng.random(shape, dtype=np.float32)
    out = kernels.fused_gaussian_blur(_t(img), ks, sigma)
    assert out.shape == img.shape and out.dtype == torch.float32
    ref = np.asarray(js.fused_gaussian_blur(jnp.asarray(img), ks, sigma, interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    # the op-by-op blur has its own taps (last bit) and the same order of sums
    np.testing.assert_allclose(out.numpy(), tops.gaussian_blur(_t(img), ks, sigma).numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jops.gaussian_blur(jnp.asarray(img), ks, sigma)), rtol=0, atol=1e-5)


def test_gaussian_blur_casts_integer_images_to_float(rng):
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    out = kernels.fused_gaussian_blur(_t(img), 5, 1.5)
    ref = np.asarray(js.fused_gaussian_blur(jnp.asarray(img), 5, 1.5, interpret=True))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)  # values up to 255


@pytest.mark.parametrize("tile", [stencil.IN_TILE, (64, 128), (16, 24), (7, 200)])
def test_in_tile_hysteresis_fixpoint_matches_xla_exactly(tile):
    # the noise image the JAX package's own test of the option uses
    img = np.random.default_rng(0).random((1, 96, 120), dtype=np.float32)
    ref = np.asarray(jops.canny(jnp.asarray(img)[..., None], 0.3, 0.6, backend="xla"))[..., 0]
    plain = kernels.canny_stage1(_t(img), 0.3, 0.6)
    cls = stencil.canny_stage1_plain(_t(img), stencil.gaussian_taps(5, 1.4), 0.3, 0.6, in_tile=tile)
    assert cls.dtype == torch.uint8 and torch.equal(cls >= 1, plain >= 1)
    assert bool(((cls == 2) >= (plain == 2)).all()) and int((cls == 2).sum()) > int((plain == 2).sum())
    edges = kernels.hysteresis_fixpoint(cls) == 2
    np.testing.assert_array_equal(edges.numpy().astype(np.float32), ref)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(jedges.hysteresis(cls.numpy() == 2, cls.numpy() >= 1)))


def test_in_tile_hysteresis_class_map_matches_pallas_at_its_tiling():
    # the Pallas kernel's tile is a 64-row band of the full width
    img = np.random.default_rng(0).random((1, 96, 120), dtype=np.float32)
    ref = np.asarray(js.canny_stage1(jnp.asarray(img), 0.3, 0.6, interpret=True, in_tile_hysteresis=True))
    cls = stencil.canny_stage1_plain(_t(img), stencil.gaussian_taps(5, 1.4), 0.3, 0.6, in_tile=(64, 120))
    np.testing.assert_array_equal(cls.numpy(), ref)


def test_in_tile_option_takes_the_kernels_tile(rng):
    maps = _t(rng.random((2, 50, 70), dtype=np.float32))
    out = kernels.canny_stage1(maps, 0.2, 0.5, in_tile_hysteresis=True)
    assert torch.equal(out, kernels.canny_stage1_in_tile(maps, 0.2, 0.5))
    assert torch.equal(out, stencil.canny_stage1_plain(maps, stencil.gaussian_taps(5, 1.4), 0.2, 0.5,
                                                       in_tile=stencil.IN_TILE))
    # a tile that holds the whole image reaches the global fixpoint at once
    whole = stencil.canny_stage1_plain(maps, stencil.gaussian_taps(5, 1.4), 0.2, 0.5, in_tile=(50, 70))
    assert torch.equal(whole, kernels.hysteresis_fixpoint(out))


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
    kernels.fused_gaussian_blur(img)
    kernels.canny_stage1(img[..., 0], 0.1, 0.2, in_tile_hysteresis=True)
    assert set(kernels.launch_counts().values()) == {0}


def test_wrappers_reject_bad_arguments():
    maps = torch.rand(1, 8, 8)
    with pytest.raises(ValueError):
        kernels.canny_stage1(maps[0], 0.1, 0.2, in_tile_hysteresis=True)
    with pytest.raises(ValueError):
        kernels.canny_stage1(maps[0], 0.1, 0.2)
    with pytest.raises(ValueError):
        kernels.fused_gaussian_blur(maps[0], 33, 1.5)
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


@pytest.mark.parametrize("ks,sigma", [(5, 1.4), (3, 0.8), (7, 2.0), (31, 6.0)])
def test_taps_are_built_once_with_their_bits(ks, sigma):
    """fused_canny's taps are get_gaussian_kernel1d's and the other wrappers' gaussian_taps', bit for bit, in the
    ctypes array the kernels take too; both are built once a (kernel_size, sigma) and cannot be written."""
    for cached, ref in ((stencil._canny_taps, tops.get_gaussian_kernel1d(ks, sigma, device="cpu").numpy()),
                        (stencil._kernel_taps, stencil.gaussian_taps(ks, sigma))):
        taps, c_taps = cached(ks, sigma)
        assert taps.dtype == ref.dtype == np.float32 and np.array_equal(taps.view(np.uint32), ref.view(np.uint32))
        assert np.array_equal(np.ctypeslib.as_array(c_taps).view(np.uint32), ref.view(np.uint32))
        assert cached(ks, sigma)[1] is c_taps and not taps.flags.writeable


@pytest.mark.parametrize("which", [0, 1])
def test_fixpoint_stops_after_a_pass_whose_last_sweep_changed_nothing(class_maps, which):
    """With N sweeps that change something, pass p's last sweep (sweep p·SWEEPS_PER_PASS) changes nothing from the
    first p with p·SWEEPS_PER_PASS > N: the fixpoint reads the flags that many times, one pass a read."""
    cls = _t(class_maps[which])
    states = [cls]
    while len(states) < 2 or not torch.equal(states[-1], states[-2]):
        states.append(stencil.hysteresis_sweeps_plain(states[-1], 1))
    changing = len(states) - 2
    kernels.reset_launch_counts()
    out = kernels.hysteresis_fixpoint(cls)
    assert torch.equal(out, states[-1])
    passes = changing // stencil.SWEEPS_PER_PASS + 1
    assert stencil.hysteresis_fixpoint.host_reads == -(-passes // stencil.PASSES_PER_CHECK)
