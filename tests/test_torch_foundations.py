"""The port's foundations (``_dtype``, ``_layout``, grayscale) against the
JAX package, on the same numpy inputs; and the port's import hygiene."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu import _dtype as jd, _layout as jl
from cpu_vision_tpu.ops import color as jc
from cpu_vision_tpu_torch import _dtype as td, _layout as tl
from cpu_vision_tpu_torch.ops import color as tc

DTYPES = [np.uint8, np.int8, np.int16, np.int32, np.int64, np.float32, np.float16]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dtype_queries_match_jax(dtype):
    tdt = _t(np.zeros(1, dtype)).dtype
    assert td.max_value(tdt) == jd.max_value(dtype)
    assert td.max_value(dtype) == jd.max_value(dtype)
    assert td.is_integer_dtype(tdt) == jd.is_integer_dtype(dtype)
    assert _t(np.zeros(1, jd.compute_dtype(dtype))).dtype == td.compute_dtype(tdt)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_cast_to_float_and_back_match_jax(rng, dtype):
    x = (rng.random((5, 7, 3)) * 300 - 20).astype(np.float32)
    src = x.astype(dtype)
    jf, jorig = jd.cast_to_float(jnp.asarray(src))
    tf, torig = td.cast_to_float(_t(src))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    assert torig == _t(src).dtype
    # round half to even, clip, cast
    vals = np.array([-3.5, -0.5, 0.5, 1.5, 2.5, 254.5, 255.5, 300.0, 77.49], np.float32)
    np.testing.assert_array_equal(_np(td.cast_back(_t(vals), torig)), np.asarray(jd.cast_back(jnp.asarray(vals), jorig)))


def test_float_kernel_casts_back_like_jax(rng):
    src = rng.integers(0, 256, (6, 5, 3)).astype(np.uint8)
    jfn = jd.float_kernel(lambda x, a: (x * a + 0.3, x - 40.0))
    tfn = td.float_kernel(lambda x, a: (x * a + 0.3, x - 40.0))
    for j, t in zip(jfn(jnp.asarray(src), 1.37), tfn(_t(src), 1.37)):
        assert t.dtype == torch.uint8
        np.testing.assert_array_equal(_np(t), np.asarray(j))


@pytest.mark.parametrize(
    "src,dst,scale",
    [
        (np.uint8, np.float32, True),
        (np.float32, np.uint8, True),
        (np.float32, np.int16, True),
        (np.uint8, np.int32, True),
        (np.int32, np.uint8, True),
        (np.int16, np.uint8, True),
        (np.uint8, np.int16, True),
        (np.float32, np.float16, True),
        (np.float32, np.uint8, False),
        (np.uint8, np.float32, False),
        (np.uint8, np.uint8, True),
    ],
)
def test_to_dtype_matches_jax(rng, src, dst, scale):
    if np.issubdtype(src, np.floating):
        x = rng.random((4, 6, 3)).astype(src)
        if not scale:
            x = (x * 300).astype(src)
    else:
        x = rng.integers(0, np.iinfo(src).max, (4, 6, 3), endpoint=True).astype(src)
    out = td.to_dtype(_t(x), dst, scale=scale)
    ref = np.asarray(jd.to_dtype(jnp.asarray(x), dst, scale=scale))
    assert out.dtype == _t(ref).dtype
    np.testing.assert_array_equal(_np(out), ref)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (2, 5, 7, 1), (3, 4, 1)])
def test_layout_matches_jax(shape):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    jn, jr = jl.ensure_nhwc(jnp.asarray(x))
    tn, tr = tl.ensure_nhwc(_t(x))
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    np.testing.assert_array_equal(_np(tr(tn)), x)
    assert tl.num_channels(_t(x)) == jl.num_channels(jnp.asarray(x))
    assert tuple(tl.spatial_size(_t(x))) == tuple(jl.spatial_size(jnp.asarray(x)))


def test_layout_rejects_other_ranks():
    with pytest.raises(ValueError):
        tl.ensure_nhwc(torch.zeros(5))
    with pytest.raises(ValueError):
        tl.ensure_nhwc(torch.zeros(1, 2, 3, 4, 5))


def test_numpy_input_goes_to_the_card():
    x = np.zeros((3, 4), np.float32)
    if torch.cuda.is_available():
        assert tl.as_tensor(x).device.type == "cuda"
    else:
        # no silent CPU fallback: asking for the card without one fails
        with pytest.raises((AssertionError, RuntimeError)):
            tl.as_tensor(x)
    t = torch.zeros(3, 4)
    assert tl.as_tensor(t) is t


@pytest.mark.parametrize("shape,dtype", [((6, 7, 3), np.uint8), ((2, 6, 7, 3), np.float32), ((6, 7, 3), np.float32)])
@pytest.mark.parametrize("n_out", [1, 3])
def test_rgb_to_grayscale_matches_jax(rng, shape, dtype, n_out):
    x = rng.random(shape).astype(np.float32)
    if dtype == np.uint8:
        x = (x * 255).astype(np.uint8)
    ref = np.asarray(jc.rgb_to_grayscale(jnp.asarray(x), n_out))
    out = tc.rgb_to_grayscale(_t(x), n_out)
    assert out.dtype == _t(ref).dtype
    np.testing.assert_array_equal(_np(out), ref)


@pytest.mark.parametrize("shape", [(6, 7), (6, 7, 1), (2, 6, 7, 1)])
def test_single_channel_grayscale_passes_through(rng, shape):
    x = rng.integers(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(_np(tc.rgb_to_grayscale(_t(x))), np.asarray(jc.rgb_to_grayscale(jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(6, 7), (6, 7, 1), (6, 7, 3)])
def test_grayscale_to_rgb_matches_jax(rng, shape):
    x = rng.random(shape).astype(np.float32)
    np.testing.assert_array_equal(_np(tc.grayscale_to_rgb(_t(x))), np.asarray(jc.grayscale_to_rgb(jnp.asarray(x))))


@pytest.mark.parametrize("start,stop,num", [(-3.0, 3.0, 7), (-2.0, 2.0, 5), (-47.5, 47.5, 96), (-319.5, 319.5, 640),
                                            (0.5, 479.5, 480), (0.5, 12.5, 13), (1.5, 1.5, 1), (0.0, 1.0, 2)])
def test_linspace_f32_is_jnp_linspace(start, stop, num):
    from cpu_vision_tpu_torch.ops.filters import linspace_f32

    out = linspace_f32(start, stop, num)
    assert out.dtype == np.float32
    with jax.disable_jit():  # op by op: every product and sum rounded on its own, as in the port
        np.testing.assert_array_equal(out, np.asarray(jnp.linspace(start, stop, num, dtype=jnp.float32)))
    # compiled, XLA contracts products into sums: a last bit of the larger end point
    np.testing.assert_allclose(out, np.asarray(jnp.linspace(start, stop, num, dtype=jnp.float32)),
                               rtol=0, atol=2.4e-7 * max(abs(start), abs(stop)))


def test_full_float32_sets_and_restores_the_tf32_switches():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with td.full_float32():
            assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32 == before[1]
        with pytest.raises(KeyError), td.full_float32():
            raise KeyError("restored after an error too")
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]


def test_port_imports_no_jax():
    code = (
        "import sys, cpu_vision_tpu_torch, cpu_vision_tpu_torch.ops.kernels\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cpu_vision_tpu.'))"
        " or m == 'cpu_vision_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
