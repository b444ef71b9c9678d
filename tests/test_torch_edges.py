"""The port's ``ops.edges`` (Canny, Harris) against the JAX package's, on the
same numpy inputs, plus the goldens.

The port runs on CPU tensors here: ``canny`` takes its op-by-op path by
default and the fused kernels' plain twins with ``backend="kernel"``.  Both
are held against JAX ``canny(backend="xla")`` under the JAX tests' rules:
exact on noise, and on a step image with analytically tied magnitudes a
mismatch under 2% that lies next to reference edges.  ``test_torch_cuda.py``
runs the kernels on the card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu import ops as jops
from cpu_vision_tpu_torch import ops as tops

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "expect", "golden_kernels.npz"))
BACKENDS = ["plain", "kernel"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _step():
    img = np.full((64, 80), 0.1, np.float32)
    img[20:44, 24:60] = 0.9
    return img


def _assert_tie_confined(out, ref):
    mismatch = out != ref
    assert mismatch.mean() < 0.02, f"mismatch fraction {mismatch.mean()}"
    ref_dil = np.zeros_like(ref, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ref_dil |= np.roll(np.roll(ref > 0, dy, 0), dx, 1)
    assert (mismatch <= ref_dil).all(), "mismatch away from reference edges"
    assert abs(ref.sum() - out.sum()) / max(ref.sum(), 1) < 0.05


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape,low,high", [((56, 72), 0.3, 0.6), ((64, 96), 0.1, 0.2), ((2, 40, 50, 1), 0.1, 0.2)])
def test_canny_matches_xla_on_noise(rng, backend, shape, low, high):
    img = rng.random(shape, dtype=np.float32)
    ref = np.asarray(jops.canny(jnp.asarray(img), low, high, backend="xla"))
    out = tops.canny(_t(img), low, high, backend=backend)
    assert out.dtype == torch.float32 and out.shape == img.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_canny_on_tied_step(backend):
    img = _step()
    ref = np.asarray(jops.canny(jnp.asarray(img), 0.1, 0.3, backend="xla"))
    _assert_tie_confined(tops.canny(_t(img), 0.1, 0.3, backend=backend).numpy(), ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_golden_canny(backend):
    out = tops.canny(_t(GOLDEN["input_f32"]), 0.08, 0.2, backend=backend).numpy()
    np.testing.assert_array_equal(out, GOLDEN["canny"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_canny_uint8_rgb(backend):
    # cast to float first, then float grayscale: thresholds on 0..255 scale
    out = tops.canny(_t(GOLDEN["input_u8"]), 20.0, 60.0, backend=backend).numpy()
    np.testing.assert_array_equal(out, np.asarray(jops.canny(jnp.asarray(GOLDEN["input_u8"]), 20.0, 60.0, backend="xla")))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("max_iters", [0, 1, 3])
def test_canny_bounded_hysteresis(rng, backend, max_iters):
    img = rng.random((48, 60), dtype=np.float32)
    ref = np.asarray(jops.canny(jnp.asarray(img), 0.05, 0.3, max_hysteresis_iters=max_iters, backend="xla"))
    out = tops.canny(_t(img), 0.05, 0.3, max_hysteresis_iters=max_iters, backend=backend).numpy()
    np.testing.assert_array_equal(out, ref)


def test_canny_without_hysteresis(rng):
    img = rng.random((40, 44), dtype=np.float32)
    ref = np.asarray(jops.canny(jnp.asarray(img), 0.1, 0.3, use_hysteresis=False, backend="xla"))
    for backend in BACKENDS:
        np.testing.assert_array_equal(tops.canny(_t(img), 0.1, 0.3, use_hysteresis=False, backend=backend).numpy(), ref)


def test_canny_rejects_unknown_backend():
    with pytest.raises(ValueError):
        tops.canny(torch.zeros(8, 8), backend="pallas")


def test_canny_nms_matches_jax(rng):
    mag = rng.random((2, 30, 34), dtype=np.float32)
    gx = rng.standard_normal((2, 30, 34)).astype(np.float32)
    gy = rng.standard_normal((2, 30, 34)).astype(np.float32)
    ref = np.asarray(jops.canny_nms(jnp.asarray(mag), jnp.asarray(gx), jnp.asarray(gy)))
    np.testing.assert_array_equal(tops.canny_nms(_t(mag), _t(gx), _t(gy)).numpy(), ref)


@pytest.mark.parametrize("max_iters,steps", [(None, 1), (None, 2), (2, 1), (5, 2)])
def test_hysteresis_matches_jax(rng, max_iters, steps):
    r = rng.random((2, 40, 50))
    strong, weak = r > 0.97, r > 0.5
    ref = np.asarray(jops.hysteresis(jnp.asarray(strong), jnp.asarray(weak), max_iters, steps))
    np.testing.assert_array_equal(tops.hysteresis(_t(strong), _t(weak), max_iters, steps).numpy(), ref)


def test_golden_harris_f32():
    np.testing.assert_allclose(tops.harris_response(_t(GOLDEN["input_f32"])).numpy(), GOLDEN["harris_f32"], atol=1e-6)


@pytest.mark.parametrize("window", ["gaussian", "box"])
@pytest.mark.parametrize("shape", [(33, 41), (2, 20, 24, 3)])
def test_harris_response_matches_jax(rng, window, shape):
    img = rng.random(shape, dtype=np.float32)
    ref = np.asarray(jops.harris_response(jnp.asarray(img), window_size=5, sigma=1.2, window=window))
    out = tops.harris_response(_t(img), window_size=5, sigma=1.2, window=window).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_harris_response_rejects_unknown_window():
    with pytest.raises(ValueError):
        tops.harris_response(torch.zeros(8, 8), window="hann")


@pytest.mark.parametrize("shape", [(48, 64), (40, 50, 3)])
def test_harris_corners_match_jax_as_sets(rng, shape):
    # random images give distinct scores; top-k may order ties differently,
    # so compare the selected (row, col, score) as sets
    img = rng.random(shape, dtype=np.float32)
    jc, js, jv = (np.asarray(a) for a in jops.harris(jnp.asarray(img), max_corners=30))
    tc, ts, tv = (a.numpy() for a in tops.harris(_t(img), max_corners=30))
    np.testing.assert_array_equal(tv, jv)
    assert {tuple(c) for c in tc[tv]} == {tuple(c) for c in jc[jv]}
    order_t, order_j = np.lexsort(tc[tv].T), np.lexsort(jc[jv].T)
    np.testing.assert_allclose(ts[tv][order_t], js[jv][order_j], atol=1e-6)
