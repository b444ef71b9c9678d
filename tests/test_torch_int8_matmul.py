"""The port's int8 requantising product (``ops/kernels/int8_matmul.py``) against
the JAX package's Pallas kernel (``ops/pallas/int8_matmul.py``, interpret mode)
on the CPU, where the wrapper runs its plain twin.

The same int8 operands and float32 scales, made from a seed with numpy, go to
both.  The products are exact on both sides; the float32 epilogue is the same
operations in the same order, so float32 outputs agree within the JAX test's
own rule (rtol 1e-6, atol 1e-4) and int8 outputs within 1 LSB on under 1% of
the entries (the JAX test's rule: XLA contracts FMAs in interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops.pallas.int8_matmul import int8_matmul_requant as jax_requant
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import int8_matmul as tmm


def _operands(rng, m, k, n, bias_range=1.0):
    qx = rng.integers(-127, 128, (m, k)).astype(np.int8)
    qw = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    bias = rng.uniform(-bias_range, bias_range, n).astype(np.float32)
    return qx, qw, scale, bias


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("m,k,n", [(256, 64, 128), (300, 96, 200), (32, 2048, 1000)])
@pytest.mark.parametrize("relu", [False, True])
def test_f32_output_matches_jax(rng, m, k, n, relu):
    qx, qw, scale, bias = _operands(rng, m, k, n)
    ref = np.asarray(jax_requant(*map(jnp.asarray, (qx, qw, scale, bias)), relu=relu, interpret=True))
    got = kernels.int8_matmul_requant(*_torch(qx, qw, scale, bias), relu=relu)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(256, 64, 128), (300, 96, 200), (32, 2048, 1000)])
@pytest.mark.parametrize("relu", [False, True])
def test_int8_output_matches_jax(rng, m, k, n, relu):
    qx, qw, scale, bias = _operands(rng, m, k, n, 0.5)
    out_scale = np.float32(0.05 * np.sqrt(k / 128))
    ref = np.asarray(jax_requant(*map(jnp.asarray, (qx, qw, scale, bias)), out_scale=jnp.float32(out_scale),
                                 relu=relu, interpret=True))
    got = kernels.int8_matmul_requant(*_torch(qx, qw, scale, bias), out_scale=torch.tensor(out_scale), relu=relu)
    assert got.dtype == torch.int8 and ref.dtype == np.int8
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert (diff <= 1).all() and (diff > 0).mean() < 0.01
    # the saturation is exercised: some entries sit at the clamp
    assert (np.abs(ref) == 127).any() and (np.abs(ref) < 127).any()


def test_twin_is_the_exact_formula(rng):
    """int32 sums, then ``acc * scale + bias``, ReLU, ``rint(f * (1 / s))``
    and the clamp, one float32 operation at a time, in numpy."""
    qx, qw, scale, bias = _operands(rng, 300, 96, 200, 0.5)
    out_scale = np.float32(0.05)
    acc = qx.astype(np.int64) @ qw.astype(np.int64)
    f = np.maximum(acc.astype(np.float32) * scale + bias, np.float32(0))
    inv = np.float32(1) / out_scale
    want = np.clip(np.rint(f * inv), -127, 127).astype(np.int8)
    got = kernels.int8_matmul_requant(*_torch(qx, qw, scale, bias), out_scale=torch.tensor(out_scale), relu=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int_mm_is_exact_at_the_largest_sums(rng):
    a = np.full((20, 4608), -127, np.int8)
    b = np.full((4608, 24), -127, np.int8)
    b[:, 1] = 127
    got = tmm.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert int(got[0, 0]) == 4608 * 127 * 127 and int(got[0, 1]) == -4608 * 127 * 127


def test_refuses_bad_arguments(rng):
    qx, qw, scale, bias = _torch(*_operands(rng, 8, 32, 16))
    with pytest.raises(TypeError):
        kernels.int8_matmul_requant(qx.float(), qw, scale, bias)
    with pytest.raises(ValueError):
        kernels.int8_matmul_requant(qx, qw[:16], scale, bias)
    with pytest.raises(ValueError):
        kernels.int8_matmul_requant(qx, qw, scale[:8], bias)
    assert tmm.kernel_takes(32) and tmm.kernel_takes(2048) and not tmm.kernel_takes(24) and not tmm.kernel_takes(8)
    assert kernels.int8_matmul_requant.launches == 0


def test_recording_sees_launches_only(rng):
    """``recording`` lists the kernel's launches: the twin that a CPU tensor takes is none."""
    qx, qw, scale, bias = _torch(*_operands(rng, 8, 32, 16))
    with tmm.recording() as calls:
        kernels.int8_matmul_requant(qx, qw, scale, bias)
    assert calls == [] and tmm._recorders == []
