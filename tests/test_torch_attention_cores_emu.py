"""The attention cores' CUDA sources on the tensor cores (bf16
``csrc/tc_attention.cuh`` behind ``flash_mha``, ``attention_block`` and
``attention_block_int8``; the float32 split-TF32 core
``csrc/tf32x3_attention.cuh`` behind ``flash_mha`` and ``attention_block``;
the window core of ``csrc/swin_attention.cu``) run on the CPU through
``tools/cuda_emu``, against the wrappers' plain twins.

The emulator compiles the sources with ``g++`` against stand-in headers and
runs one thread per CUDA thread; its ``hopper.cuh`` decodes the ``wgmma``
descriptors (the 128- and 64-byte swizzles, K-major and MN-major operands, A
from registers) and defers copies and products to their waits, so the cores'
tiling, masking of keys past S and ragged query tiles are exercised here
before a card sees them.  The shapes are small and ragged: S 70 is a full key
tile and one of 6 keys (197: seven key tiles of 32, the last of 5, and four
query tiles), S 49 and 64 the two window sizes.  Tolerance:
``2e-2·(1 + |twin|)``, the bf16 kernels' rule on the card (the core rounds
the probabilities before the division by their sum, the twin after it);
float32 ``2e-4·(1 + |twin|)``, the card's float32 rule, and no further from
float64 than twice the scalar float32 core (``_flash_mha_scalar``, emulated
too).  The emulator sums a product's terms in order in float32, not as the
tensor cores do, so the float64 check here tests the split, not the card's
sums: ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold those.
Without ``g++`` the tests skip.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import flash_attention

TOL = 2e-2
F32_TOL = 2e-4  # the float32 transformer kernels' rule on the card
_EMULATE = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"


@pytest.fixture(autouse=True)
def _launch_counts_at_zero_after():
    """The emulated kernels count their launches; later tests in this process expect CPU tensors to have launched
    nothing."""
    yield
    kernels.reset_launch_counts()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulator module with its libraries built into a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the CUDA emulation needs a C++20 compiler")
    spec = importlib.util.spec_from_file_location("cuda_emulate", _EMULATE)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    build_dir = tmp_path_factory.mktemp("cuda_emu")
    emulate.build(build_dir)
    return emulate, build_dir


def _normal(rng, shape, dtype=torch.float32, std=1.0, mean=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32)).to(dtype)


def _assert_close(out, ref, tol=TOL):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs()
    assert bool((err <= tol + tol * ref.float().abs()).all()), f"max |err| {float(err.max())}"


def _run(emulated, fn, twin, args):
    emulate, build_dir = emulated
    with emulate.kernels_on_cpu(build_dir):
        before = fn.launches
        out = fn(*args)
        assert fn.launches == before + 1  # the emulated kernel ran, not the twin
    _assert_close(out, twin(*args))


def test_flash_mha(emulated):
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, (1, 70, 2, 64), torch.bfloat16) for _ in range(3))
    _run(emulated, kernels.flash_mha, kernels.flash_mha_plain, (q, k, v, 0.125))


@pytest.mark.parametrize("s", [70, 197])
def test_flash_mha_float32(emulated, s):
    """The float32 core at head dim 64 (split TF32, ``csrc/tf32x3_attention.cuh``): within the float32 rule of the
    twin, and no further from float64 than twice the scalar float32 core it replaced."""
    emulate, build_dir = emulated
    rng = np.random.default_rng(s)
    q, k, v = (_normal(rng, (1, s, 2, 64)) for _ in range(3))
    with emulate.kernels_on_cpu(build_dir):
        before = kernels.flash_mha.launches
        out = kernels.flash_mha(q, k, v, 0.125)
        assert kernels.flash_mha.launches == before + 1  # the emulated kernel ran, not the twin
        scalar = flash_attention._flash_mha_scalar(q, k, v, 0.125)
        assert torch.equal(kernels.flash_mha(q, k, v, 0.125), out)
    _assert_close(out, kernels.flash_mha_plain(q, k, v, 0.125), F32_TOL)
    p = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q.double(), k.double()) * 0.125, dim=-1)
    ref64 = torch.einsum("nhqk,nkhd->nhqd", p, v.double())

    def f64_err(a):
        return float((a.double() - ref64).abs().max() / ref64.abs().max())

    assert f64_err(out) <= 2 * f64_err(scalar), (f64_err(out), f64_err(scalar))


def test_attention_block(emulated):
    rng = np.random.default_rng(1)
    n, s, d, heads = 1, 70, 128, 2
    args = (_normal(rng, (n, s, d), torch.bfloat16), _normal(rng, (d,), std=0.2, mean=1.0), _normal(rng, (d,), std=0.1),
            _normal(rng, (d, 3 * d), torch.bfloat16, d ** -0.5), _normal(rng, (3 * d,), std=0.1),
            _normal(rng, (d, d), torch.bfloat16, d ** -0.5), _normal(rng, (d,), std=0.1), heads, 0.125)
    _run(emulated, kernels.attention_block, kernels.attention_block_plain, args)


def test_attention_block_int8(emulated):
    rng = np.random.default_rng(2)
    n, s, d, heads = 2, 33, 64, 1  # the smallest D the kernels take at head dim 64
    a1, ao = (torch.from_numpy(rng.uniform(0.01, 0.03, d).astype(np.float32)) for _ in range(2))
    qw_qkv, s_qkv = kernels.quantize_weight(_normal(rng, (d, 3 * d), std=d ** -0.5) * a1[:, None])
    qw_o, s_o = kernels.quantize_weight(_normal(rng, (d, d), std=d ** -0.5) * ao[:, None])
    args = (_normal(rng, (n, s, d), torch.bfloat16), _normal(rng, (d,), std=0.2, mean=1.0), _normal(rng, (d,), std=0.1),
            qw_qkv, s_qkv, _normal(rng, (3 * d,), std=0.1), qw_o, s_o, _normal(rng, (d,), std=0.1), a1, ao, heads, 0.125)
    _run(emulated, kernels.attention_block_int8, kernels.attention_block_int8_plain, args)


@pytest.mark.parametrize("nw,s,c,heads,v2,masked", [(4, 49, 64, 2, False, True), (2, 64, 64, 2, True, False),
                                                    (10, 49, 64, 2, False, True)],
                         ids=["v1_masked", "v2", "v1_masked_three_blocks"])  # 20 pairs: blocks of 8, 8 and 4
def test_window_attention_block(emulated, nw, s, c, heads, v2, masked):
    rng = np.random.default_rng(3)
    nw_img = 2 if masked else 1
    mask = torch.from_numpy((rng.random((nw_img, s, s)) > 0.5).astype(np.float32) * -100.0) if masked else None
    args = (_normal(rng, (nw, s, c), torch.bfloat16), _normal(rng, (c,), std=0.2, mean=1.0), _normal(rng, (c,), std=0.1),
            _normal(rng, (c, 3 * c), torch.bfloat16, c ** -0.5), _normal(rng, (3 * c,), std=0.1),
            _normal(rng, (c, c), torch.bfloat16, c ** -0.5), _normal(rng, (c,), std=0.1),
            _normal(rng, (heads, s, s), std=0.3), mask,
            torch.tensor([4.7, -1.0]) if v2 else None, heads, 32 ** -0.5, 1e-5, v2, nw_img)
    _run(emulated, kernels.window_attention_block, kernels.window_attention_block_plain, args)
