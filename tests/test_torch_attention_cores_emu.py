"""The attention cores' CUDA sources on the tensor cores (bf16
``csrc/tc_attention.cuh`` behind ``flash_mha``, ``attention_block`` and
``attention_block_int8``; the float32 split-TF32 core
``csrc/tf32x3_attention.cuh`` behind the same three; both at head dims 16, 64
and 80; the window core of ``csrc/swin_attention.cu``) run on the CPU through
``tools/cuda_emu``, against the wrappers' plain twins.

The emulator compiles the sources with ``g++`` against stand-in headers and
runs one thread per CUDA thread; its ``hopper.cuh`` decodes the ``wgmma``
descriptors (the 128-, 64- and 32-byte swizzles, K-major and MN-major
operands, A from registers) and defers copies and products to their waits, so
the cores' tiling, masking of keys past S and ragged query tiles are exercised
here before a card sees them.  The shapes are small and ragged: S 70 is a full
key tile and one of 6 keys (197: seven key tiles of 32, the last of 5, and
four query tiles), S 49 and 64 the two window sizes; head dims 16 and 80 take
the 32-byte-swizzled part of a bf16 tile and the half-filled panel of a
float32 one.  Tolerance: ``2e-2·(1 + |twin|)``, the bf16 kernels' rule on the
card (the core rounds the probabilities before the division by their sum, the
twin after it); float32 ``2e-4·(1 + |twin|)``, the card's float32 rule, and no
further from float64 than twice the scalar float32 core
(``_flash_mha_scalar``, emulated too).  The emulator's tf32 ``wgmma`` cuts a
chain's sum toward zero to f32 at each k8 step, as the card's tensor cores
do, so the float64 check here sees the chains' length and order as well as
the split.  Without ``g++`` the tests skip.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import flash_attention, int8_transformer

TOL = 2e-2
F32_TOL = 2e-4  # the float32 transformer kernels' rule on the card
# the share of the int8 joined heads that may round one step from the twin's, one value more whatever the size: the
# card's rule (tests/test_torch_cuda.py); bf16's core rounds the probabilities before the division by their sum (1-2%
# of the values a step apart here), float32's sums differ in order only
JOINED_FLIPS = {torch.bfloat16: 0.125, torch.float32: 1e-3}
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


@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_mha_head_dims(emulated, hd, dtype):
    """The cores at head dims 16 and 80 (ViT-H/14's) at S 70: within the rule of the twin, the same bits twice, and in
    float32 no further from float64 than twice the scalar float32 core."""
    emulate, build_dir = emulated
    rng = np.random.default_rng(hd)
    q, k, v = (_normal(rng, (1, 70, 2, hd), dtype) for _ in range(3))
    scale = hd ** -0.5
    with emulate.kernels_on_cpu(build_dir):
        before = kernels.flash_mha.launches
        out = kernels.flash_mha(q, k, v, scale)
        assert kernels.flash_mha.launches == before + 1  # the emulated kernel ran, not the twin
        assert torch.equal(kernels.flash_mha(q, k, v, scale), out)
        scalar = flash_attention._flash_mha_scalar(q.float(), k.float(), v.float(), scale)
    _assert_close(out, kernels.flash_mha_plain(q, k, v, scale), F32_TOL if dtype == torch.float32 else TOL)
    if dtype == torch.float32:
        p = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q.double(), k.double()) * scale, dim=-1)
        ref64 = torch.einsum("nhqk,nkhd->nhqd", p, v.double())

        def f64_err(a):
            return float((a.double() - ref64).abs().max() / ref64.abs().max())

        assert f64_err(out) <= 2 * f64_err(scalar), (f64_err(out), f64_err(scalar))


@pytest.mark.parametrize("hd", [16, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_block_int8_head_dims(emulated, hd, dtype):
    """The int8 block's core into int8 at head dims 16 and 80, in both dtypes (float32: the split-TF32 core with the
    int8 epilogue), 2 heads, S 70; and the joined heads themselves, the core's int8 output, against the twin's
    ``quantize_i8(o)``: every value within one int8 step, at most ``JOINED_FLIPS`` of them (and one more) a step
    apart."""
    rng = np.random.default_rng(10 + hd)
    n, s, d, heads = 1, 70, 2 * hd, 2
    a1, ao = (torch.from_numpy(rng.uniform(0.01, 0.03, d).astype(np.float32)) for _ in range(2))
    qw_qkv, s_qkv = kernels.quantize_weight(_normal(rng, (d, 3 * d), std=d ** -0.5) * a1[:, None])
    qw_o, s_o = kernels.quantize_weight(_normal(rng, (d, d), std=d ** -0.5) * ao[:, None])
    args = (_normal(rng, (n, s, d), dtype), _normal(rng, (d,), std=0.2, mean=1.0), _normal(rng, (d,), std=0.1),
            qw_qkv, s_qkv, _normal(rng, (3 * d,), std=0.1), qw_o, s_o, _normal(rng, (d,), std=0.1), a1, ao, heads,
            hd ** -0.5)
    _run(emulated, kernels.attention_block_int8, kernels.attention_block_int8_plain, args)
    emulate, build_dir = emulated
    with emulate.kernels_on_cpu(build_dir):
        joined = int8_transformer.attention_block_int8_joined(*args)
    steps = (joined.int() - int8_transformer.attention_block_int8_joined_plain(*args).int()).abs()
    assert int(steps.max()) <= 1 and int((steps > 0).sum()) <= 1 + JOINED_FLIPS[dtype] * steps.numel(), (
        int(steps.max()), int((steps > 0).sum()))


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
