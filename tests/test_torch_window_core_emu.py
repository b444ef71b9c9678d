"""The float32 ``window_attention_block`` through ``tools/cuda_emu``: its window
core (``csrc/swin_attention.cu:window_x3_kernel``, split TF32 on ``wgmma``: S =
Q K^T and P V each by halves of the 64 keys, a half's hi·hi products as two
chains of two k8 steps and its products with a lo half as a third chain (P
V's over both halves), every chain from sums set to zero in registers, one
wait a half; the softmax in the accumulator layout left unnormalised, P fed
from registers as A through the permuted keys of V^T) between the
split-TF32 products, on the CPU, against the wrapper's plain twin and the
block in float64.

The emulator compiles the source with ``g++`` against stand-in headers, runs
one thread per CUDA thread, reads tf32 operands with their 13 low mantissa
bits dropped, defers copies and products to their waits and poisons shared
memory with NaN.  Windows of S 1, 16, 49 and 64 tokens (the keys past S
masked in the one 64-key tile), v1 and v2, masked and unmasked, a zero-padded
channel layout (``ln_count``), and the two spread cases that the card's checks
hold: v2 at logit scale 100 (a head's logits over +-100) and v1 with the
heads' position bias offset by -150 and +120.  Each is held as on the card:
within ``2e-4·(1 + |twin|)`` of the twin, no further from the float64 block
than twice the twin (TF32 off), and the same bits from a second call.  The
scalar core it replaced must be gone from the source.  Without ``g++`` the
tests skip.
"""

import importlib.util
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import swin_attention

_REPO = Path(__file__).resolve().parents[1]
_EMULATE = _REPO / "tools" / "cuda_emu" / "emulate.py"
STEMS = ("swin_attention",)
TOL = 2e-4


@pytest.fixture(autouse=True)
def _launch_counts_at_zero_after():
    """The emulated kernels count their launches; later tests in this process expect CPU tensors to have launched
    nothing."""
    yield
    kernels.reset_launch_counts()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulator module with the window attention source built into a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the CUDA emulation needs a C++20 compiler")
    spec = importlib.util.spec_from_file_location("cuda_emulate", _EMULATE)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    build_dir = tmp_path_factory.mktemp("cuda_emu")
    emulate.build(build_dir, STEMS)
    return emulate, build_dir


def _normal(rng, shape, std=1.0, mean=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32))


def _args(s, v2, masked, ln_count=0, spread=False, nw=4, c=64):
    """window_attention_block's arguments: nw windows of s tokens, C c (heads of 32), 2 images of nw / 2 windows."""
    rng = np.random.default_rng(100 * s + 10 * v2 + 2 * masked + bool(ln_count) + 5 * spread)
    heads, nw_img = c // 32, nw // 2
    rel_bias = _normal(rng, (heads, s, s), std=0.3)
    logit_scale = _normal(rng, (heads,), std=0.5, mean=2.3) if v2 else None
    if spread:  # per-head logits spread over +-100 (v2) or offset by -150 and 120 (v1), as the card's checks
        if v2:
            logit_scale = torch.tensor([100.0, 0.01, 1.0][:heads])
            rel_bias = torch.zeros_like(rel_bias)
        else:
            rel_bias = rel_bias + torch.tensor([0.0, -150.0, 120.0][:heads])[:, None, None]
    mask = torch.from_numpy((rng.random((nw_img, s, s)) > 0.6).astype(np.float32) * -100.0) if masked else None
    args = [_normal(rng, (nw, s, c)), _normal(rng, (c,), std=0.2, mean=1.0), _normal(rng, (c,), std=0.1),
            _normal(rng, (c, 3 * c), std=c ** -0.5), _normal(rng, (3 * c,), std=0.1), _normal(rng, (c, c), std=c ** -0.5),
            _normal(rng, (c,), std=0.1), rel_bias, mask, logit_scale, heads, 32 ** -0.5, 1e-5, v2, nw_img, ln_count]
    if ln_count:  # a zero-padded channel layout: the real channels first
        for i in (0, 1, 2, 6):
            args[i][..., ln_count:] = 0
        args[3][ln_count:] = 0
        args[5][:, ln_count:] = 0
    return args


def _far(a, ref64):
    return float((a.double() - ref64).abs().max() / ref64.abs().max())


# (S, v2, masked, ln_count, spread, C)
CASES = {
    "s1_v1": (1, False, False, 0, False, 64),
    "s1_v2_masked": (1, True, True, 0, False, 64),
    "s16_v1_masked": (16, False, True, 0, False, 64),
    "s16_v2": (16, True, False, 0, False, 64),
    "s49_v1_masked": (49, False, True, 0, False, 64),
    "s49_v1": (49, False, False, 0, False, 64),
    "s49_v2_masked": (49, True, True, 0, False, 64),
    "s49_ln_count": (49, False, True, 48, False, 64),
    "s64_v1_masked": (64, False, True, 0, False, 64),
    "s64_v2": (64, True, False, 0, False, 64),
    "spread_v2_logit_scale_100": (64, True, False, 0, True, 96),
    "spread_v1_bias_offsets": (49, False, False, 0, True, 96),
}


@pytest.mark.parametrize("case", list(CASES))
def test_window_attention_block_float32(emulated, case):
    s, v2, masked, ln_count, spread, c = CASES[case]
    args = _args(s, v2, masked, ln_count, spread, c=c)
    emulate, build_dir = emulated
    with emulate.kernels_on_cpu(build_dir, STEMS):
        before, chain = kernels.window_attention_block.launches, kernels.window_attention_block.kernel_launches
        out = kernels.window_attention_block(*args)
        again = kernels.window_attention_block(*args)
        assert kernels.window_attention_block.launches == before + 2  # the emulated kernels ran, not the twin
        assert kernels.window_attention_block.kernel_launches == chain + 8
    twin = kernels.window_attention_block_plain(*args)
    assert out.shape == twin.shape and out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    err = (out - twin).abs()
    assert bool((err <= TOL + TOL * twin.abs()).all()), f"max |err| {float(err.max())}"
    ref64 = swin_attention._window_attention_block_f64(*args)
    assert _far(out, ref64) <= 2 * _far(twin, ref64), (_far(out, ref64), _far(twin, ref64))
    assert torch.equal(out, again)


def test_scalar_window_core_is_gone():
    source = (_REPO / "cpu_vision_tpu_torch" / "csrc" / "swin_attention.cu").read_text()
    assert re.search(r"\bwindow_core_kernel\b", source) is None
    assert "window_x3_kernel<<<" in source


@pytest.mark.parametrize("nw,s,c,ln_count", [(6, 49, 96, 0), (3, 49, 128, 96), (2, 64, 64, 0)],
                         ids=["c96_ragged_tiles", "c128_ln_count", "s64"])
def test_bf16_v2_qk_rows_are_the_twins_bits(emulated, nw, s, c, ln_count):
    """The q and k columns of the bf16 v2 block's QKV rows (``qkv_f64_kernel``: float64 sums rounded to float32
    once, then the bias) equal the twin's (``swin_attention._qkv_rows``) bit for bit, with rows and columns off the
    kernel's 128 x 64 tiles; its v columns (``tc_gemm_kernel``, float32 sums in another order) stand within
    1e-5·(1 + |twin|), and the rest of the block within the bf16 rule (2e-2·(1 + |twin|)) of the twin."""
    args = _args(s, True, True, ln_count, nw=nw, c=c)
    for i in (0, 3, 5):
        args[i] = args[i].to(torch.bfloat16)
    args[4][c:2 * c] = 0  # the key bias, zeroed as the model zeroes it
    x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale = args[:10]
    tokens = nw * s
    qkv = torch.full((tokens, 3 * c), float("nan"))
    joined, out = torch.empty_like(x), torch.empty_like(x)
    branch = torch.empty((tokens, c))
    emulate, build_dir = emulated
    with emulate.kernels_on_cpu(build_dir, STEMS):
        err = swin_attention._lib().cvt_window_attention_block(
            x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), w_o.data_ptr(),
            b_o.data_ptr(), rel_bias.data_ptr(), mask.data_ptr(), logit_scale.data_ptr(), qkv.data_ptr(),
            joined.data_ptr(), branch.data_ptr(), None, out.data_ptr(), nw, s, c, c // 32, nw // 2, 32 ** -0.5, 1e-5,
            1, ln_count, 1, None)
    assert err == 0
    rows = swin_attention._qkv_rows(x.reshape(tokens, c), w_qkv, b_qkv, True)
    assert torch.equal(qkv[:, :2 * c], rows[:, :2 * c])
    assert bool(((qkv[:, 2 * c:] - rows[:, 2 * c:]).abs() <= 1e-5 * (1 + rows[:, 2 * c:].abs())).all())
    twin = kernels.window_attention_block_plain(*args)
    diff = (out.float() - twin.float()).abs()
    assert bool((diff <= 2e-2 * (1 + twin.float().abs())).all()), float(diff.max())
