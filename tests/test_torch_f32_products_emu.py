"""The split-TF32 products' CUDA sources (``csrc/tf32x3.cuh`` behind the float32
``mlp_block``, ``cn_mlp_block``, ``attention_block``, ``window_attention_block`` and
``wgrad_matmul``) and the bfloat16 weight gradient on ``wgmma``
(``csrc/wgrad_matmul.cu``) run on the CPU through ``tools/cuda_emu``, against the
wrappers' plain twins.

The emulator compiles the sources with ``g++`` against stand-in headers and
runs one thread per CUDA thread; its ``hopper.cuh`` reads tf32 operands K-major
with their 13 low mantissa bits dropped, as the hardware does (so a hi half not
rounded before it is stored shows), rounds as ``cvt.rna``, reads the bf16
operands of the weight gradient MN-major through both transpose flags, and
defers copies and products to their waits.  The shapes are small and ragged: M
not a multiple of a stage (32 rows in float32, 64 in bfloat16) and cut into
several slabs, Cin and Cout off the tile (64 or 128) and off a multiple of 8
(the wrapper's zero columns), token counts off the 128-row tile, D 96 under a
128-column tile.  Tolerances are the card's (``chip_smoke.py``):
``1e-5·max|twin|`` for the weight gradient, ``2e-4·(1 + |twin|)`` for the MLP and
attention blocks; the attention blocks also stand no further from their float64
statement than twice the twin.  Without ``g++`` the tests skip.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import swin_attention, transformer_block
from cpu_vision_tpu_torch.ops.kernels.wgrad_matmul import slab_rows

WGRAD_TOL = 1e-5
TOL = 2e-4
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


def _run(emulated, fn, args, kernel_launches=None):
    emulate, build_dir = emulated
    with emulate.kernels_on_cpu(build_dir):
        before = fn.launches
        chain = getattr(fn, "kernel_launches", 0)
        out = fn(*args)
        assert fn.launches == before + 1  # the emulated kernels ran, not the twin
        if kernel_launches is not None:
            assert fn.kernel_launches == chain + kernel_launches
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("m,cin,cout", [(1000, 70, 65), (300, 3, 5), (700, 64, 64), (200, 130, 72)],
                         ids=["slabs_ragged", "padded_columns", "one_tile", "two_by_two_tiles"])
def test_wgrad_matmul(emulated, m, cin, cout, dtype):
    rng = np.random.default_rng(m + cin)
    x, dy = _normal(rng, (m, cin), dtype), _normal(rng, (m, cout), dtype)
    slabs = -(-m // slab_rows(m, cin, cout, 132))
    if m in (1000, 700):
        assert slabs > 1 and m % 32  # several slabs, the last one ragged
    out = _run(emulated, kernels.wgrad_matmul, (x, dy))
    twin = kernels.wgrad_matmul_plain(x, dy)
    assert out.shape == (cin, cout) and out.dtype == torch.float32
    err = float((out - twin).abs().max())
    assert err <= WGRAD_TOL * float(twin.abs().max()), err


def _mlp_args(rng, m, d, dh):
    return (_normal(rng, (m, d)), _normal(rng, (d,), std=0.2, mean=1.0), _normal(rng, (d,), std=0.1),
            _normal(rng, (d, dh), std=d ** -0.5), _normal(rng, (dh,), std=0.1), _normal(rng, (dh, d), std=dh ** -0.5),
            _normal(rng, (d,), std=0.1))


def _assert_close(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out - ref).abs()
    assert bool((err <= TOL + TOL * ref.abs()).all()), f"max |err| {float(err.max())}"


@pytest.mark.parametrize("m,d,dh,post_norm,ln_count", [(41, 96, 384, False, 0), (41, 96, 384, True, 0),
                                                      (41, 96, 384, False, 80), (41, 96, 384, True, 80),
                                                      (150, 256, 512, False, 0)],
                         ids=["d96", "post_norm", "ln_count", "post_norm_ln_count", "two_row_tiles"])
def test_mlp_block_float32(emulated, m, d, dh, post_norm, ln_count):
    rng = np.random.default_rng(d + m)
    args = (*_mlp_args(rng, m, d, dh), 1e-5, post_norm, ln_count)
    out = _run(emulated, kernels.mlp_block, args, kernel_launches=3)
    _assert_close(out, kernels.mlp_block_plain(*args))


def test_cn_mlp_block_float32(emulated):
    rng = np.random.default_rng(7)
    m, d, dh = 45, 96, 384
    y, ln_g, ln_b, w1, b1, w2, b2 = _mlp_args(rng, m, d, dh)
    args = (y, _normal(rng, (m, d)), ln_g, ln_b, w1, b1, w2, b2, _normal(rng, (d,), std=0.5), 1e-6)
    out = _run(emulated, kernels.cn_mlp_block, args, kernel_launches=3)
    _assert_close(out, kernels.cn_mlp_block_plain(*args))


def _assert_near_float64(out, twin, ref64):
    """No further from the float64 statement than twice the twin (full float32)."""
    def far(a):
        return float((a.double() - ref64).abs().max() / ref64.abs().max())

    assert far(out) <= 2 * far(twin), (far(out), far(twin))


def test_attention_block_float32(emulated):
    """LN rows, the QKV product (3 D = 384: three 128-column tiles), the split-TF32 core, the output projection with
    the residual; 140 tokens, off the 128-row tile."""
    rng = np.random.default_rng(11)
    n, s, d, heads = 2, 70, 128, 2
    args = (_normal(rng, (n, s, d)), _normal(rng, (d,), std=0.2, mean=1.0), _normal(rng, (d,), std=0.1),
            _normal(rng, (d, 3 * d), std=d ** -0.5), _normal(rng, (3 * d,), std=0.1), _normal(rng, (d, d), std=d ** -0.5),
            _normal(rng, (d,), std=0.1), heads, 0.125)
    out = _run(emulated, kernels.attention_block, args, kernel_launches=4)
    twin = kernels.attention_block_plain(*args)
    _assert_close(out, twin)
    _assert_near_float64(out, twin, transformer_block._attention_block_f64(*args))


@pytest.mark.parametrize("nw,c,v2,masked,ln_count", [(3, 96, False, True, 0), (3, 96, False, False, 0),
                                                     (3, 96, True, True, 0), (3, 128, False, True, 96)],
                         ids=["v1_masked", "v1", "v2", "ln_count"])
def test_window_attention_block_float32(emulated, nw, c, v2, masked, ln_count):
    """Windows of 49 tokens, 147 rows (off the 128-row tile); C 96 under one 128-column tile (its QKV product, N 288,
    in five tiles of 64), or C 128 with 96 real channels."""
    rng = np.random.default_rng(c + nw + 2 * v2 + masked)
    s, heads, nw_img = 49, c // 32, 3 if masked else 1
    args = [_normal(rng, (nw, s, c)), _normal(rng, (c,), std=0.2, mean=1.0), _normal(rng, (c,), std=0.1),
            _normal(rng, (c, 3 * c), std=c ** -0.5), _normal(rng, (3 * c,), std=0.1), _normal(rng, (c, c), std=c ** -0.5),
            _normal(rng, (c,), std=0.1), _normal(rng, (heads, s, s), std=0.3),
            torch.from_numpy((rng.random((nw_img, s, s)) > 0.5).astype(np.float32) * -100.0) if masked else None,
            _normal(rng, (heads,), std=0.5, mean=2.3) if v2 else None, heads, 32 ** -0.5, 1e-5, v2, nw_img, ln_count]
    if ln_count:  # a zero-padded channel layout: the real channels first
        for i in (0, 1, 2, 6):
            args[i][..., ln_count:] = 0
        args[3][ln_count:] = 0
        args[5][:, ln_count:] = 0
    out = _run(emulated, kernels.window_attention_block, args, kernel_launches=4)
    twin = kernels.window_attention_block_plain(*args)
    _assert_close(out, twin)
    _assert_near_float64(out, twin, swin_attention._window_attention_block_f64(*args))
