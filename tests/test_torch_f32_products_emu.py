"""The split-TF32 products' CUDA sources (``csrc/tf32x3.cuh`` behind the float32
``mlp_block``, ``cn_mlp_block`` and ``wgrad_matmul``) and the bfloat16 weight
gradient on ``wgmma`` (``csrc/wgrad_matmul.cu``) run on the CPU through
``tools/cuda_emu``, against the wrappers' plain twins.

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
``1e-5·max|twin|`` for the weight gradient, ``2e-4·(1 + |twin|)`` for the MLP
blocks.  Without ``g++`` the tests skip.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels.wgrad_matmul import slab_rows

WGRAD_TOL = 1e-5
TOL = 2e-4
_EMULATE = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"


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
