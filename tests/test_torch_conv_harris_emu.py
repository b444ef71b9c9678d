"""The fused convolution stage (``csrc/conv_block.cu``: an implicit GEMM on
``wgmma`` by split TF32) and the Harris kernel (``csrc/stencil.cu``: rows
streamed through a ``cp.async`` ring on a persistent grid) run on the CPU
through ``tools/cuda_emu``, against the wrappers' plain twins.

The emulator compiles the sources with ``g++`` against stand-in headers, runs
one thread per CUDA thread, defers each ``cp.async`` and ``wgmma`` to its wait,
reads tf32 operands with their 13 low mantissa bits dropped and poisons shared
memory with NaN.  The convolution runs at Cin 1, 3 (one stage of K 27), 32,
33 and 100 (windows of 32 channels reloaded a chunk at a time, past the 89 the
kernel it replaced staged at most), Cout 1, 5 and 40 (the wrapper's padded
weights), 64 and 70 (two column tiles), on maps whose pooled size is off the
4 x 8 tile, down to 2 x 2: within ``1e-5 + 1e-5·|twin|``, as on the card.
Harris must equal its twin bit for bit: on maps smaller than its halo (the
reflection periodic), of one row and of one column, with K 1 to 9 (2: even),
ragged tiles, rows of 16-byte copies (W a multiple of 4, interior tiles) and
of 4-byte ones, and 140 frames walked by two blocks.  Without ``g++`` the
tests skip.
"""

import importlib.util
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import conv_block, stencil

_EMULATE = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"
STEMS = ("conv_block", "stencil")


@pytest.fixture(autouse=True)
def _launch_counts_at_zero_after():
    """The emulated kernels count their launches; later tests in this process expect CPU tensors to have launched
    nothing."""
    yield
    kernels.reset_launch_counts()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulator module with the two sources built into a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the CUDA emulation needs a C++20 compiler")
    spec = importlib.util.spec_from_file_location("cuda_emulate", _EMULATE)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    build_dir = tmp_path_factory.mktemp("cuda_emu")
    emulate.build(build_dir, STEMS)
    return emulate, build_dir


def _run(emulated, fn, args, sms=None):
    emulate, build_dir = emulated
    with emulate.kernels_on_cpu(build_dir, STEMS):
        if sms is not None:
            torch.cuda.get_device_properties = lambda device: types.SimpleNamespace(multi_processor_count=sms)
        before = fn.launches
        out = fn(*args)
        assert fn.launches == before + 1  # the emulated kernel ran, not the twin
    return out


@pytest.mark.parametrize("shape,cout", [((2, 10, 18, 1), 32), ((1, 6, 20, 3), 5), ((1, 10, 18, 32), 64),
                                        ((1, 4, 6, 100), 40), ((1, 2, 2, 1), 1), ((1, 4, 4, 33), 70)],
                         ids=["cin1", "cin3_cout5", "cin32", "cin100", "two_by_two", "two_column_tiles"])
def test_conv3x3_relu_pool(emulated, shape, cout):
    rng = np.random.default_rng(sum(shape) + cout)
    x = torch.from_numpy(rng.random(shape, dtype=np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (3, 3, shape[-1], cout)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, (cout,)).astype(np.float32))
    out = _run(emulated, kernels.fused_conv3x3_relu_pool, (x, w, b))
    twin = conv_block.fused_conv3x3_relu_pool_plain(x, w, b)
    assert out.shape == twin.shape == (shape[0], shape[1] // 2, shape[2] // 2, cout)
    err = (out - twin).abs()
    assert bool((err <= 1e-5 + 1e-5 * twin.abs()).all()), float(err.max())


@pytest.mark.parametrize("shape,ks,sms", [((1, 3, 2), 5, None), ((1, 1, 9), 5, None), ((2, 7, 1), 3, None),
                                          ((1, 70, 392), 5, None), ((1, 66, 137), 9, None), ((1, 20, 260), 2, None),
                                          ((3, 5, 5), 1, None), ((140, 5, 6), 5, 2)],
                         ids=["under_the_halo", "one_row", "one_column", "interior_tiles", "unaligned_rows",
                              "even_window", "window_1", "persistent"])
def test_harris_response_fused(emulated, shape, ks, sms):
    rng = np.random.default_rng(sum(shape) + ks)
    maps = torch.from_numpy(rng.random(shape, dtype=np.float32))
    out = _run(emulated, kernels.harris_response_fused, (maps[..., None], 0.05, ks, 1.2), sms)[..., 0]
    assert torch.equal(out, stencil.harris_response_fused_plain(maps, stencil.gaussian_taps(ks, 1.2), 0.05))
