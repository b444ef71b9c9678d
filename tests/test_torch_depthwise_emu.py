"""The depthwise convolution's CUDA source (``csrc/depthwise.cu``: 7×7 patches a
thread, a persistent grid walking tiles through a two-stage ``cp.async`` ring)
run on the CPU through ``tools/cuda_emu``, against the wrapper's plain twin.

The emulator compiles the source with ``g++`` against stand-in headers, runs
one thread per CUDA thread, defers each ``cp.async`` to its wait and poisons
shared memory with NaN, so a copy that lands late, a stage overwritten while
it is read or a window value never written shows.  The shapes are off the
tiles: maps of 7², 14² and 9×13 (patches past the map), C 40, 96 and 200 (a
channel group past C), K 3, 5 and 7, with and without bias, and the backward's
dx call (the taps flipped, no bias).  With one multiprocessor the grid is one
block, which walks every tile through the ring; C 42 takes the plain loads
(not a multiple of 8 values).  Tolerances are the wrapper's
(``depthwise.py``): float32 ``1e-5 + 1e-5·|twin|``, bfloat16 one rounding step
of the output (``1e-5 + 2⁻⁷·|twin|``).  Without ``g++`` the tests skip.
"""

import importlib.util
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import depthwise

_EMULATE = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


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


def _inputs(seed, shape, ks, dtype):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    taps = torch.from_numpy((rng.standard_normal((ks, ks, c)) / ks).astype(np.float32)).to(dtype)
    return x, taps, torch.from_numpy(rng.standard_normal(c).astype(np.float32))


def _launch(emulated, fn, sms=None):
    """``fn()`` with the emulated kernel (on ``sms`` multiprocessors, where given); its output and the kernel's info
    at the input of the launch."""
    emulate, build_dir = emulated
    with emulate.kernels_on_cpu(build_dir):
        if sms is not None:
            torch.cuda.get_device_properties = lambda device: types.SimpleNamespace(multi_processor_count=sms)
        before = kernels.depthwise_conv2d.launches
        out = fn()
        assert kernels.depthwise_conv2d.launches == before + 1  # the emulated kernel ran, not the twin
        again = fn()
    assert torch.equal(out, again)  # the same bits twice
    return out


def _assert_close(out, twin):
    assert out.shape == twin.shape and out.dtype == twin.dtype
    err = (out.float() - twin.float()).abs()
    rtol = RTOL[out.dtype]
    assert bool((err <= 1e-5 + rtol * twin.float().abs()).all()), f"max |err| {float(err.max())}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape,ks,use_bias", [((2, 9, 13, 40), 7, True), ((1, 7, 7, 96), 3, True),
                                               ((1, 14, 14, 200), 5, False), ((2, 14, 14, 96), 7, False),
                                               ((1, 7, 7, 200), 7, True)],
                         ids=["9x13_c40_k7", "7x7_c96_k3", "14x14_c200_k5_no_bias", "14x14_c96_k7_no_bias",
                              "7x7_c200_k7"])
def test_depthwise_conv2d(emulated, shape, ks, use_bias, dtype):
    x, taps, bias = _inputs(sum(shape) + ks, shape, ks, dtype)
    out = _launch(emulated, lambda: kernels.depthwise_conv2d(x, taps, bias, use_bias))
    _assert_close(out, kernels.depthwise_conv2d_plain(x, taps, bias, use_bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 9, 13, 40), (2, 9, 13, 42)], ids=["ring", "plain_loads"])
def test_depthwise_conv2d_one_block_walks_the_tiles(emulated, shape, dtype):
    """One multiprocessor: one block walks every tile, each next window copied into the other stage while this one is
    read; C 42 stages by plain loads."""
    x, taps, bias = _inputs(shape[-1], shape, 7, dtype)
    emulate, build_dir = emulated
    with emulate.kernels_on_cpu(build_dir):
        torch.cuda.get_device_properties = lambda device: types.SimpleNamespace(multi_processor_count=1)
        info = depthwise.kernel_info(x, 7)
    assert info["grid"] == 1 and info["tiles"] >= 2 and info["vector_copies"] == (shape[-1] % 8 == 0)
    out = _launch(emulated, lambda: kernels.depthwise_conv2d(x, taps, bias), sms=1)
    _assert_close(out, kernels.depthwise_conv2d_plain(x, taps, bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_depthwise_dx(emulated, dtype):
    """The backward's dx: the forward kernel on the flipped taps, no bias (``depthwise.py:_backward``)."""
    g, taps, _ = _inputs(5, (2, 14, 14, 96), 7, dtype)
    flipped = taps.flip(0, 1).contiguous()
    out = _launch(emulated, lambda: depthwise._kernel(g, flipped, None))
    _assert_close(out, kernels.depthwise_conv2d_plain(g, flipped, None))
