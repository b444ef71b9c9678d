"""The blur + Sobel magnitude kernel (``csrc/stencil.cu``: ``blur_sobel_strip_kernel``,
Canny's front half on its strip engine: rows streamed through a ``cp.async``
ring on a persistent grid, the blur, Sobel and magnitude in registers) runs on
the CPU through ``tools/cuda_emu``, against the wrapper's plain twin.

The emulator compiles the source with ``g++`` against stand-in headers, runs
one thread per CUDA thread, defers each ``cp.async`` to its wait and poisons
shared memory with NaN.  ``fused_blur_sobel`` must equal
``fused_blur_sobel_plain`` bit for bit at K 1, 2, 5, 7 (four columns a lane,
16-byte reads), 9 (two columns a lane, past the unrolled ring of W-blurred
rows), 17 and 31 (one column a lane): on maps smaller than the halo (the
reflection periodic), of one row and of one column, at widths that are and
are not multiples of 4 (16-byte copies and vector stores, or 4-byte copies
and single stores), on strips at the image's edges and between them, on more
frames than the grid has warps, on strips 16, 8, 4 and 2 rows deep, and on HW
and RGB images.  The twin takes its square root in float64 rounded to
float32: correctly rounded, as the kernel's ``sqrtf`` is, which
``torch.sqrt`` on the CPU may not be in the last bit.  Without ``g++`` the
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
from cpu_vision_tpu_torch.ops.kernels import stencil

_EMULATE = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"
STEMS = ("stencil",)


@pytest.fixture(autouse=True)
def _launch_counts_at_zero_after():
    """The emulated kernels count their launches; later tests in this process expect CPU tensors to have launched
    nothing."""
    yield
    kernels.reset_launch_counts()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulator module with the stencil source built into a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the CUDA emulation needs a C++20 compiler")
    spec = importlib.util.spec_from_file_location("cuda_emulate", _EMULATE)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    build_dir = tmp_path_factory.mktemp("cuda_emu")
    emulate.build(build_dir, STEMS)
    return emulate, build_dir


def _run(emulated, image, ks, sigma, sms=None):
    emulate, build_dir = emulated
    with emulate.kernels_on_cpu(build_dir, STEMS):
        if sms is not None:
            torch.cuda.get_device_properties = lambda device: types.SimpleNamespace(multi_processor_count=sms)
        before = kernels.fused_blur_sobel.launches
        out = kernels.fused_blur_sobel(image, ks, sigma)
        assert kernels.fused_blur_sobel.launches == before + 1  # the emulated kernel ran, not the twin
    return out


def _root64(x):
    return torch.sqrt(x.double()).float()


# (NHWC shape, K, sms): an output strip is 120 columns at K <= 7, 60 at K <= 15, 30 past it, and 16 rows deep,
# halved down to 2 while the strips are fewer than the grid's warps (the emulator reports one block of 4 warps an SM):
# most of the small maps below run strips of 2 rows
CASES = {
    "under_the_halo": ((1, 3, 2, 1), 5, None),
    "one_row": ((1, 1, 9, 1), 5, None),
    "one_column": ((2, 7, 1, 1), 3, None),
    "window_1": ((3, 5, 5, 1), 1, None),
    "even_window": ((1, 20, 260, 1), 2, None),
    "edge_and_interior_strips_k5": ((1, 70, 392, 1), 5, 1),  # 4 strips, 2 interior, 16 rows; vector stores
    "strips_16_rows_k5": ((2, 45, 250, 1), 5, 4),
    "strips_8_rows_k5": ((1, 40, 250, 1), 5, 3),
    "strips_4_rows_k5": ((1, 40, 250, 1), 5, 5),
    "width_off_4_k7": ((1, 66, 137, 1), 7, 1),                # 4-byte copies, single stores
    "interior_strips_k7": ((1, 9, 600, 1), 7, None),
    "two_columns_a_lane_k9": ((1, 30, 150, 1), 9, None),
    "width_off_4_k9": ((1, 12, 202, 1), 9, None),
    "one_column_a_lane_k17": ((1, 25, 80, 1), 17, None),
    "k31": ((1, 40, 70, 1), 31, None),
    "k31_under_the_halo": ((1, 9, 11, 1), 31, None),
    "frames_past_the_grid": ((40, 6, 10, 1), 5, 2),  # 2 blocks of 4 warps walk 40 tiles
    "rgb": ((1, 20, 30, 3), 5, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_blur_sobel_bits(emulated, case):
    shape, ks, sms = CASES[case]
    sigma = 0.3 * ks + 0.5
    image = torch.from_numpy(np.random.default_rng(sum(shape) + ks).random(shape, dtype=np.float32))
    out = _run(emulated, image, ks, sigma, sms)
    maps, restore = stencil._as_nhw(image)
    twin = restore(stencil.fused_blur_sobel_plain(maps, stencil.gaussian_taps(ks, sigma), root=_root64))
    assert out.shape == image.shape and out.dtype == torch.float32
    assert torch.equal(out, twin)
    assert bool((out > 0).any()) or ks == 1 and min(shape[1:3]) < 2


def test_hw_image(emulated):
    """An HW image in, HW out: one map through the kernel."""
    image = torch.from_numpy(np.random.default_rng(3).random((33, 129), dtype=np.float32))
    out = _run(emulated, image, 5, 1.5)
    twin = stencil.fused_blur_sobel_plain(image[None], stencil.gaussian_taps(5, 1.5), root=_root64)[0]
    assert out.shape == image.shape and torch.equal(out, twin)
