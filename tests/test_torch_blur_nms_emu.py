"""The blur and NMS kernels (``csrc/stencil.cu``: ``blur_strip_kernel``,
rows of NHWC frames streamed through a ``cp.async`` ring on a persistent
grid; ``csrc/nms.cu``: the mask pass over the blocks on and above the
diagonal and the scan that stages its tiles in shared memory) run on the CPU
through ``tools/cuda_emu``, against the wrappers' plain twins.

The emulator compiles the sources with ``g++`` against stand-in headers,
runs one thread per CUDA thread, defers each ``cp.async`` to its wait and
poisons shared memory with NaN.  ``fused_gaussian_blur`` must equal its twin
bit for bit and return a contiguous tensor of the input's shape: NHWC frames
of 1, 3 and 4 channels read as they lie, 2 channels through the (N C, H, W)
maps; K 1, 2, 5, 7, 9 and 17 (16-byte windows, two elements a lane, one
element a lane); maps smaller than the halo (the reflection periodic), one
row, one column; rows that are and are not whole 16-byte chunks; strips at
the frame's edges and between them; more frames than the grid has warps; HW
and HWC images.  ``nms_sorted`` must equal ``nms_sorted_plain`` bit for bit
at N 1, 63, 64, 65, 300 and 1000 and thresholds 0.5 and 0.7, on more
problems than the scan's grid has blocks, on dense overlaps with long chains
(a box kept, the next struck, the one after kept again), on degenerate (zero
width, zero area) and tied (identical) boxes, at thresholds equal to pairs'
IoUs and a step either side, on pairs whose IoU is a rounding from the
threshold, and past the words the scan stages (N 4,160).  The new intrinsics of
the stand-in headers (``__ffsll``, ``__reduce_or_sync``) have cases of their
own through the scan.  Without ``g++`` the tests skip.
"""

import importlib.util
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import nms as nms_kernel
from cpu_vision_tpu_torch.ops.kernels import stencil

_EMULATE = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"
STEMS = ("stencil", "nms")


@pytest.fixture(autouse=True)
def _launch_counts_at_zero_after():
    """The emulated kernels count their launches; later tests in this process expect CPU tensors to have launched
    nothing."""
    yield
    kernels.reset_launch_counts()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulator module with the stencil and NMS sources built into a temporary directory."""
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


# (shape, K, sms): NHWC unless marked
BLUR_CASES = {
    "c3_k5_edge_and_interior_strips": ((1, 9, 152, 3), 5, None),  # 456 elements a row: 4 strips, 2 interior
    "c3_k5_rows_off_16_bytes": ((2, 7, 151, 3), 5, None),         # 453 a row: 4-byte copies, scalar stores
    "c1_k5_interior": ((2, 20, 600, 1), 5, None),
    "c4_k7": ((1, 12, 100, 4), 7, None),
    "c3_k9_two_a_lane": ((1, 10, 100, 3), 9, None),               # a shifting ring of W-blurred rows
    "c1_k17_one_a_lane": ((1, 40, 90, 1), 17, None),
    "c3_k17": ((1, 20, 70, 3), 17, None),
    "c4_k2_even": ((2, 5, 33, 4), 2, None),
    "c1_k1": ((3, 4, 5, 1), 1, None),
    "under_the_halo": ((1, 3, 2, 3), 7, None),                    # reflection past the frame: periodic
    "one_row": ((1, 1, 37, 3), 5, None),
    "one_column": ((1, 30, 1, 4), 5, None),
    "c2_maps_route": ((2, 15, 41, 2), 5, None),
    "frames_past_the_grid": ((9, 6, 10, 3), 5, 1),                # one block of 4 warps walks 9 tiles
    "hw_image": ((37, 50), 5, None),
    "hwc_image": ((21, 40, 3), 5, None),
}


@pytest.mark.parametrize("case", list(BLUR_CASES))
def test_fused_gaussian_blur(emulated, case):
    shape, ks, sms = BLUR_CASES[case]
    img = torch.from_numpy(np.random.default_rng(sum(shape) + ks).random(shape, dtype=np.float32))
    out = _run(emulated, kernels.fused_gaussian_blur, (img, ks, 1.2), sms)
    maps, restore = stencil._as_nhw(img)
    twin = restore(stencil.fused_gaussian_blur_plain(maps, stencil.gaussian_taps(ks, 1.2)))
    assert out.shape == img.shape and out.dtype == torch.float32 and out.is_contiguous()
    assert torch.equal(out, twin)


def _boxes(p, n, extent, seed, size=(1.0, 15.0)):
    rng = np.random.default_rng(seed)
    ctr = rng.random((p, n, 2), dtype=np.float32) * extent
    wh = rng.random((p, n, 2), dtype=np.float32) * (size[1] - size[0]) + size[0]
    return torch.from_numpy(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1))


@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 300, 1000])
def test_nms_sorted(emulated, n, thr):
    boxes = _boxes(2, n, 8.0 + n / 10, n, size=(2.0, 15.0))
    keep = _run(emulated, kernels.nms_sorted, (boxes, thr))
    twin = nms_kernel.nms_sorted_plain(boxes, thr)
    assert keep.dtype == torch.bool and torch.equal(keep, twin)
    assert n == 1 or 0 < int(twin.sum()) < twin.numel()  # some boxes struck, some kept


def _chains(p, n, step):
    """Boxes along a line, each ``step`` after the one before: box i overlaps i + 1 above the threshold and i + 2
    below it, so the greedy answer alternates down the whole chain."""
    x = torch.arange(n, dtype=torch.float32)[None, :, None] * step + torch.arange(p, dtype=torch.float32)[:, None, None]
    y = torch.zeros_like(x)
    return torch.cat([x, y, x + 10.0, y + 10.0], -1)


def test_nms_sorted_long_chains(emulated):
    boxes = _chains(3, 200, 2.0)  # IoU 8/12 with the next box, 6/14 with the one after
    keep = _run(emulated, kernels.nms_sorted, (boxes, 0.5))
    twin = nms_kernel.nms_sorted_plain(boxes, 0.5)
    assert torch.equal(keep, twin)
    assert torch.equal(twin[0], torch.arange(200) % 2 == 0)


def test_nms_sorted_degenerate_and_tied_boxes(emulated):
    boxes = _boxes(2, 130, 20.0, 11)
    boxes[0, 10:20] = boxes[0, 9]                       # tied: identical boxes
    boxes[0, 30:40, 2] = boxes[0, 30:40, 0]             # zero width
    boxes[1, 50:70] = boxes[1, 50:51, :2].repeat(1, 1, 2)  # zero area, all at one point
    boxes[1, 100:110] = boxes[1, 120]
    for thr in (0.5, 0.7):
        keep = _run(emulated, kernels.nms_sorted, (boxes, thr))
        assert torch.equal(keep, nms_kernel.nms_sorted_plain(boxes, thr))


def test_nms_sorted_thresholds_on_the_ious(emulated):
    """Thresholds equal to pairs' IoUs (float32, the twin's formula) and one step above and below: every pair
    decides as the twin's division does."""
    boxes = _boxes(1, 150, 25.0, 17, size=(2.0, 15.0))
    x1, y1, x2, y2 = boxes[0].unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    inter = ((torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])).clamp_min(0)
             * (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])).clamp_min(0))
    iou = inter / torch.maximum(area[:, None] + area[None] - inter, torch.tensor(1e-12))
    ious = iou[torch.triu(torch.ones_like(iou, dtype=torch.bool), 1) & (iou > 0.2) & (iou < 0.8)]
    for v in ious[torch.linspace(0, len(ious) - 1, 4).long()]:
        for thr in (v, torch.nextafter(v, torch.tensor(1.0)), torch.nextafter(v, torch.tensor(0.0))):
            keep = _run(emulated, kernels.nms_sorted, (boxes, float(thr)))
            assert torch.equal(keep, nms_kernel.nms_sorted_plain(boxes, float(thr)))


@pytest.mark.parametrize("thr", [0.5, 0.7, 0.75])
def test_nms_sorted_ious_a_rounding_from_the_threshold(emulated, thr):
    """Pairs whose IoU is the threshold in real numbers, or within a rounding of it (a box, and one from the same
    corner 1 / thr times as wide), 75 of them apart from each other: the float32 IoU lands on the threshold or a
    step either side, and each pair's decision shows in whether its second box is kept."""
    rng = np.random.default_rng(23)
    x0, a = rng.random(75, dtype=np.float32) * 50, rng.random(75, dtype=np.float32) * 40 + 1
    y = np.arange(75, dtype=np.float32) * 3
    first = np.stack([x0, y, x0 + a, y + 1], -1)
    second = np.stack([x0, y, x0 + a / np.float32(thr), y + 1], -1)
    boxes = torch.from_numpy(np.stack([first, second], 1).reshape(1, 150, 4))
    keep = _run(emulated, kernels.nms_sorted, (boxes, thr))
    twin = nms_kernel.nms_sorted_plain(boxes, thr)
    assert torch.equal(keep, twin)
    assert 0 < int(twin[0, 1::2].sum()) < 75  # some second boxes struck (IoU above thr), some kept


def test_nms_sorted_past_the_staged_words(emulated):
    """N 4,160: 65 tiles, so the scan's stages (64 words a tile's rows) leave tile 0's last word in device memory;
    boxes 4,100-4,109 repeat boxes 0-9, so only that word strikes them."""
    boxes = _boxes(1, 4160, 400.0, 9, size=(2.0, 30.0))
    boxes[0, 4100:4110] = boxes[0, :10]
    keep = _run(emulated, kernels.nms_sorted, (boxes, 0.5))
    twin = nms_kernel.nms_sorted_plain(boxes, 0.5)
    assert torch.equal(keep, twin) and not bool(twin[0, 4100:4110].any())


def test_nms_sorted_problems_past_the_grid(emulated):
    """One SM: the scan's grid holds 4 blocks, which walk 7 problems (leading dims (7,) and (1, 7))."""
    boxes = _boxes(7, 150, 40.0, 3)
    keep = _run(emulated, kernels.nms_sorted, (boxes, 0.6), sms=1)
    assert torch.equal(keep, nms_kernel.nms_sorted_plain(boxes, 0.6))
    keep = _run(emulated, kernels.nms_sorted, (boxes[None], 0.6), sms=1)
    assert keep.shape == (1, 7, 150) and torch.equal(keep[0], nms_kernel.nms_sorted_plain(boxes, 0.6))
