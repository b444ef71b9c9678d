"""Greedy NMS over boxes sorted by descending score (CUDA, ``csrc/nms.cu``)
and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/pallas/nms.py:nms_sorted_pallas``:
boxes (..., N, 4), leading dims independent problems, in; the keep mask
(..., N) bool out, where box ``i`` is kept iff no kept box ``j < i`` has
``IoU(j, i) > iou_threshold``.  Boxes are cast to float32.  The IoU is the
Pallas kernel's (``_iou_tile``): ``inter / max(area_a + area_b - inter,
1e-12)``; ``ops.boxes.box_iou`` has no floor, and the two differ only where a
union is at most 1e-12.  The threshold is rounded to float32 once, as JAX
rounds a Python float against a float32 array.

``nms_sorted`` given a CUDA tensor launches the hand-written kernel (all
problems in one call of two launches: the pairs' suppression bits over the
whole card, then one block a problem walking them in score order, its tiles
staged in shared memory), adds one to
its ``launches`` count, and raises if the launch fails or the input is off
the kernel's domain (more than ``MAX_BOXES`` boxes or ``MAX_PROBLEMS``
problems); given a CPU tensor it runs the twin.  Nothing falls back from one
to the other.  Both make every decision from the same float32 operations in
the same order (the kernel is built with ``--fmad=false``), so their masks are
equal bit for bit.

``recording()`` yields a list that every launch inside the block appends its
input to: the float32 (P, N, 4) boxes the kernel read and the threshold.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["nms_sorted", "nms_sorted_plain", "kernel_takes", "require_kernel", "recording", "mask_words",
           "MAX_BOXES", "MAX_PROBLEMS", "MASK_BITS"]

MAX_BOXES = 13600     # csrc/nms.cu NMS_MAX_BOXES: a problem's removed bits in shared memory
MAX_PROBLEMS = 65535  # the mask launch's gridDim.z
MASK_BITS = 64        # boxes a word of the suppression mask covers (csrc/nms.cu NMS_COLS)

_c_lib: Optional[ctypes.CDLL] = None
_recorders: List[List[Tuple[torch.Tensor, float]]] = []


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("nms")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cvt_nms_sorted.argtypes = [p, p, p, i, i, ctypes.c_float, i, p]
        lib.cvt_nms_sorted.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def _check(boxes: torch.Tensor) -> None:
    if boxes.ndim < 2 or boxes.shape[-1] != 4:
        raise ValueError(f"expects boxes (..., N, 4), got {tuple(boxes.shape)}")
    if not boxes.dtype.is_floating_point:
        raise TypeError(f"expects floating-point boxes, got {boxes.dtype}")


def _threshold(iou_threshold: float) -> float:
    return float(np.float32(iou_threshold))


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[torch.Tensor, float]]]:
    """Within the block, each launch of the kernel appends ``(boxes, iou_threshold)``
    to the yielded list: a copy of the float32 (P, N, 4) boxes it read."""
    calls: List[Tuple[torch.Tensor, float]] = []
    _recorders.append(calls)
    try:
        yield calls
    finally:
        _recorders.remove(calls)


def kernel_takes(boxes: torch.Tensor) -> bool:
    """Whether the kernel takes boxes of this shape: at most ``MAX_BOXES`` a
    problem and ``MAX_PROBLEMS`` problems (whatever the device)."""
    _check(boxes)
    return boxes.shape[-2] <= MAX_BOXES and math.prod(boxes.shape[:-2]) <= MAX_PROBLEMS


def _problems(boxes: torch.Tensor) -> int:
    """The problems in ``boxes`` (checked); raise unless the kernel takes their shape."""
    if boxes.shape[-2] > MAX_BOXES:
        raise ValueError(f"the NMS kernel takes at most {MAX_BOXES} boxes a problem, got {boxes.shape[-2]}")
    p = math.prod(boxes.shape[:-2])
    if p > MAX_PROBLEMS:
        raise ValueError(f"the NMS kernel takes at most {MAX_PROBLEMS} problems a call, got {tuple(boxes.shape[:-2])}")
    return p


def require_kernel(boxes: torch.Tensor) -> None:
    """Raise unless ``nms_sorted`` would launch its kernel on ``boxes``."""
    _check(boxes)
    _problems(boxes)
    if not _build.on_card(boxes):
        raise ValueError("the NMS kernel runs on CUDA tensors; this one is on the CPU")


def nms_sorted_plain(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Twin of ``cvt_nms_sorted``: the (N, N) suppression matrix ``sup[j, i]``
    (``j < i`` and IoU above the threshold), then the Jacobi fixpoint of the
    greedy recursion ``keep[i] = not any_j (keep[j] and sup[j, i])``, which
    reaches the greedy answer once it stops changing (the dependencies run
    from lower to higher index only).  The loop's control reads the device."""
    _check(boxes)
    thr = _threshold(iou_threshold)
    b = boxes.float()
    n = b.shape[-2]
    x1, y1, x2, y2 = b.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    w = (torch.minimum(x2[..., :, None], x2[..., None, :]) - torch.maximum(x1[..., :, None], x1[..., None, :])).clamp_min(0)
    h = (torch.minimum(y2[..., :, None], y2[..., None, :]) - torch.maximum(y1[..., :, None], y1[..., None, :])).clamp_min(0)
    inter = w * h
    del w, h
    union = area[..., :, None] + area[..., None, :] - inter
    iou = inter / torch.maximum(union, torch.tensor(1e-12, dtype=torch.float32, device=b.device))
    del inter, union
    idx = torch.arange(n, device=b.device)
    sup = (iou > thr) & (idx[:, None] < idx[None, :])
    del iou
    keep = torch.ones(b.shape[:-1], dtype=torch.bool, device=b.device)
    for _ in range(n):
        new = ~(sup & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def mask_words(n: int) -> int:
    """64-bit words of the kernel's suppression bits for a problem of ``n`` boxes: the 64 x 64 blocks on and above
    the diagonal of its (N, N) matrix, W (W + 1) / 2 of them for W = ceil(N / 64) (``csrc/nms.cu``)."""
    words = -(-n // MASK_BITS)
    return words * (words + 1) // 2 * MASK_BITS


def nms_sorted(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Keep mask (..., N) bool for boxes (..., N, 4) pre-sorted by descending
    score; on the card every problem in one call."""
    _check(boxes)
    if not _build.on_card(boxes):
        return nms_sorted_plain(boxes, iou_threshold)
    p, lead, n = _problems(boxes), boxes.shape[:-2], boxes.shape[-2]
    keep = torch.empty((p, n), dtype=torch.bool, device=boxes.device)
    if p == 0 or n == 0:
        return keep.reshape(*lead, n)
    b = boxes.float().reshape(p, n, 4).contiguous()
    mask = torch.empty((p, mask_words(n)), dtype=torch.int64, device=b.device)  # the kernel's scratch
    _build.launch(_lib(), "cvt_nms_sorted", b, b.data_ptr(), mask.data_ptr(), keep.data_ptr(), p, n,
                  _threshold(iou_threshold), _build.sm_count(b))
    _build.count_launch(nms_sorted, b)
    for calls in _recorders:
        calls.append((b.clone(), iou_threshold))
    return keep.reshape(*lead, n)


_build.reset_count(nms_sorted)
