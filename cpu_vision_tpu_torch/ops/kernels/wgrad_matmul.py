"""Weight gradient of a pointwise convolution, ``dW = xᵀ·dy`` (CUDA,
``csrc/wgrad_matmul.cu``), and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/pallas/wgrad_matmul.py``:
``wgrad_matmul(x, dy)`` takes ``x`` (M, Cin) and ``dy`` (M, Cout), both
float32 or both bfloat16, and returns the float32 (Cin, Cout) sum over the M
rows, accumulated in float32.  No padding shows in the result.  The JAX
function's ``block_m`` and ``interpret`` arguments have no counterpart here.

``wgrad_matmul`` given CUDA tensors launches the hand-written kernel (a
partial sum per slab of rows on the tensor cores: bfloat16 ``wgmma``, or
float32 by split TF32, three tf32 products a product with float32 sums; then a
launch that adds the slabs in a fixed order: two calls give the same bits),
adds one to its ``launches`` count and raises if the launch fails; given CPU
tensors it runs the twin.  Nothing falls back from one to the other.  Where
Cin or Cout is not a multiple of 8, the wrapper copies ``x`` or ``dy`` with
zero columns up to the next multiple (the kernel reads rows in 16-byte
chunks); no model's shape needs it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..._dtype import full_float32
from . import _build

__all__ = ["wgrad_matmul", "wgrad_matmul_plain", "slab_rows", "tile_shape"]

DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 64             # rows a bf16 block stages at once (f32: 32); a slab is a multiple (csrc/wgrad_matmul.cu)
TILE = 64              # the least side of a block's output tile (tile_shape)
MIN_SLAB_ROWS = 256    # no slab shorter than this
BLOCKS_PER_SM = 4      # slabs are sized for about this many blocks an SM
COLUMN_STEP = 8        # the kernel reads rows of x and dy in 16-byte chunks: strides a multiple of 8

_c_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("wgrad_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cvt_wgrad_matmul.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        lib.cvt_wgrad_matmul.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def _check(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.ndim != 2 or dy.ndim != 2 or x.shape[0] != dy.shape[0] or min(*x.shape, dy.shape[1]) < 1:
        raise ValueError(f"expects non-empty x (M, Cin) and dy (M, Cout), got {tuple(x.shape)} and {tuple(dy.shape)}")
    if x.dtype not in DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"expects x and dy both float32 or both bfloat16, got {x.dtype} and {dy.dtype}")
    if dy.device != x.device:
        raise ValueError("x and dy must lie on one device")


def wgrad_matmul_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Twin of ``cvt_wgrad_matmul``: ``x.float().t() @ dy.float()`` in full
    float32 (no TF32)."""
    _check(x, dy)
    with full_float32():
        return x.float().t() @ dy.float()


def tile_shape(cin: int, cout: int) -> tuple:
    """(Cin rows, Cout columns) of a block's output tile in the kernel: 64 or
    128 each, 64 where the side is at most 64 (csrc/wgrad_matmul.cu)."""
    return (TILE if cin <= TILE else 2 * TILE), (TILE if cout <= TILE else 2 * TILE)


def slab_rows(m: int, cin: int, cout: int, sms: int) -> int:
    """Rows of a slab: a multiple of ``CHUNK``, at least ``MIN_SLAB_ROWS``
    (or all of ``m``), and short enough that the (Cout tiles × Cin tiles ×
    slabs) grid holds about ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs."""
    rows, cols = tile_shape(cin, cout)
    tiles = math.ceil(cin / rows) * math.ceil(cout / cols)
    slabs = max(1, min(math.ceil(m / MIN_SLAB_ROWS), math.ceil(BLOCKS_PER_SM * sms / tiles)))
    return math.ceil(math.ceil(m / slabs) / CHUNK) * CHUNK


def wgrad_matmul(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``xᵀ·dy`` as float32 (Cin, Cout), summed in float32, for ``x`` (M, Cin)
    and ``dy`` (M, Cout) of one dtype (float32 or bfloat16)."""
    _check(x, dy)
    if not _build.on_card(x):
        return wgrad_matmul_plain(x, dy)
    m, cin = x.shape
    cout = dy.shape[1]
    xk, dyk = _padded(x), _padded(dy)
    rows = slab_rows(m, cin, cout, torch.cuda.get_device_properties(x.device).multi_processor_count)
    slabs = math.ceil(m / rows)
    out = torch.empty((cin, cout), dtype=torch.float32, device=x.device)
    partial = torch.empty((slabs if slabs > 1 else 0, cin, cout), dtype=torch.float32, device=x.device)
    _build.launch(_lib(), "cvt_wgrad_matmul", x, xk.data_ptr(), dyk.data_ptr(), partial.data_ptr(), out.data_ptr(),
                  m, cin, cout, xk.shape[1], dyk.shape[1], rows, int(x.dtype == torch.bfloat16))
    _build.count_launch(wgrad_matmul, x)
    return out


def _padded(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, with zero columns up to a
    multiple of ``COLUMN_STEP``."""
    extra = -t.shape[1] % COLUMN_STEP
    if extra:
        return F.pad(t, (0, extra))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_build.reset_count(wgrad_matmul)
