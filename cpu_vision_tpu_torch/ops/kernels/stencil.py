"""Halo-tiled fused stencil kernels (CUDA, ``csrc/stencil.cu``) and their
plain PyTorch twins.

Counterpart of the JAX package's ``ops/pallas/stencil.py``.  The inputs are
single-channel ``(N, H, W)`` float32 maps (channels fold into N), apart from
the blur's, NHWC frames read as they lie (``fused_gaussian_blur``).  A wrapper
given a CUDA tensor launches its hand-written kernel, adds one to its
``launches`` count, and raises if the launch fails; given a CPU tensor it
runs its plain twin.  Nothing falls back from one to the other.

A twin computes what the Pallas kernel computes, in the same order: reflect
the *image* by the whole halo (numpy ``reflect``), then blur (taps along W,
then along H), Sobel, and whatever follows, each product and sum its own
torch op.  So a twin equals the Pallas kernel bit for bit on the CPU, and
the CUDA kernel (built with ``--fmad=false``) equals the twin on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..._dtype import cast_to_float
from ..._layout import as_tensor, ensure_nhwc, num_channels
from ..color import rgb_to_grayscale
from ..edges import _T_HI, _T_LO, _f32
from ..filters import get_gaussian_kernel1d, reflect_pad_hw
from . import _build

__all__ = [
    "fused_gaussian_blur",
    "canny_stage1",
    "canny_stage1_in_tile",
    "hysteresis_sweeps",
    "fused_blur_sobel",
    "harris_response_fused",
    "fused_canny",
    "hysteresis_fixpoint",
    "gaussian_taps",
    "fused_gaussian_blur_plain",
    "canny_stage1_plain",
    "hysteresis_sweeps_plain",
    "fused_blur_sobel_plain",
    "harris_response_fused_plain",
    "KERNEL_WRAPPERS",
]

# Sweeps per hysteresis pass in the fixpoint, and passes per host check of
# the device-side flags (tools/torch_canny_breakdown.py times the
# alternatives on the card: on the 1080p b8 scene one pass of 4 sweeps and
# one read were the fastest call).
SWEEPS_PER_PASS = 4
PASSES_PER_CHECK = 1
MAX_SWEEPS = 16  # csrc/stencil.cu MAX_SWEEPS
MAX_TAPS = 31    # csrc/stencil.cu MAX_TAPS
IN_TILE = (32, 32)  # csrc/stencil.cu TILE_H, TILE_W: the tile of the in-tile hysteresis
BLUR_CHANNELS = (1, 3, 4)  # channel counts the blur kernel reads as NHWC frames (csrc/stencil.cu blur_strip_kernel)


def gaussian_taps(kernel_size: int, sigma: float) -> np.ndarray:
    """The kernels' f32 Gaussian taps, built on the host with numpy as the
    JAX package's ``stencil._gaussian_taps`` builds them.  For some sizes
    they differ in the last bit from ``ops.get_gaussian_kernel1d``, as the
    JAX package's two do."""
    half = (kernel_size - 1) * 0.5
    x = np.linspace(-half, half, kernel_size, dtype=np.float32)
    pdf = np.exp((-0.5 * np.square(x / np.float32(sigma))).astype(np.float32))
    return (pdf / pdf.sum()).astype(np.float32)


# ------------------------------------------------------------------ library

_c_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("stencil")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        sigs = {
            "cvt_canny_stage1": [p, p, i, i, i, p, i, f, f, i, i, p],
            "cvt_gaussian_blur": [p, p, i, i, i, i, p, i, i, p],
            "cvt_hysteresis_sweeps": [p, p, i, i, i, i, p, p, i, p],
            "cvt_blur_sobel": [p, p, i, i, i, p, i, i, p],
            "cvt_harris": [p, p, i, i, i, p, i, f, i, p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def _launch(name: str, x: torch.Tensor, *args) -> None:
    _build.launch(_lib(), name, x, *args)


def _c_taps(taps: np.ndarray) -> ctypes.Array:
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"kernel_size must be in 1..{MAX_TAPS}, got {len(taps)}")
    return (ctypes.c_float * len(taps))(*taps.tolist())


def _frozen_taps(build: Callable[[int, float], np.ndarray], kernel_size: int,
                 sigma: float) -> Tuple[np.ndarray, ctypes.Array]:
    """``build(kernel_size, sigma)``, made read-only (a cache hands the same array to every caller), and its ctypes
    array."""
    if not 1 <= kernel_size <= MAX_TAPS:
        raise ValueError(f"kernel_size must be in 1..{MAX_TAPS}, got {kernel_size}")
    taps = build(kernel_size, sigma)
    c_taps = _c_taps(taps)
    taps.flags.writeable = False
    return taps, c_taps


@functools.lru_cache(maxsize=32)
def _kernel_taps(kernel_size: int, sigma: float) -> Tuple[np.ndarray, ctypes.Array]:
    """``gaussian_taps(kernel_size, sigma)`` and its ctypes array, built once a ``(kernel_size, sigma)``."""
    return _frozen_taps(gaussian_taps, kernel_size, sigma)


@functools.lru_cache(maxsize=32)
def _canny_taps(kernel_size: int, sigma: float) -> Tuple[np.ndarray, ctypes.Array]:
    """The op-by-op path's taps (``get_gaussian_kernel1d``, which ``fused_canny`` takes) and their ctypes array,
    built once a ``(kernel_size, sigma)``."""
    return _frozen_taps(lambda k, s: get_gaussian_kernel1d(k, s, device="cpu").numpy(), kernel_size, sigma)


def _check_maps(maps: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    if maps.ndim != 3:
        raise ValueError(f"{name} expects (N, H, W) maps, got {tuple(maps.shape)}")
    if maps.dtype != dtype:
        raise TypeError(f"{name} expects {dtype} maps, got {maps.dtype}")
    return maps.contiguous()


def _as_nhw(image) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """HW / HWC / NHWC image -> (N*C, H, W) f32 maps + restore fn."""
    fimg, _ = cast_to_float(as_tensor(image), torch.float32)
    nhwc, restore4 = ensure_nhwc(fimg)
    n, h, w, c = nhwc.shape
    maps = nhwc.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous()

    def restore(x_nhw: torch.Tensor) -> torch.Tensor:
        return restore4(x_nhw.reshape(n, c, h, w).permute(0, 2, 3, 1))

    return maps, restore


def _gray_maps(image) -> Tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """Cast to float first, then float grayscale (no rounding), then
    (N, H, W) f32 maps + restore fn (as ``stencil.py:567-572``)."""
    fimg, _ = cast_to_float(as_tensor(image))
    if num_channels(fimg) > 1:
        fimg = rgb_to_grayscale(fimg)
    nhwc, restore4 = ensure_nhwc(fimg)
    return nhwc[..., 0].to(torch.float32).contiguous(), lambda x: restore4(x[..., None])


# ---------------------------------------------------------- twin pipelines


def _sep_blur(x: torch.Tensor, k: Sequence[float], out_h: int, out_w: int) -> torch.Tensor:
    """Separable blur of the last two axes: taps j=0..K-1 along W over every
    row, then i=0..K-1 along H; output (0,0) uses input (0,0) onward."""
    acc = None
    for j, kv in enumerate(k):
        t = x[..., :, j : j + out_w]
        acc = t * kv if acc is None else acc + t * kv
    out = None
    for i, kv in enumerate(k):
        t = acc[..., i : i + out_h, :]
        out = t * kv if out is None else out + t * kv
    return out


def _sobel_pair(x: torch.Tensor, out_h: int, out_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gx, gy, top-left aligned, in the order of the op-by-op
    path's tap-by-tap accumulation (``stencil.py:327-339``)."""
    s = lambda i, j: x[..., i : i + out_h, j : j + out_w]  # noqa: E731
    gx = s(0, 0) * -1.0
    gx = gx + s(0, 2)
    gx = gx + s(1, 0) * -2.0
    gx = gx + s(1, 2) * 2.0
    gx = gx + s(2, 0) * -1.0
    gx = gx + s(2, 2)
    gy = s(0, 0) * -1.0
    gy = gy + s(0, 1) * -2.0
    gy = gy + s(0, 2) * -1.0
    gy = gy + s(2, 0)
    gy = gy + s(2, 1) * 2.0
    gy = gy + s(2, 2)
    return gx, gy


def fused_gaussian_blur_plain(maps: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Twin of ``cvt_gaussian_blur``: separable blur of (N,H,W) f32 maps."""
    k = taps.tolist()
    h, w = maps.shape[-2:]
    return _sep_blur(reflect_pad_hw(maps, len(k) // 2), k, h, w)


def _grow_in_tiles(cls: torch.Tensor, tile: Tuple[int, int]) -> torch.Tensor:
    """Grow strong (2) through 8-connected weak (1) to a fixpoint inside each
    ``tile`` = (rows, cols) of the (N,H,W) class map on its own: nothing
    crosses a tile's edge or the image's."""
    n, h, w = cls.shape
    th, tw = tile
    ht, wt = -(-h // th) * th, -(-w // tw) * tw
    t = F.pad(cls, (0, wt - w, 0, ht - h))
    t = t.reshape(n, ht // th, th, wt // tw, tw).permute(0, 1, 3, 2, 4)
    while True:
        p = F.pad(t, (1, 1, 1, 1))
        v = torch.maximum(p[..., 1:-1, :], torch.maximum(p[..., :-2, :], p[..., 2:, :]))
        nb = torch.maximum(v[..., 1:-1], torch.maximum(v[..., :-2], v[..., 2:]))
        grown = torch.where((t == 1) & (nb == 2), 2, t).to(cls.dtype)
        if torch.equal(grown, t):
            break
        t = grown
    return t.permute(0, 1, 3, 2, 4).reshape(n, ht, wt)[:, :h, :w].contiguous()


def canny_stage1_plain(maps: torch.Tensor, taps: np.ndarray, low_threshold: float,
                       high_threshold: float, in_tile: Optional[Tuple[int, int]] = None,
                       root: Callable[[torch.Tensor], torch.Tensor] = torch.sqrt) -> torch.Tensor:
    """Twin of ``cvt_canny_stage1``: (N,H,W) f32 -> uint8 class map.  With
    ``in_tile`` = (rows, cols), strong then grows through weak to a fixpoint
    inside each such tile (the kernel's option at its ``IN_TILE``).  ``root``
    takes the magnitude's square root (on the CPU ``torch.sqrt`` may stray
    from the correctly rounded root, which the kernel's ``sqrtf`` is, in the
    last bit)."""
    k = taps.tolist()
    h, w = maps.shape[-2:]
    padded = reflect_pad_hw(maps, len(k) // 2 + 2)  # +1 Sobel, +1 NMS
    b = _sep_blur(padded, k, h + 4, w + 4)
    gx, gy = _sobel_pair(b, h + 2, w + 2)
    mag = root(gx * gx + gy * gy)

    c = lambda a, i, j: a[..., 1 + i : 1 + i + h, 1 + j : 1 + j + w]  # noqa: E731
    m0, gx0, gy0 = c(mag, 0, 0), c(gx, 0, 0), c(gy, 0, 0)
    ax, ay = torch.abs(gx0), torch.abs(gy0)
    d0 = ay < _T_LO * ax
    d90 = ay >= _T_HI * ax
    d45 = ~d0 & ~d90 & ((gx0 * gy0) >= 0)
    nb1 = torch.where(d0, c(mag, 0, 1), torch.where(d45, c(mag, -1, 1), torch.where(d90, c(mag, -1, 0), c(mag, -1, -1))))
    nb2 = torch.where(d0, c(mag, 0, -1), torch.where(d45, c(mag, 1, -1), torch.where(d90, c(mag, 1, 0), c(mag, 1, 1))))
    keep = (m0 >= nb1) & (m0 > nb2)
    sup = torch.where(keep, m0, 0.0)
    strong = sup >= _f32(high_threshold)
    weak = sup >= _f32(low_threshold)
    cls = torch.where(strong, 2, weak.to(torch.uint8))
    return cls if in_tile is None else _grow_in_tiles(cls, in_tile)


def _sweeps_plain(cls: torch.Tensor, sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The class map after ``sweeps - 1`` and after ``sweeps`` steps of ``hysteresis_sweeps_plain``."""
    t = reflect_pad_hw(cls, sweeps)
    before = t
    for _ in range(sweeps):
        before = t
        v = torch.maximum(t[..., 1:-1, :], torch.maximum(t[..., :-2, :], t[..., 2:, :]))
        n = torch.maximum(v[..., 1:-1], torch.maximum(v[..., :-2], v[..., 2:]))
        center = t[..., 1:-1, 1:-1]
        t = torch.where((center == 1) & (n == 2), 2, center).to(cls.dtype)
    return before[..., 1:-1, 1:-1], t


def hysteresis_sweeps_plain(cls: torch.Tensor, sweeps: int = 4) -> torch.Tensor:
    """Twin of ``cvt_hysteresis_sweeps``: ``sweeps`` steps in which a weak
    pixel (1) with a strong (2) 8-neighbour turns strong, on the class map
    reflected by ``sweeps``; each step consumes one ring of the halo."""
    return _sweeps_plain(cls, sweeps)[1]


def fused_blur_sobel_plain(maps: torch.Tensor, taps: np.ndarray,
                           root: Callable[[torch.Tensor], torch.Tensor] = torch.sqrt) -> torch.Tensor:
    """Twin of ``cvt_blur_sobel``: |Sobel| of the blurred (N,H,W) maps.  ``root`` takes the square root of the
    squared magnitude (``canny_stage1_plain``'s ``root``)."""
    k = taps.tolist()
    h, w = maps.shape[-2:]
    padded = reflect_pad_hw(maps, len(k) // 2 + 1)
    b = _sep_blur(padded, k, h + 2, w + 2)
    gx, gy = _sobel_pair(b, h, w)
    return root(gx * gx + gy * gy)


def harris_response_fused_plain(maps: torch.Tensor, taps: np.ndarray, k: float) -> torch.Tensor:
    """Twin of ``cvt_harris``: Sobel -> Ixx/Iyy/Ixy -> separable Gaussian
    window -> det - k·tr² on (N,H,W) maps."""
    k1 = taps.tolist()
    r = len(k1) // 2
    h, w = maps.shape[-2:]
    padded = reflect_pad_hw(maps, 1 + r)
    gx, gy = _sobel_pair(padded, h + 2 * r, w + 2 * r)
    sxx = _sep_blur(gx * gx, k1, h, w)
    syy = _sep_blur(gy * gy, k1, h, w)
    sxy = _sep_blur(gx * gy, k1, h, w)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - _f32(k) * tr * tr


# ----------------------------------------------------------------- wrappers


def canny_stage1(maps: torch.Tensor, low_threshold: float, high_threshold: float,
                 kernel_size: int = 5, sigma: float = 1.4,
                 in_tile_hysteresis: bool = False) -> torch.Tensor:
    """Fused Canny front half: blur → Sobel → magnitude → directional NMS →
    double threshold in one pass.  ``maps`` is (N, H, W) float32 grayscale.
    Returns a (N,H,W) uint8 class map: 2 = strong, 1 = weak, 0 = suppressed.

    ``in_tile_hysteresis``: see ``canny_stage1_in_tile``.
    """
    if in_tile_hysteresis:
        return canny_stage1_in_tile(maps, low_threshold, high_threshold, kernel_size, sigma)
    return _canny_stage1(maps, *_kernel_taps(kernel_size, sigma), low_threshold, high_threshold)


def canny_stage1_in_tile(maps: torch.Tensor, low_threshold: float, high_threshold: float,
                         kernel_size: int = 5, sigma: float = 1.4) -> torch.Tensor:
    """``canny_stage1`` that also grows strong through 8-connected weak to a
    fixpoint inside each ``IN_TILE`` tile of the image, in the block's shared
    memory, before the class map is written.  This class map depends on the
    tiling; the fixpoint of the global hysteresis that follows
    (``hysteresis_fixpoint``) does not.  Chains that cross tiles still take
    their global sweeps: on the inputs measured on the card the option saved
    no global pass (``PERF.md``)."""
    return _canny_stage1(maps, *_kernel_taps(kernel_size, sigma), low_threshold, high_threshold, in_tile=True)


def _canny_stage1(maps: torch.Tensor, taps: np.ndarray, c_taps: ctypes.Array, low_threshold: float,
                  high_threshold: float, in_tile: bool = False) -> torch.Tensor:
    maps = _check_maps(maps, torch.float32, "canny_stage1")
    if not _build.on_card(maps):
        return canny_stage1_plain(maps, taps, low_threshold, high_threshold, IN_TILE if in_tile else None)
    n, h, w = maps.shape
    out = torch.empty((n, h, w), dtype=torch.uint8, device=maps.device)
    _launch("cvt_canny_stage1", maps, maps.data_ptr(), out.data_ptr(), n, h, w, c_taps,
            len(taps), _f32(low_threshold), _f32(high_threshold), int(in_tile), _build.sm_count(maps))
    _build.count_launch(canny_stage1_in_tile if in_tile else canny_stage1, maps)
    return out


def hysteresis_sweeps(cls: torch.Tensor, sweeps: int = 4, changed: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None,
                      last_changed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sweeps`` hysteresis dilation steps in one pass over a (N,H,W)
    uint8 class map (0 = suppressed, 1 = weak, 2 = strong; no other value).

    Each step grows strong into 8-connected weak, exactly one step of
    ``ops.edges.hysteresis``: reflection maps a row or column beyond the
    border onto one already inside the 3x3 neighbourhood, so it adds no
    growth.  ``changed`` (an int32 tensor of one element) is set to 1 when
    any pixel changed and never cleared; ``last_changed`` (the same kind) is
    set to 1 when the last step changed any pixel, and never cleared: when it
    stays 0, the map before the last step was already the fixpoint, and so
    is the result.  ``out`` receives the result (it must not be ``cls``).
    """
    cls = _check_maps(cls, torch.uint8, "hysteresis_sweeps")
    if not 1 <= sweeps <= MAX_SWEEPS:
        raise ValueError(f"sweeps must be in 1..{MAX_SWEEPS}, got {sweeps}")
    if out is None:
        out = torch.empty_like(cls)
    elif out.shape != cls.shape or out.dtype != torch.uint8 or not out.is_contiguous() or out.data_ptr() == cls.data_ptr():
        raise ValueError("out must be a contiguous uint8 tensor of cls's shape, distinct from cls")
    for name, flag in (("changed", changed), ("last_changed", last_changed)):
        if flag is not None and (flag.dtype != torch.int32 or flag.numel() != 1 or flag.device != cls.device):
            raise ValueError(f"{name} must be a one-element int32 tensor on cls's device")
    if not _build.on_card(cls):
        before, res = _sweeps_plain(cls, sweeps)
        if changed is not None:
            changed |= (res != cls).any().to(torch.int32)
        if last_changed is not None:
            last_changed |= (res != before).any().to(torch.int32)
        return out.copy_(res)
    n, h, w = cls.shape
    _launch("cvt_hysteresis_sweeps", cls, cls.data_ptr(), out.data_ptr(), n, h, w, sweeps,
            None if changed is None else changed.data_ptr(),
            None if last_changed is None else last_changed.data_ptr(), _build.sm_count(cls))
    _build.count_launch(hysteresis_sweeps, cls)
    return out


def fused_gaussian_blur(image, kernel_size: int = 5, sigma: float = 1.5) -> torch.Tensor:
    """Separable Gaussian blur in one pass (the float path of
    ``ops.gaussian_blur``; reflect padding), with the kernels' taps
    (``gaussian_taps``).  HW / HWC / NHWC of any dtype in, a contiguous
    float32 tensor of the same shape out.

    On the card, NHWC float32 frames of 1, 3 or 4 channels go to the kernel as
    they lie (a non-contiguous input is made contiguous first), and its output
    is the result: no permuting copy on either side.  Other channel counts run
    the same kernel on (N·C, H, W) maps, permuted there and back."""
    fimg, _ = cast_to_float(as_tensor(image), torch.float32)
    nhwc, restore4 = ensure_nhwc(fimg)
    taps, c_taps = _kernel_taps(kernel_size, sigma)
    n, h, w, c = nhwc.shape
    to_nhwc = lambda maps: maps.reshape(n, c, h, w).permute(0, 2, 3, 1).contiguous()  # noqa: E731
    if not _build.on_card(nhwc):
        return restore4(to_nhwc(fused_gaussian_blur_plain(nhwc.permute(0, 3, 1, 2).reshape(n * c, h, w), taps)))
    if c in BLUR_CHANNELS:
        x, channels = nhwc.contiguous(), c
    else:
        x, channels = nhwc.permute(0, 3, 1, 2).reshape(n * c, h, w).contiguous(), 1
    out = torch.empty_like(x)
    _launch("cvt_gaussian_blur", x, x.data_ptr(), out.data_ptr(), x.shape[0], h, w, channels, c_taps, kernel_size,
            _build.sm_count(x))
    _build.count_launch(fused_gaussian_blur, x)
    return restore4(out if channels == c else to_nhwc(out))


def fused_blur_sobel(image, kernel_size: int = 5, sigma: float = 1.5) -> torch.Tensor:
    """Gaussian blur + Sobel magnitude in one pass; matches
    ``sobel(gaussian_blur(img, k, sigma))`` of the op-by-op path.
    HW / HWC / NHWC in, float32 of the same rank out."""
    maps, restore = _as_nhw(image)
    taps, c_taps = _kernel_taps(kernel_size, sigma)
    if not _build.on_card(maps):
        return restore(fused_blur_sobel_plain(maps, taps))
    n, h, w = maps.shape
    out = torch.empty_like(maps)
    _launch("cvt_blur_sobel", maps, maps.data_ptr(), out.data_ptr(), n, h, w, c_taps, kernel_size,
            _build.sm_count(maps))
    _build.count_launch(fused_blur_sobel, maps)
    return restore(out)


def harris_response_fused(image, k: float = 0.04, window_size: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """Fused Harris response: Sobel → structure tensor → Gaussian window →
    det - k·tr² in one pass; matches ``ops.harris_response`` (Gaussian
    window).  Multi-channel images are converted to grayscale first."""
    maps, restore = _gray_maps(image)
    taps, c_taps = _kernel_taps(window_size, sigma)
    if not _build.on_card(maps):
        return restore(harris_response_fused_plain(maps, taps, k))
    n, h, w = maps.shape
    out = torch.empty_like(maps)
    _launch("cvt_harris", maps, maps.data_ptr(), out.data_ptr(), n, h, w, c_taps, window_size, _f32(k),
            _build.sm_count(maps))
    _build.count_launch(harris_response_fused, maps)
    return restore(out)


KERNEL_WRAPPERS = (canny_stage1, canny_stage1_in_tile, hysteresis_sweeps, fused_blur_sobel,
                   harris_response_fused, fused_gaussian_blur)
for _fn in KERNEL_WRAPPERS:
    _build.reset_count(_fn)


# ---------------------------------------------------------------- pipelines


def hysteresis_fixpoint(cls: torch.Tensor, max_sweeps: Optional[int] = None) -> torch.Tensor:
    """Grow strong (2) through 8-connected weak (1) until nothing changes,
    or for at most ``max_sweeps`` sweeps (the bound ``ops.edges.hysteresis``
    puts on its iterations).

    Passes of ``SWEEPS_PER_PASS`` sweeps ping-pong between two buffers, so
    no pass reads what it writes.  Each pass sets its own device-side flag
    when its last sweep changed anything (``hysteresis_sweeps``'s
    ``last_changed``); the host reads the flags once every
    ``PASSES_PER_CHECK`` passes and stops after a pass whose last sweep
    changed nothing: the map before that sweep was already the fixpoint.
    ``hysteresis_fixpoint.host_reads`` counts the reads (``kernels.reset_launch_counts`` sets it to 0).
    """
    cls = _check_maps(cls, torch.uint8, "hysteresis_fixpoint")
    bufs = [torch.empty_like(cls), None]  # the second at the second pass
    flags = torch.zeros(PASSES_PER_CHECK, dtype=torch.int32, device=cls.device)
    cur, done, nxt = cls, 0, 0
    while True:
        last = -1
        for p in range(PASSES_PER_CHECK):
            k = SWEEPS_PER_PASS if max_sweeps is None else min(SWEEPS_PER_PASS, max_sweeps - done)
            if k <= 0:
                break
            if bufs[nxt] is None:
                bufs[nxt] = torch.empty_like(cls)
            cur = hysteresis_sweeps(cur, k, out=bufs[nxt], last_changed=flags[p : p + 1])
            nxt ^= 1
            done += k
            last = p
        if last < 0:
            return cur
        hysteresis_fixpoint.host_reads += 1
        if not bool(flags[last]):
            return cur
        flags.zero_()


hysteresis_fixpoint.host_reads = 0


def fused_canny(image, low_threshold: float = 0.1, high_threshold: float = 0.2, kernel_size: int = 5,
                sigma: float = 1.4, max_hysteresis_iters: Optional[int] = None) -> torch.Tensor:
    """Full Canny: the fused front half (``canny_stage1``), then the
    hysteresis fixpoint on the same kernels (``hysteresis_sweeps``).
    Semantics of ``ops.canny``; float32 0/1 edge map of the input's rank.

    The blur taps are the op-by-op path's (``get_gaussian_kernel1d``), not
    ``canny_stage1``'s: for some (kernel_size, sigma), (5, 1.4) among them,
    the two differ in the last bit, and on images with tied gradient
    magnitudes that flips NMS decisions.  With the same taps, ``ops.canny``
    gives the same edges on either backend."""
    maps, restore = _gray_maps(image)
    cls = _canny_stage1(maps, *_canny_taps(kernel_size, sigma), low_threshold, high_threshold)
    cls = hysteresis_fixpoint(cls, max_hysteresis_iters)
    edges = torch.empty(cls.shape, dtype=torch.float32, device=cls.device)
    return restore(torch.eq(cls, 2, out=edges))  # one pass: the comparison written as float32
