"""Edge and corner detectors (PyTorch): Canny, Harris.

Op-by-op counterpart of the JAX package's ``ops/edges.py``.  Canny:
Gaussian smoothing → Sobel gradients → 4-direction non-maximum suppression
→ double threshold → hysteresis by iterated masked dilation.  On a CUDA
tensor ``canny`` runs the fused kernels of ``ops.kernels`` instead.

Harris: structure tensor from Sobel gradients, Gaussian (or box) window,
response ``det(M) - k·tr(M)²``, then threshold + 3x3 local NMS + top-k.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._dtype import cast_to_float
from .._layout import as_tensor, ensure_nhwc, num_channels
from .color import rgb_to_grayscale
from .filters import (
    _depthwise_conv_valid,
    gaussian_blur,
    get_gaussian_kernel1d,
    pad2d,
    reflect_pad_hw,
    sobel_gradients,
    sobel_kernels,
)

__all__ = [
    "canny",
    "canny_nms",
    "hysteresis",
    "harris_response",
    "harris",
]

_T_LO = float(np.float32(0.41421356))  # tan 22.5°
_T_HI = float(np.float32(2.4142137))   # tan 67.5°


def _f32(v: float) -> float:
    """``v`` rounded to float32: thresholds and factors act as float32
    values, as JAX's weakly typed Python scalars do."""
    return float(np.float32(v))


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift an (N,H,W) map by (dy,dx), zero-filling (for neighbour access)."""
    h, w = x.shape[-2:]
    padded = F.pad(x, (1, 1, 1, 1))
    return padded[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _rshift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift an (N,H,W) map by (dy,dx), reflecting at the border."""
    h, w = x.shape[-2:]
    return reflect_pad_hw(x, 1)[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def canny_nms(mag: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Directional non-maximum suppression of a gradient magnitude map.

    ``mag/gx/gy`` are (N,H,W).  The gradient direction is quantised to 4
    bins (0°, 45°, 90°, 135°) by ratio tests, without atan2; a pixel
    survives when its magnitude is >= the neighbour ahead and > the one
    behind along that direction.  Neighbours come from a reflect ring.
    """
    ax, ay = torch.abs(gx), torch.abs(gy)
    d0 = ay < _T_LO * ax
    d90 = ay >= _T_HI * ax
    d45 = ~d0 & ~d90 & ((gx * gy) >= 0)
    # else 135°
    n_e, n_w = _rshift(mag, 0, 1), _rshift(mag, 0, -1)      # 0°: horizontal
    n_ne, n_sw = _rshift(mag, -1, 1), _rshift(mag, 1, -1)   # 45°
    n_n, n_s = _rshift(mag, -1, 0), _rshift(mag, 1, 0)      # 90°
    n_nw, n_se = _rshift(mag, -1, -1), _rshift(mag, 1, 1)   # 135°
    nb1 = torch.where(d0, n_e, torch.where(d45, n_ne, torch.where(d90, n_n, n_nw)))
    nb2 = torch.where(d0, n_w, torch.where(d45, n_sw, torch.where(d90, n_s, n_se)))
    keep = (mag >= nb1) & (mag > nb2)
    return torch.where(keep, mag, 0.0)


def hysteresis(strong: torch.Tensor, weak: torch.Tensor, max_iters: Optional[int] = None,
               steps_per_iter: int = 1) -> torch.Tensor:
    """Grow ``strong`` (N,H,W bool) through 8-connected ``weak`` pixels until
    a fixpoint, or for at most ``max_iters`` iterations.  Returns the final
    strong mask.  ``steps_per_iter`` propagation steps run between
    convergence checks (growth is monotone, so the result is the same).
    The host reads the convergence check once per iteration."""

    def dilate(m: torch.Tensor) -> torch.Tensor:
        # separable 3x3 OR-dilation
        v = m | _shift(m, -1, 0) | _shift(m, 1, 0)
        return v | _shift(v, 0, -1) | _shift(v, 0, 1)

    mask, changed, it = strong, True, 0
    while changed and (max_iters is None or it < max_iters):
        grown = mask
        for _ in range(steps_per_iter):
            grown = dilate(grown) & weak | grown
        changed = bool(torch.any(grown != mask))
        mask, it = grown, it + steps_per_iter
    return mask


def canny(
    image,
    low_threshold: float = 0.1,
    high_threshold: float = 0.2,
    kernel_size: int = 5,
    sigma: float = 1.4,
    use_hysteresis: bool = True,
    max_hysteresis_iters: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Canny edge map.  Thresholds are on the Sobel gradient magnitude of the
    smoothed image (same value scale as the input: ~[0,1] thresholds for
    float images in [0,1], 0..255-scale thresholds for uint8 inputs).

    Returns a float32 edge mask (values 0/1) of the input's spatial rank.

    ``backend``: "kernel" (the fused CUDA kernels; their plain twins on a
    CPU tensor), "plain" (op-by-op), or None: "kernel" for a CUDA tensor,
    "plain" for a CPU one.
    """
    image = as_tensor(image)
    if backend is None:
        backend = "kernel" if image.device.type == "cuda" else "plain"
    if backend not in ("kernel", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "kernel" and use_hysteresis:
        from .kernels import fused_canny

        return fused_canny(image, low_threshold, high_threshold, kernel_size, sigma, max_hysteresis_iters)
    fimg, _ = cast_to_float(image)
    if num_channels(fimg) > 1:
        fimg = rgb_to_grayscale(fimg)
    nhwc, restore = ensure_nhwc(fimg)

    blurred = gaussian_blur(nhwc, kernel_size, sigma)
    gx4, gy4 = sobel_gradients(blurred)
    gx, gy = gx4[..., 0], gy4[..., 0]  # (N,H,W)
    mag = torch.sqrt(gx * gx + gy * gy)

    suppressed = canny_nms(mag, gx, gy)
    strong = suppressed >= _f32(high_threshold)
    weak = suppressed >= _f32(low_threshold)
    edges = hysteresis(strong, weak, max_hysteresis_iters) if use_hysteresis else strong
    return restore(edges[..., None].to(torch.float32))


def harris_response(image, k: float = 0.04, window_size: int = 5, sigma: float = 1.0,
                    window: str = "gaussian") -> torch.Tensor:
    """Harris corner response ``det(M) - k·tr(M)²`` with a smoothed structure
    tensor.  Returns a float map of the input's spatial rank."""
    fimg, _ = cast_to_float(as_tensor(image))
    if num_channels(fimg) > 1:
        fimg = rgb_to_grayscale(fimg)
    nhwc, restore = ensure_nhwc(fimg)

    # one reflect of the *image* by the whole halo (Sobel + window)
    r = window_size // 2
    padded = pad2d(nhwc, 1 + r, mode="reflect")
    gx_k, gy_k = sobel_kernels(padded.dtype, padded.device)
    gx = _depthwise_conv_valid(padded, gx_k)  # (n, h+2r, w+2r, c)
    gy = _depthwise_conv_valid(padded, gy_k)
    ixx, iyy, ixy = gx * gx, gy * gy, gx * gy

    if window == "gaussian":
        k1 = get_gaussian_kernel1d(window_size, sigma, device=fimg.device)
        win = torch.outer(k1, k1)
    elif window == "box":
        win = torch.full((window_size, window_size), 1.0 / window_size**2, dtype=torch.float32, device=fimg.device)
    else:
        raise ValueError(f"unknown window {window!r}")
    sxx = _depthwise_conv_valid(ixx, win)
    syy = _depthwise_conv_valid(iyy, win)
    sxy = _depthwise_conv_valid(ixy, win)

    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return restore(det - _f32(k) * trace * trace)


def harris(image, max_corners: int = 100, k: float = 0.04, quality_level: float = 0.01,
           window_size: int = 5, sigma: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Harris corner detection with 3x3 local NMS and top-k selection.

    Returns ``(coords, scores, valid)`` with fixed shapes: coords (K,2) as
    (row, col), scores (K,), valid (K,) bool; padded entries have
    valid=False.  Single image input (HW or HWC).  Entries of equal score
    may come in another order than in the JAX package.
    """
    resp = harris_response(image, k=k, window_size=window_size, sigma=sigma)
    r = resp if resp.ndim == 2 else resp[..., 0]
    h, w = r.shape

    # 3x3 local NMS
    r3 = r[None]
    local_max = r3
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            local_max = torch.maximum(local_max, _shift(r3, dy, dx))
    is_peak = (r3 >= local_max)[0] & (r > _f32(quality_level) * torch.max(r))

    scores = torch.where(is_peak, r, -torch.inf).reshape(-1)
    top_scores, top_idx = torch.topk(scores, max_corners)
    coords = torch.stack([top_idx // w, top_idx % w], dim=-1)
    valid = torch.isfinite(top_scores)
    return coords, torch.where(valid, top_scores, 0.0), valid
