"""Geometric warps (PyTorch): grid_sample, affine, rotate, perspective,
elastic.

Counterpart of the JAX package's ``ops/warp.py``, matching the reference's
grid-transform pipeline:

* grid sampling — semantics of ``torch.nn.functional.grid_sample`` with
  ``align_corners=False`` and ``padding_mode="zeros"`` (the only config the
  reference uses, ``_functional_tensor.py:560``).
* grid generation — ``_gen_affine_grid`` (``_functional_tensor.py:579-602``),
  ``_perspective_grid`` (``:672-698``).
* fill handling — the appended-mask trick of ``_apply_grid_transform``
  (``_functional_tensor.py:545-576``).

Sampling is a 4-tap gather over the flattened H*W axis with the taps summed
in the JAX package's order, on channels-last images; it does not go through
``F.grid_sample``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._dtype import cast_back, cast_to_float
from .._layout import as_tensor, ensure_nhwc
from .filters import linspace_f32

__all__ = [
    "grid_sample",
    "affine_grid",
    "perspective_grid",
    "warp_affine",
    "affine",
    "rotate",
    "perspective",
    "elastic",
    "get_rotation_matrix",
    "get_inverse_affine_matrix",
]

Fill = Optional[Union[int, float, Sequence[float]]]


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] grid coord -> pixel coord, align_corners=False."""
    return ((coord + 1.0) * size - 1.0) * 0.5


def _gather_2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img (N,H,W,C), iy/ix (N,Ho,Wo) int64 in-range -> (N,Ho,Wo,C)."""
    n, h, w, c = img.shape
    idx = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
    return torch.gather(img.reshape(n, h * w, c), 1, idx).reshape(n, iy.shape[1], iy.shape[2], c)


def grid_sample(
    image: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """Sample ``image`` (N,H,W,C) at ``grid`` (N,Ho,Wo,2) of (x, y) in [-1,1].

    Out-of-range taps contribute 0 (``zeros``) or clamp to the border
    (``border``).  Float images only (cast around it for integers).
    """
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode {mode!r}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    image = as_tensor(image)
    grid = as_tensor(grid).to(image.device)
    n, h, w, c = image.shape
    gx = grid[..., 0]
    gy = grid[..., 1]
    if align_corners:
        x = (gx + 1.0) * 0.5 * (w - 1)
        y = (gy + 1.0) * 0.5 * (h - 1)
    else:
        x = _unnormalize(gx, w)
        y = _unnormalize(gy, h)

    def tap(iy: torch.Tensor, ix: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        return _gather_2d(image, iy.clamp(0, h - 1), ix.clamp(0, w - 1)), valid.to(image.dtype)

    if mode == "nearest":
        # round half to even, as torch's grid sampler (std::nearbyint) does
        out, valid = tap(torch.round(y).to(torch.int64), torch.round(x).to(torch.int64))
        return out * valid[..., None] if padding_mode == "zeros" else out

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    out = torch.zeros((n, grid.shape[1], grid.shape[2], c), dtype=image.dtype, device=image.device)
    for dy in (0, 1):
        for dx in (0, 1):
            wgt = (tx if dx else (1.0 - tx)) * (ty if dy else (1.0 - ty))
            val, valid = tap(y0i + dy, x0i + dx)
            if padding_mode == "zeros":
                wgt = wgt * valid
            out = out + val * wgt[..., None]
    return out


def _base_grid(xg: np.ndarray, yg: np.ndarray, device) -> torch.Tensor:
    """(oh*ow, 3) rows of (x, y, 1)."""
    oh, ow = len(yg), len(xg)
    base = np.stack([np.broadcast_to(xg[None, :], (oh, ow)), np.broadcast_to(yg[:, None], (oh, ow)),
                     np.ones((oh, ow), np.float32)], axis=-1)
    return torch.from_numpy(base.reshape(-1, 3)).to(device)


def _times_3x2(base: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(P,3) @ (3,2) with the three products summed left to right, each
    rounded on its own."""
    return (base[:, 0:1] * m[0] + base[:, 1:2] * m[1]) + base[:, 2:3] * m[2]


def affine_grid(matrix: Sequence[float], w: int, h: int, ow: int, oh: int, device=None) -> torch.Tensor:
    """Sampling grid (1,oh,ow,2) for a 2x3 inverse affine ``matrix``
    (reference ``_gen_affine_grid``, ``_functional_tensor.py:579-602``), on
    ``device`` (default: the first CUDA card)."""
    device = "cuda" if device is None else device
    theta = np.asarray(matrix, np.float32).reshape(2, 3)
    d = 0.5
    xg = linspace_f32(-ow * 0.5 + d, ow * 0.5 + d - 1, ow)
    yg = linspace_f32(-oh * 0.5 + d, oh * 0.5 + d - 1, oh)
    rescaled = torch.from_numpy(theta.T / np.asarray([0.5 * w, 0.5 * h], np.float32)).to(device)
    return _times_3x2(_base_grid(xg, yg, device), rescaled).reshape(1, oh, ow, 2)


def perspective_grid(coeffs: Sequence[float], ow: int, oh: int, device=None) -> torch.Tensor:
    """Sampling grid for 8 perspective coefficients (reference
    ``_perspective_grid``, ``_functional_tensor.py:672-698``)."""
    device = "cuda" if device is None else device
    c = [float(v) for v in coeffs]
    theta1 = np.asarray([[c[0], c[1], c[2]], [c[3], c[4], c[5]]], np.float32)
    theta2 = np.asarray([[c[6], c[7], 1.0], [c[6], c[7], 1.0]], np.float32)
    d = 0.5
    xg = linspace_f32(d, ow * 1.0 + d - 1.0, ow)
    yg = linspace_f32(d, oh * 1.0 + d - 1.0, oh)
    base = _base_grid(xg, yg, device)
    rescaled1 = torch.from_numpy(theta1.T / np.asarray([0.5 * ow, 0.5 * oh], np.float32)).to(device)
    g1 = _times_3x2(base, rescaled1)
    g2 = _times_3x2(base, torch.from_numpy(theta2.T.copy()).to(device))
    return (g1 / g2 - 1.0).reshape(1, oh, ow, 2)


def _apply_grid_transform(image, grid: torch.Tensor, mode: str, fill: Fill) -> torch.Tensor:
    """Reference ``_apply_grid_transform`` (``_functional_tensor.py:545-576``):
    zero-pad sampling, then composite the fill colour through a warped mask."""
    fimg, orig = cast_to_float(as_tensor(image))
    nhwc, restore = ensure_nhwc(fimg)
    n = nhwc.shape[0]
    grid = grid.to(device=nhwc.device, dtype=nhwc.dtype)
    if grid.shape[0] == 1 and n > 1:
        grid = grid.expand(n, *grid.shape[1:])

    if fill is not None:
        mask = torch.ones((n, nhwc.shape[1], nhwc.shape[2], 1), dtype=nhwc.dtype, device=nhwc.device)
        nhwc = torch.cat([nhwc, mask], dim=-1)

    out = grid_sample(nhwc, grid, mode=mode, padding_mode="zeros", align_corners=False)

    if fill is not None:
        mask = out[..., -1:]
        out = out[..., :-1]
        fill_list = list(fill) if isinstance(fill, (tuple, list)) else [float(fill)]
        fill_arr = torch.tensor(fill_list, dtype=out.dtype, device=out.device).reshape(1, 1, 1, -1).expand_as(out)
        if mode == "nearest":
            out = torch.where(mask < 0.5, fill_arr, out)
        else:
            out = out * mask + (1.0 - mask) * fill_arr
    return cast_back(restore(out), orig)


def _hw_device(image) -> Tuple[int, int, torch.device]:
    nhwc, _ = ensure_nhwc(as_tensor(image))
    return nhwc.shape[1], nhwc.shape[2], nhwc.device


def affine(image, matrix: Sequence[float], interpolation: str = "nearest", fill: Fill = None) -> torch.Tensor:
    """Affine transform by a 2x3 *inverse* matrix (output->input), matching
    reference ``affine`` (``_functional_tensor.py:605-618``)."""
    image = as_tensor(image)
    h, w, device = _hw_device(image)
    grid = affine_grid(matrix, w=w, h=h, ow=w, oh=h, device=device)
    return _apply_grid_transform(image, grid, interpolation, fill)


warp_affine = affine


def _compute_affine_output_size(matrix: Sequence[float], w: int, h: int) -> Tuple[int, int]:
    """Expanded canvas size (reference ``_compute_affine_output_size``,
    ``_functional_tensor.py:621-651``)."""
    # float32 on purpose: the reference computes this in float32 and the
    # rounding of near-zero rotation terms (cos 90° = 6e-17 ≈ 0 in f32) is
    # what keeps a 90° expand from growing the canvas by one pixel.
    pts = np.array(
        [
            [-0.5 * w, -0.5 * h, 1.0],
            [-0.5 * w, 0.5 * h, 1.0],
            [0.5 * w, 0.5 * h, 1.0],
            [0.5 * w, -0.5 * h, 1.0],
        ],
        np.float32,
    )
    theta = np.array(matrix, np.float32).reshape(2, 3)
    new_pts = pts @ theta.T
    min_vals = new_pts.min(axis=0) + np.array([w * 0.5, h * 0.5], np.float32)
    max_vals = new_pts.max(axis=0) + np.array([w * 0.5, h * 0.5], np.float32)
    tol = 1e-4
    cmax = np.ceil(np.trunc(max_vals / tol) * tol)
    cmin = np.floor(np.trunc(min_vals / tol) * tol)
    size = cmax - cmin
    return int(size[0]), int(size[1])  # (w, h)


def get_inverse_affine_matrix(
    center: Sequence[float],
    angle: float,
    translate: Sequence[float],
    scale: float,
    shear: Sequence[float],
) -> List[float]:
    """Inverse affine matrix for rotate/translate/scale/shear about ``center``
    (reference ``transforms/functional.py:_get_inverse_affine_matrix``)."""
    rot = math.radians(angle)
    sx = math.radians(shear[0])
    sy = math.radians(shear[1])
    cx, cy = center
    tx, ty = translate

    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)

    # inverse: scale then invert the 2x2, then translations
    matrix = [d, -b, 0.0, -c, a, 0.0]
    matrix = [x / scale for x in matrix]
    matrix[2] += matrix[0] * (-cx - tx) + matrix[1] * (-cy - ty)
    matrix[5] += matrix[3] * (-cx - tx) + matrix[4] * (-cy - ty)
    matrix[2] += cx
    matrix[5] += cy
    return matrix


def get_rotation_matrix(angle: float, center: Tuple[float, float] = (0.0, 0.0)) -> List[float]:
    return get_inverse_affine_matrix(center, angle, (0.0, 0.0), 1.0, (0.0, 0.0))


def rotate(
    image,
    angle: float,
    interpolation: str = "nearest",
    expand: bool = False,
    center: Optional[Tuple[float, float]] = None,
    fill: Fill = None,
) -> torch.Tensor:
    """Rotate counter-clockwise by ``angle`` degrees about ``center``
    (defaults to the image centre), reference ``rotate``
    (``_functional_tensor.py:654-669``)."""
    image = as_tensor(image)
    h, w, device = _hw_device(image)
    if center is None:
        ctr = (0.0, 0.0)
    else:
        # shift to the center-origin frame the matrix works in
        ctr = (center[0] - w * 0.5, center[1] - h * 0.5)
    matrix = get_inverse_affine_matrix(ctr, -angle, (0.0, 0.0), 1.0, (0.0, 0.0))
    ow, oh = _compute_affine_output_size(matrix, w, h) if expand else (w, h)
    grid = affine_grid(matrix, w=w, h=h, ow=ow, oh=oh, device=device)
    return _apply_grid_transform(image, grid, interpolation, fill)


def perspective(image, coeffs: Sequence[float], interpolation: str = "bilinear", fill: Fill = None) -> torch.Tensor:
    """Perspective warp by 8 coefficients (reference ``perspective``,
    ``_functional_tensor.py:701-724``)."""
    image = as_tensor(image)
    h, w, device = _hw_device(image)
    grid = perspective_grid(coeffs, ow=w, oh=h, device=device)
    return _apply_grid_transform(image, grid, interpolation, fill)


def elastic(image, displacement, interpolation: str = "bilinear", fill: Fill = None) -> torch.Tensor:
    """Elastic warp: identity grid + ``displacement`` (1,H,W,2) in normalised
    units (reference ``elastic_transform``, ``_functional_tensor.py:947``)."""
    image = as_tensor(image)
    h, w, device = _hw_device(image)
    # identity grid in [-1, 1], align_corners=False convention
    xg = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w * 2.0 - 1.0
    yg = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h * 2.0 - 1.0
    base = torch.stack([xg[None, :].expand(h, w), yg[:, None].expand(h, w)], dim=-1)[None]
    grid = base + as_tensor(displacement).to(device=device, dtype=torch.float32)
    return _apply_grid_transform(image, grid, interpolation, fill)
