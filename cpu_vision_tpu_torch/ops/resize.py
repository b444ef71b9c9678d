"""Image resize with reference-parity semantics (PyTorch).

Counterpart of the JAX package's ``ops/resize.py``.  Matches
``torch.nn.functional.interpolate`` (and therefore the reference's
``resize``, torchvision ``transforms/_functional_tensor.py:441-474``) for
``nearest`` / ``nearest-exact`` / ``bilinear`` / ``bicubic``, with and
without antialias, including the uint8 cast/round/clamp protocol.

Resampling along each axis is a dense weight-matrix contraction: the
matrices are the JAX package's own (built with NumPy in float64, stored as
float32) and are contracted in full float32, so uint8 results round as the
JAX package's do; ``F.interpolate`` does not for antialias.  For ``nearest``
it is a pure gather.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .._dtype import cast_back, cast_to_float, full_float32, is_integer_dtype
from .._layout import as_tensor, ensure_nhwc

__all__ = ["resize", "resize_weight_matrix", "rescale"]


def _cubic_filter(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (Keys), ``a=-0.75`` like torch/OpenCV."""
    x = np.abs(x)
    out = np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )
    return out


def _triangle_filter(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_weight_matrix(
    in_size: int,
    out_size: int,
    mode: str = "bilinear",
    antialias: bool = True,
) -> np.ndarray:
    """Dense ``(out_size, in_size)`` resampling weights for one axis.

    Replicates aten's index/weight computation:

    * no antialias: ``center = (o + 0.5) * scale - 0.5``; bilinear takes
      2 taps, bicubic 4 taps (cubic a=-0.75), indices clamped to the edge.
    * antialias: filter support scaled by ``max(scale, 1)``, taps from
      ``floor(center - support + 0.5)``, weights normalised — identical to
      PIL's convolution resampling (cubic a=-0.5).
    """
    if mode not in ("bilinear", "bicubic"):
        raise ValueError(f"weights only for bilinear/bicubic, got {mode}")
    scale = in_size / out_size
    support_base = 1.0 if mode == "bilinear" else 2.0
    if mode == "bilinear":
        filt = _triangle_filter
    elif antialias:
        filt = lambda x: _cubic_filter(x, a=-0.5)  # noqa: E731
    else:
        filt = _cubic_filter
    w = np.zeros((out_size, in_size), np.float64)

    if antialias:
        # torch takes this path whenever antialias=True: upscales keep
        # support_base but still normalise the boundary weights
        kscale = max(scale, 1.0)
        support = support_base * kscale
        inv_scale = 1.0 / kscale
        for o in range(out_size):
            center = scale * (o + 0.5)
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), in_size)
            x = (np.arange(xmin, xmax) - center + 0.5) * inv_scale
            ww = filt(x)
            s = ww.sum()
            if s != 0:
                ww = ww / s
            w[o, xmin:xmax] = ww
    else:
        for o in range(out_size):
            center = (o + 0.5) * scale - 0.5
            i0 = math.floor(center)
            t = center - i0
            if mode == "bilinear":
                taps = [(i0, 1.0 - t), (i0 + 1, t)]
            else:
                offs = np.array([-1, 0, 1, 2])
                taps = [(i0 + int(d), float(v)) for d, v in zip(offs, _cubic_filter(offs - t))]
            for idx, val in taps:
                w[o, min(max(idx, 0), in_size - 1)] += val
    return w.astype(np.float32)


def _nearest_indices(in_size: int, out_size: int, exact: bool) -> np.ndarray:
    o = np.arange(out_size, dtype=np.float64)
    scale = in_size / out_size
    idx = np.floor((o + 0.5) * scale) if exact else np.floor(o * scale)
    return np.clip(idx, 0, in_size - 1).astype(np.int64)


def resize(
    image,
    size: Sequence[int],
    interpolation: str = "bilinear",
    antialias: bool = True,
) -> torch.Tensor:
    """Resize to ``size = (height, width)``.

    Reference semantics (``resize``, ``_functional_tensor.py:441-474``):
    antialias only applies to bilinear/bicubic; integer inputs are computed
    in float32 and rounded back; bicubic integer results are clamped.
    """
    oh, ow = int(size[0]), int(size[1])
    image = as_tensor(image)
    if interpolation in ("nearest", "nearest-exact"):
        nhwc, restore = ensure_nhwc(image)
        ih, iw = nhwc.shape[1], nhwc.shape[2]
        exact = interpolation == "nearest-exact"
        if (ih, iw) != (oh, ow):
            hi = torch.from_numpy(_nearest_indices(ih, oh, exact)).to(nhwc.device)
            wi = torch.from_numpy(_nearest_indices(iw, ow, exact)).to(nhwc.device)
            nhwc = nhwc.index_select(1, hi).index_select(2, wi)
        return restore(nhwc)

    if interpolation not in ("bilinear", "bicubic"):
        raise ValueError(f"unsupported interpolation {interpolation!r}")

    fimg, orig = cast_to_float(image)
    nhwc, restore = ensure_nhwc(fimg)
    ih, iw = nhwc.shape[1], nhwc.shape[2]
    with full_float32():
        if ih != oh:
            wh = torch.from_numpy(resize_weight_matrix(ih, oh, interpolation, antialias)).to(nhwc)
            nhwc = torch.einsum("oi,nixc->noxc", wh, nhwc)
        if iw != ow:
            ww = torch.from_numpy(resize_weight_matrix(iw, ow, interpolation, antialias)).to(nhwc)
            nhwc = torch.einsum("oi,nxic->nxoc", ww, nhwc)
    return cast_back(restore(nhwc), orig)  # cast_back clamps integer results


def rescale(
    image,
    factor: Union[float, Tuple[float, float]],
    interpolation: str = "bilinear",
    antialias: bool = True,
) -> torch.Tensor:
    """Resize by a scale factor (output size = floor(in * factor))."""
    fh, fw = (factor, factor) if isinstance(factor, (int, float)) else factor
    nhwc, _ = ensure_nhwc(as_tensor(image))
    oh = max(1, int(nhwc.shape[1] * fh))
    ow = max(1, int(nhwc.shape[2] * fw))
    return resize(image, (oh, ow), interpolation, antialias)
