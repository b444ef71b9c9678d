"""RoIAlign (NHWC): ``roi_align`` and ``roi_align_pyramid``.

Counterpart of the JAX package's ``ops/roi.py``, which follows the
reference's C++ kernel (``csrc/ops/cpu/roi_align_kernel.cpp:12-108`` and the
bilinear tap rules of ``roi_align_common.h:35-78``): the ``aligned`` -0.5
offset, the not-aligned min-size-1 rule, the outside-[-1, size] zero rule
and adaptive ``sampling_ratio=-1``.  The same formulation: one gather of the
four bilinear taps of every sample and a weighted sum, the taps' weights in
the features' dtype, the pooling sum in float32 and cast back.
``ps_roi_align``, ``roi_pool`` and ``ps_roi_pool`` are not ported yet.

Features are (N, H, W, C); ``rois`` are (K, 5) rows of ``(batch_index, x1,
y1, x2, y2)`` in input coordinates.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

__all__ = ["roi_align", "roi_align_pyramid"]


def _as_pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _roi_geometry(rois, spatial_scale, ph_out, pw_out, aligned):
    offset = 0.5 if aligned else 0.0
    batch_ind = rois[:, 0].to(torch.int64)
    start_w = rois[:, 1] * spatial_scale - offset
    start_h = rois[:, 2] * spatial_scale - offset
    end_w = rois[:, 3] * spatial_scale - offset
    end_h = rois[:, 4] * spatial_scale - offset
    roi_w = end_w - start_w
    roi_h = end_h - start_h
    if not aligned:
        roi_w = roi_w.clamp_min(1.0)
        roi_h = roi_h.clamp_min(1.0)
    bin_h = roi_h / ph_out
    bin_w = roi_w / pw_out
    return batch_ind, start_h, start_w, roi_h, roi_w, bin_h, bin_w


def _bilinear_gather(features, batch_ind, y, x, valid, h_eff=None, w_eff=None, y_off=None):
    """The bilinear taps of every sample, weighted and masked.

    features (N, H, W, C); y (K, PH, IY); x (K, PW, IX); valid (K, PH, PW, IY,
    IX).  Returns (K, PH, PW, IY, IX, C).  ``h_eff``/``w_eff``/``y_off`` (K,)
    give each roi its own map extent and row offset, for the
    row-concatenated pyramid of ``roi_align_pyramid``: the clamping and
    outside rules use the roi's level, the indices the concatenated map.
    """
    n, h, w, c = features.shape
    if h_eff is None:
        h3 = h5 = h
        w3 = w5 = w
        off3 = 0
    else:
        h3, h5 = h_eff[:, None, None], h_eff[:, None, None, None, None]
        w3, w5 = w_eff[:, None, None], w_eff[:, None, None, None, None]
        off3 = y_off[:, None, None]
    # outside-the-map rule of the C++ kernel (roi_align_common.h:41-47):
    # samples with y < -1 or y > H (resp. x) contribute exactly 0
    yb, xb = y[:, :, None, :, None], x[:, None, :, None, :]
    valid = valid & (yb >= -1.0) & (yb <= h5) & (xb >= -1.0) & (xb <= w5)

    y = y.clamp_min(0.0)
    x = x.clamp_min(0.0)
    y_low = y.to(torch.int64)
    x_low = x.to(torch.int64)
    y_edge = y_low >= h3 - 1
    x_edge = x_low >= w3 - 1
    y_high = torch.where(y_edge, h3 - 1, y_low + 1)
    y_low = torch.where(y_edge, h3 - 1, y_low)
    y = torch.where(y_edge, y_low.to(y.dtype), y)
    x_high = torch.where(x_edge, w3 - 1, x_low + 1)
    x_low = torch.where(x_edge, w3 - 1, x_low)
    x = torch.where(x_edge, x_low.to(x.dtype), x)

    # the weights ride the features' dtype, as in the JAX package
    wdt = features.dtype if features.dtype.is_floating_point else torch.float32
    ly = (y - y_low).to(wdt)  # (K, PH, IY)
    lx = (x - x_low).to(wdt)  # (K, PW, IX)
    hy = 1.0 - ly
    hx = 1.0 - lx

    flat = features.reshape(n * h * w, c)
    base = batch_ind[:, None, None, None, None] * (h * w)

    def tap(yi, xi):
        idx = base + (yi + off3)[:, :, None, :, None] * w + xi[:, None, :, None, :]
        return flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c)

    def wprod(wy, wx):
        return (wy[:, :, None, :, None] * wx[:, None, :, None, :])[..., None]

    out = (tap(y_low, x_low) * wprod(hy, hx)
           + tap(y_low, x_high) * wprod(hy, lx)
           + tap(y_high, x_low) * wprod(ly, hx)
           + tap(y_high, x_high) * wprod(ly, lx))
    return out * valid[..., None].to(out.dtype)


def _sample_coords(start, bin_sz, grid, n_out, n_samp):
    """y/x sample coordinates (K, n_out, n_samp): bin start + (i+0.5)/grid."""
    p = torch.arange(n_out, dtype=torch.float32, device=start.device)
    i = torch.arange(n_samp, dtype=torch.float32, device=start.device)
    return (start[:, None, None] + p[None, :, None] * bin_sz[:, None, None]
            + (i[None, None, :] + 0.5) * (bin_sz / grid)[:, None, None])


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: Union[int, Sequence[int]],
    spatial_scale: float = 1.0,
    sampling_ratio: int = -1,
    aligned: bool = False,
    adaptive_max_grid: int = 16,
) -> torch.Tensor:
    """RoIAlign average pooling -> (K, PH, PW, C).

    ``sampling_ratio > 0``: exactly that many samples per bin axis.
    ``sampling_ratio = -1``: adaptive ``ceil(roi_size / output_size)`` like
    the reference, on a static grid of ``adaptive_max_grid`` masked samples
    (rois needing more are averaged over the first ``adaptive_max_grid``
    samples per axis).
    """
    ph_out, pw_out = _as_pair(output_size)
    k = rois.shape[0]
    dev = rois.device
    batch_ind, start_h, start_w, roi_h, roi_w, bin_h, bin_w = _roi_geometry(rois, spatial_scale, ph_out, pw_out,
                                                                            aligned)
    if sampling_ratio > 0:
        gh = torch.full((k,), float(sampling_ratio), dtype=torch.float32, device=dev)
        gw = gh
        iy = ix = sampling_ratio
        count = torch.full((k,), float(max(sampling_ratio * sampling_ratio, 1)), dtype=torch.float32, device=dev)
        valid = torch.ones((k, ph_out, pw_out, iy, ix), dtype=torch.bool, device=dev)
    else:
        gh = torch.ceil(roi_h / ph_out).clamp(1.0, adaptive_max_grid)
        gw = torch.ceil(roi_w / pw_out).clamp(1.0, adaptive_max_grid)
        iy = ix = adaptive_max_grid
        grid = torch.arange(iy, device=dev)
        ymask = grid[None, :] < gh[:, None]  # (K, IY)
        xmask = grid[None, :] < gw[:, None]
        valid = (ymask[:, None, None, :, None] & xmask[:, None, None, None, :]).expand(k, ph_out, pw_out, iy, ix)
        count = (gh * gw).clamp_min(1.0)

    y = _sample_coords(start_h, bin_h, gh, ph_out, iy)
    x = _sample_coords(start_w, bin_w, gw, pw_out, ix)
    val = _bilinear_gather(features, batch_ind, y, x, valid)  # (K, PH, PW, IY, IX, C)
    acc = val.sum(dim=(3, 4), dtype=torch.float32)
    return (acc / count[:, None, None, None]).to(val.dtype)


def _per_level(levels: torch.Tensor, table: Sequence, dtype: torch.dtype) -> torch.Tensor:
    """``table[levels]`` built on ``levels``' device from the Python values
    (no copy from host memory, which would wait for the card's queue)."""
    out = torch.zeros(levels.shape, dtype=dtype, device=levels.device)
    for i, value in enumerate(table):
        out = torch.where(levels == i, torch.tensor(value, dtype=dtype), out)
    return out


def roi_align_pyramid(
    features: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    output_size: Union[int, Sequence[int]],
    scales: Sequence[float],
    sampling_ratio: int = 2,
    aligned: bool = False,
) -> torch.Tensor:
    """RoIAlign each roi once, at its assigned FPN level -> (K, PH, PW, C).

    One gather over a row-concatenated pyramid: the levels stack along H
    (narrow levels zero-padded to the widest W, never read: x is clamped to
    the level's own width), and each roi's sample coordinates use its level's
    ``spatial_scale`` and row offset; the clamping and outside rules ride
    per-roi bounds, so each roi gets exactly ``roi_align`` at its level.

    ``features``: per-level (N, H_l, W_l, C); ``levels``: (K,) integers;
    ``sampling_ratio`` must be > 0 (detection uses 2).
    """
    if sampling_ratio <= 0:
        raise ValueError("roi_align_pyramid requires a static sampling_ratio > 0")
    ph_out, pw_out = _as_pair(output_size)
    k = rois.shape[0]
    dev = rois.device
    w0 = features[0].shape[2]
    hs = [int(f.shape[1]) for f in features]
    ws = [int(f.shape[2]) for f in features]
    offs = [0]
    for hh in hs[:-1]:
        offs.append(offs[-1] + hh)
    big = torch.cat([f if f.shape[2] == w0 else torch.nn.functional.pad(f, (0, 0, 0, w0 - f.shape[2]))
                     for f in features], dim=1)  # (N, sum(H_l), W0, C)

    scale_v = _per_level(levels, scales, torch.float32)
    h_v, w_v, off_v = (_per_level(levels, table, torch.int64) for table in (hs, ws, offs))

    batch_ind, start_h, start_w, roi_h, roi_w, bin_h, bin_w = _roi_geometry(rois, scale_v, ph_out, pw_out, aligned)
    gh = torch.full((k,), float(sampling_ratio), dtype=torch.float32, device=dev)
    iy = ix = sampling_ratio
    count = float(max(sampling_ratio * sampling_ratio, 1))
    valid = torch.ones((k, ph_out, pw_out, iy, ix), dtype=torch.bool, device=dev)
    y = _sample_coords(start_h, bin_h, gh, ph_out, iy)
    x = _sample_coords(start_w, bin_w, gh, pw_out, ix)
    val = _bilinear_gather(big, batch_ind, y, x, valid, h_eff=h_v, w_eff=w_v, y_off=off_v)
    acc = val.sum(dim=(3, 4), dtype=torch.float32)
    return (acc / count).to(val.dtype)
