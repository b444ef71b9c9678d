"""Color / intensity ops with reference parity (PyTorch).

Counterpart of the JAX package's ``ops/color.py``.  Reference: torchvision
``transforms/_functional_tensor.py`` — ``rgb_to_grayscale`` (:151-168),
``adjust_brightness/contrast/saturation/hue/gamma`` (:171-255), ``_blend``
(:258-261), ``_rgb2hsv``/``_hsv2rgb`` (:264-321), ``invert/posterize/
solarize`` (:767-806), ``autocontrast`` (:841-860), ``equalize`` (:863-902),
``normalize`` (:905+).  All ops are channels-last (HW / HWC / NHWC).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .._dtype import cast_back, cast_to_float, is_integer_dtype, max_value, to_dtype
from .._layout import as_tensor, ensure_nhwc, num_channels

__all__ = [
    "rgb_to_grayscale",
    "grayscale_to_rgb",
    "rgb_to_hsv",
    "hsv_to_rgb",
    "adjust_brightness",
    "adjust_contrast",
    "adjust_saturation",
    "adjust_hue",
    "adjust_gamma",
    "invert",
    "posterize",
    "solarize",
    "autocontrast",
    "equalize",
    "normalize",
    "blend",
]


def blend(img1, img2, ratio: float) -> torch.Tensor:
    """``ratio * img1 + (1 - ratio) * img2`` clamped to the dtype range
    (reference ``_blend``, ``:258-261``)."""
    ratio = float(ratio)
    img1 = as_tensor(img1)
    f1, orig = cast_to_float(img1)
    f2, _ = cast_to_float(as_tensor(img2).to(img1.device))
    return cast_back(torch.clamp(ratio * f1 + (1.0 - ratio) * f2, 0, max_value(orig)), orig)


def rgb_to_grayscale(image, num_output_channels: int = 1) -> torch.Tensor:
    """ITU-R 601-2 luma; integer results are rounded via the cast-back
    protocol.  A one-channel image passes through (an HW image gains its
    channel axis)."""
    image = as_tensor(image)
    if num_channels(image) == 1:
        l_img = image[..., None] if image.ndim == 2 else image
    else:
        fimg, orig = cast_to_float(image)
        r, g, b = fimg[..., 0], fimg[..., 1], fimg[..., 2]
        l_img = cast_back(0.2989 * r + 0.587 * g + 0.114 * b, orig)[..., None]
    if num_output_channels == 3:
        l_img = l_img.repeat_interleave(3, dim=-1)
    return l_img


def grayscale_to_rgb(image) -> torch.Tensor:
    image = as_tensor(image)
    if image.ndim == 2:
        image = image[..., None]
    return image.repeat_interleave(3, dim=-1) if image.shape[-1] == 1 else image


def rgb_to_hsv(image) -> torch.Tensor:
    """Float RGB (..., 3) in [0,1] -> HSV, reference ``_rgb2hsv`` (:264-300)."""
    image = as_tensor(image)
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    maxc = image.amax(dim=-1)
    minc = image.amin(dim=-1)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    cr_div = torch.where(eqc, ones, cr)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    hr = (maxc == r) * (bc - gc)
    hg = ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
    hb = ((maxc != g) & (maxc != r)) * (4.0 + gc - rc)
    h = hr + hg + hb
    h = torch.remainder(h / 6.0 + 1.0, 1.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(image) -> torch.Tensor:
    """Float HSV (..., 3) -> RGB, reference ``_hsv2rgb`` (:303-321)."""
    image = as_tensor(image)
    h, s, v = image[..., 0], image[..., 1], image[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = (i.to(torch.int64) % 6)[..., None]
    p = torch.clamp(v * (1.0 - s), 0.0, 1.0)
    q = torch.clamp(v * (1.0 - s * f), 0.0, 1.0)
    t = torch.clamp(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    # select per sextant
    r = torch.stack([v, q, p, p, t, v], dim=-1).gather(-1, i)
    g = torch.stack([t, v, v, q, p, p], dim=-1).gather(-1, i)
    b = torch.stack([p, p, t, v, v, q], dim=-1).gather(-1, i)
    return torch.cat([r, g, b], dim=-1)


def adjust_brightness(image, brightness_factor: float) -> torch.Tensor:
    if brightness_factor < 0:
        raise ValueError("brightness_factor must be non-negative")
    image = as_tensor(image)
    return blend(image, torch.zeros_like(image), brightness_factor)


def adjust_contrast(image, contrast_factor: float) -> torch.Tensor:
    if contrast_factor < 0:
        raise ValueError("contrast_factor must be non-negative")
    image = as_tensor(image)
    fimg, _ = cast_to_float(image)
    if num_channels(image) == 3:
        gray = 0.2989 * fimg[..., 0] + 0.587 * fimg[..., 1] + 0.114 * fimg[..., 2]
        if is_integer_dtype(image.dtype):
            gray = torch.round(gray)  # reference greys through rgb_to_grayscale's round
    else:
        gray = fimg[..., 0] if fimg.ndim >= 3 else fimg
    # per-image mean over H, W (grayscale is single-channel)
    mean = gray.mean(dim=(-2, -1), keepdim=True)
    if fimg.ndim >= 3:
        mean = mean[..., None]
    return blend(image, mean.expand(fimg.shape), contrast_factor)


def adjust_saturation(image, saturation_factor: float) -> torch.Tensor:
    if saturation_factor < 0:
        raise ValueError("saturation_factor must be non-negative")
    image = as_tensor(image)
    if num_channels(image) == 1:
        return image
    return blend(image, rgb_to_grayscale(image, num_output_channels=3), saturation_factor)


def adjust_hue(image, hue_factor: float) -> torch.Tensor:
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    image = as_tensor(image)
    if num_channels(image) == 1:
        return image
    orig = image.dtype
    hsv = rgb_to_hsv(to_dtype(image, torch.float32, scale=True))
    h = torch.remainder(hsv[..., 0] + hue_factor, 1.0)
    rgb = hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))
    return to_dtype(rgb, orig, scale=True)


def adjust_gamma(image, gamma: float, gain: float = 1.0) -> torch.Tensor:
    if gamma < 0:
        raise ValueError("gamma must be non-negative")
    image = as_tensor(image)
    fimg = to_dtype(image, torch.float32, scale=True)
    out = torch.clamp(gain * fimg**gamma, 0.0, 1.0)
    return to_dtype(out, image.dtype, scale=True)


def invert(image) -> torch.Tensor:
    """``max - img`` (reference ``invert``, ``:767-776``)."""
    image = as_tensor(image)
    bound = max_value(image.dtype)
    if is_integer_dtype(image.dtype):
        return (int(bound) - image).to(image.dtype)
    return bound - image


def posterize(image, bits: int) -> torch.Tensor:
    """Keep the top ``bits`` bits (reference uint8 path ``:779-790``; float
    path = quantise to ``2**bits`` levels, v2 ``_color.py:462-472``)."""
    image = as_tensor(image)
    if image.dtype.is_floating_point:
        levels = 1 << bits
        return torch.clamp(torch.floor(image * levels), 0, levels - 1) * (1.0 / levels)
    if image.dtype != torch.uint8:
        raise TypeError("posterize expects uint8 or float")
    return image & (256 - 2 ** (8 - bits) if bits < 8 else 255)


def solarize(image, threshold: float) -> torch.Tensor:
    """Invert pixels >= threshold (reference ``:793-806``)."""
    image = as_tensor(image)
    return torch.where(image >= torch.tensor(threshold).to(image.dtype), invert(image), image)


def autocontrast(image) -> torch.Tensor:
    """Per-image/channel linear stretch to the full range (reference
    ``:841-860``)."""
    image = as_tensor(image)
    bound = max_value(image.dtype)
    fimg, orig = cast_to_float(image)
    nhwc, restore = ensure_nhwc(fimg)
    minimum = nhwc.amin(dim=(1, 2), keepdim=True)
    maximum = nhwc.amax(dim=(1, 2), keepdim=True)
    eq = maximum == minimum
    one = torch.ones_like(maximum)
    scale = torch.where(eq, one, bound / torch.where(eq, one, maximum - minimum))
    minimum = torch.where(eq, torch.zeros_like(minimum), minimum)
    out = torch.clamp((nhwc - minimum) * scale, 0, bound)
    return cast_back(restore(out), orig)


def equalize(image) -> torch.Tensor:
    """Histogram equalisation for uint8 images (reference ``equalize``,
    ``:888-902``, ``_scale_channel`` ``:863-881``), every (image, channel)
    on its own, in exact integer arithmetic."""
    image = as_tensor(image)
    if image.dtype != torch.uint8:
        raise TypeError("equalize expects uint8")
    nhwc, restore = ensure_nhwc(image)
    n, h, w, c = nhwc.shape
    flat = nhwc.permute(0, 3, 1, 2).reshape(n * c, h * w).to(torch.int64)
    hist = torch.zeros((n * c, 256), dtype=torch.int64, device=flat.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    # value of the last nonzero bin
    idx = torch.arange(256, device=flat.device)
    last_nz = torch.where(hist != 0, idx, -1).amax(dim=1, keepdim=True)
    last_val = hist.gather(1, last_nz.clamp(min=0))
    step = (hist.sum(dim=1, keepdim=True) - last_val) // 255
    lut = (hist.cumsum(dim=1) + step // 2) // step.clamp(min=1)
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], dim=1).clamp(0, 255)
    out = torch.where(step == 0, flat, lut.gather(1, flat)).to(torch.uint8)
    return restore(out.reshape(n, c, h, w).permute(0, 2, 3, 1))


def normalize(image, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Channel-wise ``(img - mean) / std`` for float images (reference
    ``normalize``, ``:905+``).  Channels-last."""
    image = as_tensor(image)
    if is_integer_dtype(image.dtype):
        raise TypeError("normalize expects a float image; use to_dtype first")
    mean_a = torch.tensor(mean, dtype=image.dtype, device=image.device).reshape(1, 1, -1)
    std_a = torch.tensor(std, dtype=image.dtype, device=image.device).reshape(1, 1, -1)
    return (image - mean_a) / std_a
