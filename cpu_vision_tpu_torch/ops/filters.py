"""2-D image filtering (PyTorch): general stencils, separable/Gaussian blur,
Sobel.

Op-by-op counterpart of the JAX package's ``ops/filters.py`` with the same
semantics and the same order of floating-point sums, so exact ties break
the same way downstream (Canny NMS):

* Gaussian kernel construction: torchvision
  ``transforms/_functional_tensor.py:727-743``.
* Blur = pad + depthwise cross-correlation: ``_functional_tensor.py:746-764``.
* Sharpness 3x3 stencil: ``_functional_tensor.py:809-838``.
* Integer images are cast to float32, convolved, rounded and cast back:
  ``_functional_tensor.py:516-542``.

Images are channels-last tensors (HW / HWC / NHWC).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .._dtype import cast_back, cast_to_float, float_kernel, is_integer_dtype, max_value
from .._layout import as_tensor, ensure_nhwc

__all__ = [
    "get_gaussian_kernel1d",
    "get_gaussian_kernel2d",
    "pad2d",
    "filter2d",
    "separable_filter2d",
    "gaussian_blur",
    "box_blur",
    "sobel_kernels",
    "scharr_kernels",
    "sobel_gradients",
    "sobel",
    "spatial_gradient",
    "laplacian",
    "adjust_sharpness",
    "unsharp_mask",
]

_PAD_MODES = {
    "reflect": "reflect",    # torch "reflect": edge pixel not repeated
    "replicate": "edge",     # torch "replicate"
    "edge": "edge",
    "constant": "constant",
    "circular": "wrap",
    "wrap": "wrap",
    "symmetric": "symmetric",
}


def _as_pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return (v[0], v[0])
        if len(v) != 2:
            raise ValueError(f"expected 1 or 2 values, got {v}")
        return (v[0], v[1])
    return (v, v)


def get_gaussian_kernel1d(kernel_size: int, sigma: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalised 1-D Gaussian taps at integer offsets (reference
    ``_get_gaussian_kernel1d``, ``_functional_tensor.py:727-734``).

    Built on the host in float32 the way the JAX package builds them: the
    offsets as ``jnp.linspace`` computes them (``start·(1-t) + stop·t``,
    which is not always numpy's value: -0.99999988 for the third tap of 7),
    then exp, a sequential sum and the division.  Bitwise equal to the JAX
    package's taps for (5, 1.4), (5, 1.5), (7, 2.0) and (5, 1.0); for some
    other sizes and sigmas the two exponentials differ in the last bit.
    Cast to ``dtype`` on ``device`` (default: the first CUDA card).
    """
    half = np.float32((kernel_size - 1) * 0.5)
    div = kernel_size - 1
    t = np.arange(div, dtype=np.float32) / np.float32(max(div, 1))
    x = np.append(-half * (np.float32(1) - t) + half * t, -half if div == 0 else half).astype(np.float32)
    pdf = torch.exp(-0.5 * torch.square(torch.from_numpy(x) / float(np.float32(sigma))))
    total = pdf[0]
    for v in pdf[1:]:
        total = total + v
    return (pdf / total).to(device="cuda" if device is None else device, dtype=dtype)


def get_gaussian_kernel2d(
    kernel_size: Union[int, Sequence[int]],
    sigma: Union[float, Sequence[float]],
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """2-D Gaussian as the outer product ``ky ⊗ kx``; shape ``(ky, kx)``
    (``kernel_size``/``sigma`` are ``(x, y)`` pairs like the reference)."""
    kx, ky = _as_pair(kernel_size)
    sx, sy = _as_pair(sigma)
    k1x = get_gaussian_kernel1d(kx, sx, dtype, device)
    k1y = get_gaussian_kernel1d(ky, sy, dtype, device)
    return torch.outer(k1y, k1x)


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """Source indices of a length-``n`` axis padded by ``lo``/``hi`` with
    numpy's semantics (pads may exceed ``n``: the extension is periodic)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "symmetric":
        m = i % (2 * n)
        return torch.where(m < n, m, 2 * n - 1 - m)
    if n == 1:  # reflect of a single sample repeats it
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = i % period
    return torch.where(m < n, m, period - m)


def reflect_pad_hw(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last two axes of ``x`` by ``pad`` (numpy ``reflect``)."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.index_select(-2, _pad_index(h, pad, pad, "reflect", x.device))
    return x.index_select(-1, _pad_index(w, pad, pad, "reflect", x.device))


def pad2d(image, padding: Union[int, Sequence[int]], mode: str = "reflect", value: float = 0.0) -> torch.Tensor:
    """Pad the spatial dims of an NHWC/HWC/HW image.

    ``padding`` is ``(left, right, top, bottom)`` (the reference's
    ``torch.nn.functional.pad`` 2-D order) or a single int for all sides.
    """
    if isinstance(padding, int):
        l = r = t = b = padding
    else:
        l, r, t, b = padding
    nhwc, restore = ensure_nhwc(image)
    mode = _PAD_MODES[mode]
    if mode == "constant":
        return restore(F.pad(nhwc, (0, 0, l, r, t, b), value=value))
    h, w = nhwc.shape[1], nhwc.shape[2]
    out = nhwc.index_select(1, _pad_index(h, t, b, mode, nhwc.device))
    out = out.index_select(2, _pad_index(w, l, r, mode, nhwc.device))
    return restore(out)


# Stencils with at most this many taps are computed as shifted-slice
# accumulation (see _depthwise_conv_valid).
_MAX_UNROLLED_TAPS = 64


def _depthwise_conv_valid(nhwc: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """VALID depthwise cross-correlation of every channel with one 2-D kernel.

    Small stencils are a sum of shifted slices
    (``out = Σ k[i,j] * padded[:, i:i+H, j:j+W, :]``) in row-major tap order,
    the order of the JAX package, so the sums round identically.  Larger
    kernels use a grouped convolution in full float32 (TF32 off).
    """
    kh, kw = kernel2d.shape
    k = kernel2d.to(device=nhwc.device, dtype=nhwc.dtype)
    if kh * kw <= _MAX_UNROLLED_TAPS:
        _, ph, pw, _ = nhwc.shape
        h, w = ph - kh + 1, pw - kw + 1
        out = None
        for i in range(kh):
            for j in range(kw):
                term = nhwc[:, i : i + h, j : j + w, :] * k[i, j]
                out = term if out is None else out + term
        return out
    c = nhwc.shape[-1]
    weight = k[None, None].expand(c, 1, kh, kw)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv2d(nhwc.permute(0, 3, 1, 2), weight, groups=c)
    return out.permute(0, 2, 3, 1)


def _as_kernel(kernel, ref: torch.Tensor) -> torch.Tensor:
    if isinstance(kernel, torch.Tensor):
        return kernel.to(device=ref.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(kernel, np.float32), device=ref.device)


@float_kernel
def filter2d(image, kernel, mode: str = "reflect", value: float = 0.0) -> torch.Tensor:
    """Same-size depthwise 2-D cross-correlation with one ``(kh, kw)`` kernel
    (the reference's pad + ``conv2d(groups=C)`` idiom,
    ``_functional_tensor.py:758-761``)."""
    kernel = _as_kernel(kernel, image)
    if kernel.ndim != 2:
        raise ValueError(f"kernel must be 2-D, got shape {tuple(kernel.shape)}")
    kh, kw = kernel.shape
    nhwc, restore = ensure_nhwc(image)
    t, b = (kh - 1) // 2, kh - 1 - (kh - 1) // 2
    l, r = (kw - 1) // 2, kw - 1 - (kw - 1) // 2
    padded = pad2d(nhwc, (l, r, t, b), mode=mode, value=value)
    return restore(_depthwise_conv_valid(padded, kernel))


@float_kernel
def separable_filter2d(image, kernel_x, kernel_y, mode: str = "reflect", value: float = 0.0) -> torch.Tensor:
    """Same-size separable filter: a pass along W with ``kernel_x``, then one
    along H with ``kernel_y``."""
    kernel_x = _as_kernel(kernel_x, image).reshape(-1)
    kernel_y = _as_kernel(kernel_y, image).reshape(-1)
    kw, kh = kernel_x.shape[0], kernel_y.shape[0]
    nhwc, restore = ensure_nhwc(image)
    t, b = (kh - 1) // 2, kh - 1 - (kh - 1) // 2
    l, r = (kw - 1) // 2, kw - 1 - (kw - 1) // 2
    padded = pad2d(nhwc, (l, r, t, b), mode=mode, value=value)
    out = _depthwise_conv_valid(padded, kernel_x[None, :])
    out = _depthwise_conv_valid(out, kernel_y[:, None])
    return restore(out)


def gaussian_blur(
    image,
    kernel_size: Union[int, Sequence[int]],
    sigma: Optional[Union[float, Sequence[float]]] = None,
    mode: str = "reflect",
    separable: bool = True,
) -> torch.Tensor:
    """Gaussian blur with reference semantics (``gaussian_blur``,
    ``_functional_tensor.py:746-764``): ``kernel_size``/``sigma`` are
    ``(x, y)``, reflect padding, depthwise conv, integer round-trip.

    ``sigma=None`` uses the reference transform default
    ``0.3 * ((ksize - 1) * 0.5 - 1) + 0.8``.
    """
    image = as_tensor(image)
    kx, ky = _as_pair(kernel_size)
    if sigma is None:
        sx = 0.3 * ((kx - 1) * 0.5 - 1) + 0.8
        sy = 0.3 * ((ky - 1) * 0.5 - 1) + 0.8
    else:
        sx, sy = _as_pair(sigma)
    # Integer images take the exact 2-D kernel: the separable two-pass
    # version rounds twice and can drift 2 LSB from the reference.
    if separable and not is_integer_dtype(image.dtype):
        k1x = get_gaussian_kernel1d(kx, sx, device=image.device)
        k1y = get_gaussian_kernel1d(ky, sy, device=image.device)
        return separable_filter2d(image, k1x, k1y, mode=mode)
    kernel = get_gaussian_kernel2d((kx, ky), (sx, sy), device=image.device)
    return filter2d(image, kernel, mode=mode)


def box_blur(image, kernel_size: Union[int, Sequence[int]], mode: str = "reflect") -> torch.Tensor:
    """Mean filter (separable)."""
    kx, ky = _as_pair(kernel_size)
    k1x = np.full((kx,), 1.0 / kx, np.float32)
    k1y = np.full((ky,), 1.0 / ky, np.float32)
    return separable_filter2d(image, k1x, k1y, mode=mode)


def sobel_kernels(dtype=torch.float32, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classic 3x3 Sobel cross-correlation kernels ``(gx, gy)``; ``gx``
    responds to left→right intensity increase, ``gy`` to top→bottom."""
    device = "cuda" if device is None else device
    gx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], dtype=dtype, device=device)
    gy = torch.tensor([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]], dtype=dtype, device=device)
    return gx, gy


def scharr_kernels(dtype=torch.float32, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    device = "cuda" if device is None else device
    gx = torch.tensor([[-3.0, 0.0, 3.0], [-10.0, 0.0, 10.0], [-3.0, 0.0, 3.0]], dtype=dtype, device=device)
    gy = torch.tensor([[-3.0, -10.0, -3.0], [0.0, 0.0, 0.0], [3.0, 10.0, 3.0]], dtype=dtype, device=device)
    return gx, gy


def sobel_gradients(image, mode: str = "reflect") -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel Sobel gradients ``(gx, gy)``, same spatial size, always
    float (gradients are signed and can exceed the input dtype's range)."""
    fimg, _ = cast_to_float(as_tensor(image))
    gx_k, gy_k = sobel_kernels(fimg.dtype, fimg.device)
    nhwc, restore = ensure_nhwc(fimg)
    padded = pad2d(nhwc, 1, mode=mode)
    gx = _depthwise_conv_valid(padded, gx_k)
    gy = _depthwise_conv_valid(padded, gy_k)
    return restore(gx), restore(gy)


def sobel(image, mode: str = "reflect", eps: float = 0.0) -> torch.Tensor:
    """Sobel gradient magnitude ``sqrt(gx^2 + gy^2)`` (float output)."""
    gx, gy = sobel_gradients(image, mode=mode)
    return torch.sqrt(gx * gx + gy * gy + eps)


def spatial_gradient(image, method: str = "sobel", mode: str = "reflect"):
    """``(gx, gy)`` via Sobel, Scharr, or central differences (float output)."""
    fimg, _ = cast_to_float(as_tensor(image))
    if method == "sobel":
        return sobel_gradients(fimg, mode=mode)
    if method == "scharr":
        gx_k, gy_k = scharr_kernels(device=fimg.device)
    elif method == "diff":
        gx_k = torch.tensor([[-0.5, 0.0, 0.5]], device=fimg.device)
        gy_k = gx_k.T
    else:
        raise ValueError(f"unknown gradient method {method!r}")
    return filter2d(fimg, gx_k, mode=mode), filter2d(fimg, gy_k, mode=mode)


def laplacian(image, mode: str = "reflect") -> torch.Tensor:
    """4-neighbour Laplacian stencil."""
    k = np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]], np.float32)
    return filter2d(image, k, mode=mode)


def _blend(img1: torch.Tensor, img2: torch.Tensor, ratio: float, bound: float) -> torch.Tensor:
    out = ratio * img1 + (1.0 - ratio) * img2
    return torch.clamp(out, 0.0, bound)


def adjust_sharpness(image, sharpness_factor: float) -> torch.Tensor:
    """Sharpness adjustment with the reference's 3x3 smoothing stencil and
    interior-only update (``adjust_sharpness`` /
    ``_blurred_degenerate_image``, ``_functional_tensor.py:809-838``)."""
    if sharpness_factor < 0:
        raise ValueError("sharpness_factor must be non-negative")
    image = as_tensor(image)
    h, w = (image.shape[-3], image.shape[-2]) if image.ndim >= 3 else image.shape
    if h <= 2 or w <= 2:
        return image

    fimg, orig = cast_to_float(image)
    k = torch.ones((3, 3), dtype=fimg.dtype, device=fimg.device)
    k[1, 1] = 5.0
    k = k / torch.sum(k)

    nhwc, restore = ensure_nhwc(fimg)
    blurred_interior = _depthwise_conv_valid(nhwc, k)  # VALID: (H-2, W-2)
    # integer sources round the blurred intermediate before blending (the
    # reference's _cast_squeeze_out runs inside _blurred_degenerate_image)
    if is_integer_dtype(orig):
        info = torch.iinfo(orig)
        blurred_interior = torch.clamp(torch.round(blurred_interior), info.min, info.max)
    degenerate = nhwc.clone()
    degenerate[:, 1:-1, 1:-1, :] = blurred_interior
    out = _blend(nhwc, degenerate, sharpness_factor, max_value(orig))
    return cast_back(restore(out), orig)


def unsharp_mask(
    image,
    kernel_size: Union[int, Sequence[int]] = 5,
    sigma: Optional[Union[float, Sequence[float]]] = None,
    amount: float = 1.0,
) -> torch.Tensor:
    """Classic unsharp masking: ``img + amount * (img - gaussian_blur(img))``."""
    fimg, orig = cast_to_float(as_tensor(image))
    blurred = gaussian_blur(fimg, kernel_size, sigma)
    out = torch.clamp(fimg + amount * (fimg - blurred), 0.0, max_value(orig))
    return cast_back(out, orig)
