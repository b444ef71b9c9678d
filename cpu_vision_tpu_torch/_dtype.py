"""Image dtype protocol (PyTorch).

Images are NHWC (or HWC / HW) tensors, uint8 "at rest", float32 in compute.
Integer-typed inputs to float-domain kernels are cast to float32, processed,
rounded (half to even), clipped and cast back, so uint8 outputs match the
reference's ``_cast_squeeze_in/_cast_squeeze_out`` protocol bit for bit
(torchvision ``transforms/_functional_tensor.py:516-542``).

``to_dtype`` implements the value-scale rules of ``to_dtype_image``
(torchvision ``transforms/v2/functional/_misc.py:250-309``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator

import numpy as np
import torch

from ._layout import as_tensor

__all__ = [
    "max_value",
    "is_integer_dtype",
    "compute_dtype",
    "cast_to_float",
    "cast_back",
    "float_kernel",
    "to_dtype",
    "full_float32",
    "float32_products",
]

# Number of value bits for the integer image dtypes we support.
_NUM_VALUE_BITS = {
    torch.uint8: 8,
    torch.int8: 7,
    torch.int16: 15,
    torch.uint16: 16,
    torch.int32: 31,
    torch.uint32: 32,
    torch.int64: 63,
}


def _as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def is_integer_dtype(dtype) -> bool:
    dtype = _as_torch_dtype(dtype)
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def max_value(dtype) -> float:
    """Maximum representable value of an image dtype (1.0 for floats)."""
    dtype = _as_torch_dtype(dtype)
    if is_integer_dtype(dtype):
        return float(2 ** _NUM_VALUE_BITS[dtype] - 1)
    return 1.0


def compute_dtype(dtype) -> torch.dtype:
    """The float dtype a kernel computes in for a given storage dtype."""
    dtype = _as_torch_dtype(dtype)
    return dtype if dtype.is_floating_point else torch.float32


def cast_to_float(image: torch.Tensor, dtype=None):
    """Cast an image to its compute dtype.  Returns (float_image, orig_dtype).

    No value rescaling: uint8 values are convolved in the 0..255 range as
    float32, as the reference does.
    """
    orig = image.dtype
    tgt = compute_dtype(orig) if dtype is None else _as_torch_dtype(dtype)
    if orig != tgt:
        image = image.to(tgt)
    return image, orig


def cast_back(image: torch.Tensor, orig_dtype) -> torch.Tensor:
    """Round (for integer targets), clip to the dtype range, and cast back."""
    orig_dtype = _as_torch_dtype(orig_dtype)
    if image.dtype == orig_dtype:
        return image
    if is_integer_dtype(orig_dtype):
        info = torch.iinfo(orig_dtype)
        image = torch.clamp(torch.round(image), info.min, info.max)
    return image.to(orig_dtype)


def float_kernel(fn: Callable) -> Callable:
    """Decorator: run ``fn`` in the float compute dtype, cast the result back.

    The wrapped function receives a float tensor as its first argument and
    may return one tensor or a tuple/list of tensors (all cast back).
    """

    @functools.wraps(fn)
    def wrapper(image, *args, **kwargs):
        fimg, orig = cast_to_float(as_tensor(image))
        out = fn(fimg, *args, **kwargs)
        if isinstance(out, (tuple, list)):
            return type(out)(cast_back(o, orig) for o in out)
        return cast_back(out, orig)

    return wrapper


def to_dtype(image, dtype, scale: bool = True) -> torch.Tensor:
    """Convert an image between dtypes, rescaling values when ``scale``.

    * float -> float: plain cast.
    * float -> int:   ``img * (max+1-eps)`` then truncating cast.
    * int -> float:   cast then ``* 1/max``.
    * int -> int:     bit-shift by the difference in value bits.
    """
    image = as_tensor(image)
    src = image.dtype
    dst = _as_torch_dtype(dtype)
    if src == dst:
        return image
    if not scale:
        if is_integer_dtype(dst) and src.is_floating_point:
            return cast_back(image, dst)
        return image.to(dst)

    if src.is_floating_point and dst.is_floating_point:
        return image.to(dst)

    if src.is_floating_point:
        # float -> int.  eps keeps 1.0 from overflowing to max+1.
        scale_v = float(2 ** _NUM_VALUE_BITS[dst]) - 1e-3
        return (image * scale_v).to(dst)

    if dst.is_floating_point:
        return image.to(dst) * (1.0 / max_value(src))

    # int -> int via bit shift (exact, matches the reference).
    bits_src = _NUM_VALUE_BITS[src]
    bits_dst = _NUM_VALUE_BITS[dst]
    if bits_src > bits_dst:
        return (image >> (bits_src - bits_dst)).to(dst)
    return image.to(dst) << (bits_dst - bits_src)


@contextlib.contextmanager
def full_float32() -> Iterator[None]:
    """Float32 matrix products and convolutions inside run in full float32
    on the card, whatever the caller's TF32 settings (PyTorch's default lets
    cuDNN convolutions round to TF32, about three decimal digits)."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


@contextlib.contextmanager
def float32_products(dtype: torch.dtype) -> Iterator[None]:
    """Matrix products inside whose operands hold values of ``dtype``, summed
    in float32: ``full_float32`` for float32; for bfloat16 or float16 the
    card's TF32 tensor cores are allowed, which keep 10 mantissa bits and so
    multiply such values exactly.  Convolutions are left as they are."""
    if dtype == torch.float32:
        with full_float32():
            yield
        return
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
