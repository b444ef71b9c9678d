"""The fused sub-blocks of a transformer encoder layer and of a ConvNeXt block
(CUDA, ``csrc/transformer_block.cu``) and their plain PyTorch twins.

Counterpart of the JAX package's ``ops/pallas/transformer_block.py``:

* ``mlp_block``: ``x + Dense2(gelu(Dense1(LN(x))))`` for 2-D ``x`` (tokens, D),
  or with ``post_norm=True`` (Swin v2) ``x + LN(Dense2(gelu(Dense1(x))))``;
  ``ln_count > 0`` takes the LayerNorm statistics over the first ``ln_count``
  channels of a zero-padded row (the channel-padded Swin);
* ``cn_mlp_block``: ``res + layer_scale * (Dense2(gelu(Dense1(LN(y)))) + b2)``
  for 2-D ``y`` and ``res`` (tokens, D), the tail of a ConvNeXt block: the
  same kernel with a separate residual and a per-channel scale;
* ``attention_block``: ``x + Out(MHA(LN(x)))`` for 3-D ``x`` (N, S, D);
  ``w_qkv`` is (D, 3D) laid out [q | k | v] with each section head-major,
  ``w_o`` is (D, D).

``w1`` (D, Dh), ``w2`` (Dh, D), ``w_qkv`` and ``w_o`` carry the compute dtype
(float32 or bfloat16); LayerNorm parameters and biases may be float32.
LayerNorm, gelu and softmax are float32, products sum in float32, and the
activations are cast to the weight dtype where the Pallas kernels cast them:
after LN, after bias + gelu, after the QKV bias, after softmax, after the
heads are joined.  The erf is the Abramowitz-Stegun 7.1.26 polynomial
(|err| < 1.5e-7) in kernel and twin, as in the Pallas kernel.  The JAX
functions' ``block_m`` and ``interpret`` arguments have no counterpart here.

A wrapper given CUDA tensors launches its hand-written kernel, adds one to its
``launches`` count and raises if the launch fails or the kernel does not take
the arguments; given CPU tensors it runs the twin.  Nothing falls back from
one to the other.  ``attention_block`` is three kernel launches a call (LN +
QKV product, attention core, output projection + residual), counted in
``attention_block.kernel_launches``; its QKV product and joined heads pass
through device memory once, which the Pallas kernel kept in VMEM.  On the
card ``x`` (and ``res``) must have the weights' dtype, ``mlp_block`` and
``cn_mlp_block`` need D in ``MLP_DIMS`` and Dh a multiple of 256, or of
``MLP_HIDDEN_STEP`` up to D = ``MLP_RAGGED_MAX_DIM``, and ``attention_block`` needs D a multiple of 16 and a
head dim of ``flash_attention.HEAD_DIMS``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..._dtype import full_float32
from . import _build
from .flash_attention import DTYPES, HEAD_DIMS

__all__ = ["mlp_block", "mlp_block_plain", "cn_mlp_block", "cn_mlp_block_plain", "attention_block",
           "attention_block_plain", "mlp_kernel_takes", "attention_kernel_takes", "MLP_DIMS"]

MLP_DIMS = (96, 128, 192, 256, 384, 512, 768, 1024, 1280, 1536)  # instantiations in csrc/transformer_block.cu
MLP_HIDDEN_STEP = 64       # Dh is a multiple of 256, or of this up to D = MLP_RAGGED_MAX_DIM
MLP_RAGGED_MAX_DIM = 512

_c_lib: Optional[ctypes.CDLL] = None


def mlp_kernel_takes(d: int, dh: int) -> bool:
    """Whether ``mlp_block``'s and ``cn_mlp_block``'s kernel takes width ``d``
    and hidden width ``dh``."""
    return d in MLP_DIMS and dh > 0 and dh % (MLP_HIDDEN_STEP if d <= MLP_RAGGED_MAX_DIM else 256) == 0


def attention_kernel_takes(d: int, heads: int) -> bool:
    """Whether ``attention_block``'s kernels take width ``d`` in ``heads`` heads."""
    return heads >= 1 and d % heads == 0 and d % 16 == 0 and d // heads in HEAD_DIMS


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("transformer_block")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cvt_mlp_block.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, f, i, i, i, p]
        lib.cvt_mlp_block.restype = ctypes.c_int
        lib.cvt_attention_block.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, i, p]
        lib.cvt_attention_block.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def _erf_f32(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational approximation (|err| < 1.5e-7)."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def _gelu_f32(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + _erf_f32(h * (1.0 / math.sqrt(2.0))))


def _ln_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float, count: int = 0) -> torch.Tensor:
    if not count:
        c = x - x.mean(dim=-1, keepdim=True)
        v = (c * c).mean(dim=-1, keepdim=True)
        return c * torch.rsqrt(v + eps) * g + b
    # statistics over the first `count` real channels of a zero-padded layout
    m = x.sum(dim=-1, keepdim=True) / count
    v = (x * x).sum(dim=-1, keepdim=True) / count - m * m
    return (x - m) * torch.rsqrt(v + eps) * g + b


def _dot_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of values already rounded to the compute dtype, summed in float32."""
    return a.float() @ w.float()


def _check_float(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.dtype.is_floating_point:
            raise TypeError(f"expects floating-point tensors, got {t.dtype}")
        if t.device != tensors[0].device:
            raise ValueError("all tensors must lie on one device")


def _check_mlp(x, ln_g, ln_b, w1, b1, w2, b2) -> None:
    _check_float(x, ln_g, ln_b, w1, b1, w2, b2)
    if x.ndim != 2 or min(x.shape) < 1:
        raise ValueError(f"expects non-empty (tokens, D) input, got {tuple(x.shape)}")
    d = x.shape[1]
    if w1.ndim != 2 or w1.shape[0] != d or tuple(w2.shape) != (w1.shape[1], d) or w2.dtype != w1.dtype:
        raise ValueError("expects w1 (D, Dh) and w2 (Dh, D) of one dtype")
    if ln_g.shape != (d,) or ln_b.shape != (d,) or b1.shape != (w1.shape[1],) or b2.shape != (d,):
        raise ValueError("LayerNorm parameters and biases do not match the weights")


def mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2, eps: float = 1e-6, post_norm: bool = False,
                    ln_count: int = 0) -> torch.Tensor:
    """Twin of ``cvt_mlp_block``: the same math in plain PyTorch operators."""
    _check_mlp(x, ln_g, ln_b, w1, b1, w2, b2)
    dtype = w1.dtype
    x32, g32, b32 = x.float(), ln_g.float(), ln_b.float()
    with full_float32():
        h = x32.to(dtype) if post_norm else _ln_f32(x32, g32, b32, eps, ln_count).to(dtype)
        h = _gelu_f32(_dot_f32(h, w1) + b1.float()).to(dtype)
        h = _dot_f32(h, w2) + b2.float()
    if post_norm:
        h = _ln_f32(h, g32, b32, eps, ln_count)
    return (x32 + h).to(x.dtype)


def _f32c(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _check_card(x: torch.Tensor, *weights: torch.Tensor) -> None:
    """``x`` and ``weights`` (the other tensors of the storage type) in one
    dtype the kernels take, and contiguous."""
    if x.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    for w in weights:
        if w.dtype != x.dtype:
            raise TypeError(f"the kernel takes x and the weights in one dtype, got {x.dtype} and {w.dtype}")
    for t in (x, *weights):
        if not t.is_contiguous():
            raise ValueError("x and the weights must be contiguous")


def _launch_mlp(fn, x, resid, ln_g, ln_b, w1, b1, w2, b2, gamma, eps, post_norm, ln_count) -> torch.Tensor:
    """One launch of ``cvt_mlp_block`` for the wrapper ``fn``; ``gamma`` None for no scale."""
    m, d = x.shape
    dh = w1.shape[1]
    if not mlp_kernel_takes(d, dh):
        raise ValueError(f"the kernel takes D in {MLP_DIMS} and Dh a multiple of 256 (of {MLP_HIDDEN_STEP} up to "
                         f"D = {MLP_RAGGED_MAX_DIM}), got {d} and {dh}")
    if not 0 <= ln_count <= d:
        raise ValueError(f"ln_count must lie in 0..D, got {ln_count}")
    _check_card(x, resid, w1, w2)
    out = torch.empty_like(resid)
    ln_g, ln_b, b1, b2 = _f32c(ln_g), _f32c(ln_b), _f32c(b1), _f32c(b2)
    gamma = None if gamma is None else _f32c(gamma)
    _build.launch(_lib(), "cvt_mlp_block", x, x.data_ptr(), resid.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  None if gamma is None else gamma.data_ptr(), out.data_ptr(), m, d, dh, float(eps),
                  int(bool(post_norm)), int(ln_count), int(x.dtype == torch.bfloat16))
    _build.count_launch(fn, x)
    return out


def mlp_block(x, ln_g, ln_b, w1, b1, w2, b2, eps: float = 1e-6, post_norm: bool = False,
              ln_count: int = 0) -> torch.Tensor:
    """``x + Dense2(gelu(Dense1(LN(x))))`` for 2-D ``x`` (tokens, D), in one
    kernel on the card: the (tokens, Dh) activations never reach device memory."""
    _check_mlp(x, ln_g, ln_b, w1, b1, w2, b2)
    if not _build.on_card(x):
        return mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2, eps, post_norm, ln_count)
    return _launch_mlp(mlp_block, x, x, ln_g, ln_b, w1, b1, w2, b2, None, eps, post_norm, ln_count)


_build.reset_count(mlp_block)


def _check_cn(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale) -> None:
    _check_mlp(y, ln_g, ln_b, w1, b1, w2, b2)
    _check_float(y, res, layer_scale)
    if res.shape != y.shape or layer_scale.shape != (y.shape[1],):
        raise ValueError("expects res like y and layer_scale (D,)")


def cn_mlp_block_plain(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps: float = 1e-6) -> torch.Tensor:
    """Twin of ``cvt_mlp_block`` with a residual and a scale: the same math in
    plain PyTorch operators (bias first, then the scale)."""
    _check_cn(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale)
    dtype = w1.dtype
    with full_float32():
        h = _ln_f32(y.float(), ln_g.float(), ln_b.float(), eps).to(dtype)
        h = _gelu_f32(_dot_f32(h, w1) + b1.float()).to(dtype)
        h = (_dot_f32(h, w2) + b2.float()) * layer_scale.float()
    return (res.float() + h).to(res.dtype)


def cn_mlp_block(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps: float = 1e-6) -> torch.Tensor:
    """``res + layer_scale * (Dense2(gelu(Dense1(LN(y)))) + b2)`` for 2-D ``y``
    and ``res`` (tokens, D), the tail of a ConvNeXt block after its depthwise
    convolution, in one kernel on the card."""
    _check_cn(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale)
    if not _build.on_card(y):
        return cn_mlp_block_plain(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps)
    return _launch_mlp(cn_mlp_block, y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps, False, 0)


_build.reset_count(cn_mlp_block)


def _check_attn(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int) -> None:
    _check_float(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o)
    if x.ndim != 3 or min(x.shape) < 1:
        raise ValueError(f"expects non-empty (N, S, D) input, got {tuple(x.shape)}")
    d = x.shape[2]
    if heads < 1 or d % heads:
        raise ValueError(f"D = {d} is not a multiple of heads = {heads}")
    if tuple(w_qkv.shape) != (d, 3 * d) or tuple(w_o.shape) != (d, d) or w_o.dtype != w_qkv.dtype:
        raise ValueError("expects w_qkv (D, 3D) and w_o (D, D) of one dtype")
    if ln_g.shape != (d,) or ln_b.shape != (d,) or b_qkv.shape != (3 * d,) or b_o.shape != (d,):
        raise ValueError("LayerNorm parameters and biases do not match the weights")


def attention_block_plain(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, scale: float,
                          eps: float = 1e-6) -> torch.Tensor:
    """Twin of ``cvt_attention_block``: the same math in plain PyTorch operators."""
    _check_attn(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads)
    n, s, d = x.shape
    dtype = w_qkv.dtype
    x32 = x.float()
    with full_float32():
        h = _ln_f32(x32, ln_g.float(), ln_b.float(), eps).to(dtype)
        qkv = (_dot_f32(h, w_qkv) + b_qkv.float()).to(dtype)
        q, k, v = (a.reshape(n, s, heads, d // heads).float() for a in qkv.split(d, dim=-1))
        scores = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
        probs = torch.softmax(scores, dim=-1).to(dtype)
        o = torch.einsum("nhqk,nkhd->nqhd", probs.float(), v).reshape(n, s, d).to(dtype)
        o = _dot_f32(o, w_o)
    return (x32 + o + b_o.float()).to(x.dtype)


def attention_block(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, scale: float,
                    eps: float = 1e-6) -> torch.Tensor:
    """``x + Out(MHA(LN(x)))`` for 3-D ``x`` (N, S, D); on the card three
    hand-written launches with no transposed copy of q, k, v or the heads."""
    _check_attn(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads)
    if not _build.on_card(x):
        return attention_block_plain(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads, scale, eps)
    n, s, d = x.shape
    if not attention_kernel_takes(d, heads):
        raise ValueError(f"the kernel takes D a multiple of 16 and head dims {HEAD_DIMS}, got D = {d}, {heads} heads")
    if n > 65535 or heads > 65535:
        raise ValueError(f"at most 65535 images and heads a launch, got {n} and {heads}")
    _check_card(x, w_qkv, w_o)
    qkv = torch.empty((n, s, 3 * d), dtype=x.dtype, device=x.device)
    joined = torch.empty_like(x)
    out = torch.empty_like(x)
    ln_g, ln_b, b_qkv, b_o = _f32c(ln_g), _f32c(ln_b), _f32c(b_qkv), _f32c(b_o)
    _build.launch(_lib(), "cvt_attention_block", x, x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
                  w_qkv.data_ptr(), b_qkv.data_ptr(), w_o.data_ptr(), b_o.data_ptr(), qkv.data_ptr(),
                  joined.data_ptr(), out.data_ptr(), n, s, d, heads, float(scale), float(eps),
                  int(x.dtype == torch.bfloat16))
    _build.count_launch(attention_block, x)
    attention_block.kernel_launches += 3
    return out


_build.reset_count(attention_block)
attention_block.kernel_launches = 0
