"""The fused attention sub-block of a Swin block over a batch of windows
(CUDA, ``csrc/swin_attention.cu``) and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/pallas/swin_attention.py``:
``window_attention_block`` computes ``x + Proj(WindowMSA(LN(x)))`` for ``x``
(num_windows, S, C), the windows of one image adjacent (image-major), in
both flavours:

* v1: LayerNorm before the branch, ``(q · scale) kᵀ``;
* v2: no LayerNorm before, cosine attention (q and k divided by their norms,
  ``rsqrt(max(Σq², 1e-12))``) times ``exp(min(logit_scale, ln 100))`` per
  head, LayerNorm (the same ``ln_g``/``ln_b``) on the branch output.

``rel_bias`` is the (heads, S, S) position bias, ``mask`` the (nw_img, S, S)
shift mask or None (window ``w`` takes ``mask[w % nw_img]``; it holds -100, not
-inf), ``logit_scale`` the (heads,) log scale of v2 or None, ``ln_count > 0``
takes the LayerNorm statistics over the first ``ln_count`` channels of a
zero-padded row.  ``w_qkv`` (C, 3C) is laid out [q | k | v], each head-major,
``w_o`` (C, C); both carry the compute dtype, everything else may be float32.
LayerNorm, the norms, softmax and every sum are float32, and activations are
cast to the weight dtype where the Pallas kernels cast them.  The softmax is
taken per head: the JAX package's head-packed kernel and its per-head one are
one function here.

Given CUDA tensors the wrapper launches its kernels, adds one to ``launches``
and the number of kernel launches (3 for v1, 4 for v2: LN + QKV product, the
window core, the output projection, v2's LayerNorm + residual) to
``kernel_launches``, and raises if a launch fails or the kernels do not take
the arguments (head dim ``HEAD_DIM``, S ≤ ``MAX_TOKENS``, C a multiple of 16,
``x`` in the weights' dtype); given CPU tensors it runs the twin.  Nothing
falls back from one to the other.  On the card the float32 QKV product
(12·C bytes a token), the joined heads and v2's branch rows pass through
device memory once each, which the Pallas kernels keep in VMEM.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..._dtype import full_float32
from . import _build
from .transformer_block import _check_card, _check_float, _dot_f32, _f32c, _ln_f32

__all__ = ["window_attention_block", "window_attention_block_plain", "HEAD_DIM", "MAX_TOKENS"]

HEAD_DIM = 32     # the instantiation in csrc/swin_attention.cu
MAX_TOKENS = 64   # tokens of a window the core holds as one tile

_c_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("swin_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cvt_window_attention_block.argtypes = [p] * 14 + [i, i, i, i, i, f, f, i, i, i, p]
        lib.cvt_window_attention_block.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def _check(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads, v2, nw_img, ln_count) -> None:
    optional = [t for t in (mask, logit_scale) if t is not None]
    _check_float(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, *optional)
    if x.ndim != 3 or min(x.shape) < 1:
        raise ValueError(f"expects non-empty (num_windows, S, C) input, got {tuple(x.shape)}")
    nw, s, c = x.shape
    if heads < 1 or c % heads:
        raise ValueError(f"C = {c} is not a multiple of heads = {heads}")
    if tuple(w_qkv.shape) != (c, 3 * c) or tuple(w_o.shape) != (c, c) or w_o.dtype != w_qkv.dtype:
        raise ValueError("expects w_qkv (C, 3C) and w_o (C, C) of one dtype")
    if ln_g.shape != (c,) or ln_b.shape != (c,) or b_qkv.shape != (3 * c,) or b_o.shape != (c,):
        raise ValueError("LayerNorm parameters and biases do not match the weights")
    if tuple(rel_bias.shape) != (heads, s, s):
        raise ValueError(f"expects rel_bias {(heads, s, s)}, got {tuple(rel_bias.shape)}")
    if nw_img < 1 or nw % nw_img:
        raise ValueError(f"{nw} windows are no whole number of images of {nw_img} windows")
    if mask is not None and tuple(mask.shape) != (nw_img, s, s):
        raise ValueError(f"expects mask {(nw_img, s, s)}, got {tuple(mask.shape)}")
    if v2 and (logit_scale is None or logit_scale.numel() != heads):
        raise ValueError("v2 needs a logit_scale of one value a head")
    if not 0 <= ln_count <= c:
        raise ValueError(f"ln_count must lie in 0..C, got {ln_count}")


def window_attention_block_plain(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads: int,
                                 scale: float, eps: float, v2: bool, nw_img: int, ln_count: int = 0) -> torch.Tensor:
    """Twin of ``cvt_window_attention_block``: the same math in plain PyTorch operators."""
    _check(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads, v2, nw_img, ln_count)
    nw, s, c = x.shape
    hd = c // heads
    dtype = w_qkv.dtype
    x32, g32, b32 = x.float(), ln_g.float(), ln_b.float()
    with full_float32():
        h = x32.to(dtype) if v2 else _ln_f32(x32, g32, b32, eps, ln_count).to(dtype)
        qkv = _dot_f32(h, w_qkv) + b_qkv.float()
        q, k, v = (a.reshape(nw, s, heads, hd) for a in qkv.split(c, dim=-1))
        v = v.to(dtype).float()
        if v2:
            q = q * torch.rsqrt((q * q).sum(dim=-1, keepdim=True).clamp_min(1e-12))
            k = k * torch.rsqrt((k * k).sum(dim=-1, keepdim=True).clamp_min(1e-12))
            scores = torch.einsum("bnhd,bmhd->bhnm", q.to(dtype).float(), k.to(dtype).float())
            scores = scores * torch.exp(logit_scale.float().reshape(1, heads, 1, 1).clamp_max(math.log(100.0)))
        else:
            scores = torch.einsum("bnhd,bmhd->bhnm", (q * scale).to(dtype).float(), k.to(dtype).float())
        scores = scores + rel_bias.float()[None]
        if mask is not None:
            scores = scores.reshape(nw // nw_img, nw_img, heads, s, s) + mask.float()[None, :, None]
            scores = scores.reshape(nw, heads, s, s)
        probs = torch.softmax(scores, dim=-1).to(dtype).float()
        o = torch.einsum("bhnm,bmhd->bnhd", probs, v).reshape(nw, s, c).to(dtype)
        o = _dot_f32(o, w_o) + b_o.float()
        if v2:
            o = _ln_f32(o, g32, b32, eps, ln_count)
    return (x32 + o).to(x.dtype)


def window_attention_block(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads: int,
                           scale: float, eps: float, v2: bool, nw_img: int, ln_count: int = 0) -> torch.Tensor:
    """``x + Proj(WindowMSA(LN(x)))`` over ``x`` (num_windows, S, C); on the
    card three (v1) or four (v2) hand-written launches with no transposed
    copy of q, k, v or the heads."""
    _check(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads, v2, nw_img, ln_count)
    if not _build.on_card(x):
        return window_attention_block_plain(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale,
                                            heads, scale, eps, v2, nw_img, ln_count)
    nw, s, c = x.shape
    if c // heads != HEAD_DIM or s > MAX_TOKENS or c % 16:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}, at most {MAX_TOKENS} tokens a window and C a "
                         f"multiple of 16, got C = {c}, {heads} heads, S = {s}")
    _check_card(x, w_qkv, w_o)
    tokens = nw * s
    qkv = torch.empty((tokens, 3 * c), dtype=torch.float32, device=x.device)
    joined = torch.empty_like(x)
    branch = torch.empty((tokens, c), dtype=torch.float32, device=x.device) if v2 else None
    out = torch.empty_like(x)
    ln_g, ln_b, b_qkv, b_o, rel_bias = _f32c(ln_g), _f32c(ln_b), _f32c(b_qkv), _f32c(b_o), _f32c(rel_bias)
    mask = None if mask is None else _f32c(mask)
    logit_scale = None if logit_scale is None else _f32c(logit_scale)
    _build.launch(_lib(), "cvt_window_attention_block", x, x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
                  w_qkv.data_ptr(), b_qkv.data_ptr(), w_o.data_ptr(), b_o.data_ptr(), rel_bias.data_ptr(),
                  None if mask is None else mask.data_ptr(),
                  None if logit_scale is None else logit_scale.data_ptr(), qkv.data_ptr(), joined.data_ptr(),
                  None if branch is None else branch.data_ptr(), out.data_ptr(), nw, s, c, heads, nw_img,
                  float(scale), float(eps), int(bool(v2)), int(ln_count), int(x.dtype == torch.bfloat16))
    _build.count_launch(window_attention_block, x)
    window_attention_block.kernel_launches += 4 if v2 else 3
    return out


_build.reset_count(window_attention_block)
window_attention_block.kernel_launches = 0
