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
and the number of kernel launches (4 in either dtype, 5 in bf16 v2; v1: LN
rows, QKV product, the window core, the output projection + residual; v2: QKV
product (bf16: v, then q and k in float64), core, output projection, LayerNorm
+ residual) to ``kernel_launches``, and raises if a launch fails or the kernels do not take
the arguments (head dim ``HEAD_DIM``, S ≤ ``MAX_TOKENS``, C a multiple of 16,
``x`` in the weights' dtype); given CPU tensors it runs the twin.  Nothing
falls back from one to the other.  It is differentiable as the JAX
function's ``custom_vjp`` (``swin_attention.py:_bwd``): the backward recomputes
the twin from the saved inputs and differentiates it (``_grad``); the mask is
a constant there and gets no gradient.  On the card the float32 QKV product
(12·C bytes a token), the joined heads, v2's branch rows and v1's LN rows
pass through device memory once each, which the Pallas kernels keep in VMEM.
Both projections and the window core run on the tensor cores: in bfloat16
the product of ``transformer_block.bf16_product`` and ``window_tc_kernel``, in
float32 split TF32 (``csrc/tf32x3.cuh``) and ``window_x3_kernel``; the cores'
occupancy on the card is ``kernel_info``.  The q and k columns of bfloat16
v2's QKV product are summed in float64 on the FP64 tensor cores
(``qkv_f64_kernel``), and the v2 norms in the twin's order, so that q/|q| and
k/|k| rounded to bf16 are the twin's bits.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..._dtype import full_float32
from . import _build, _grad
from .transformer_block import _check_card, _check_float, _dot_f32, _f32c, _ln_f32, _ptr

__all__ = ["window_attention_block", "window_attention_block_plain", "kernel_takes", "kernel_info", "HEAD_DIM",
           "MAX_TOKENS", "KERNEL_INFO"]

HEAD_DIM = 32     # the instantiation in csrc/swin_attention.cu
MAX_TOKENS = 64   # tokens of a window the core holds as one tile
KERNEL_INFO = {"window_x3_kernel": 0, "window_tc_kernel": 1}  # the cores kernel_info reports on: float32, bf16

_c_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("swin_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cvt_window_attention_block.argtypes = [p] * 15 + [i, i, i, i, i, f, f, i, i, i, p]
        lib.cvt_window_attention_block.restype = ctypes.c_int
        lib.cvt_window_core_info.argtypes = [i, p, p, p]
        lib.cvt_window_core_info.restype = ctypes.c_int
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


def _qkv_rows(h: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor, exact: bool) -> torch.Tensor:
    """The float32 QKV rows ``h @ w_qkv + b_qkv`` of values in the compute dtype, summed in float32; with
    ``exact`` the q and k columns (the first two thirds) summed in float64 and rounded to float32 once before the
    float32 bias, a sum that does not depend on the order of its products (the bf16 v2 kernel's,
    ``csrc/swin_attention.cu:qkv_f64_kernel``)."""
    qkv = _dot_f32(h, w_qkv) + b_qkv.float()
    if exact:
        n = 2 * w_qkv.shape[1] // 3
        qkv[..., :n] = (h.double() @ w_qkv[:, :n].double()).float() + b_qkv[:n].float()
    return qkv


def _sum_of_squares(t: torch.Tensor) -> torch.Tensor:
    """Σ t² over the last dim (a power of two) as a pairwise tree of float32 additions of neighbours, the squares
    unfused: the order of the bf16 v2 kernel's norms (``csrc/swin_attention.cu:sum_of_squares16``), keepdim."""
    t = t * t
    while t.shape[-1] > 1:
        t = t[..., 0::2] + t[..., 1::2]
    return t


def window_attention_block_plain(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads: int,
                                 scale: float, eps: float, v2: bool, nw_img: int, ln_count: int = 0) -> torch.Tensor:
    """Twin of ``cvt_window_attention_block``: the same math in plain PyTorch operators.  In bfloat16 v2 the q and k
    columns of the QKV rows are summed in float64 and rounded to float32 once, and the norms of q and k summed as a pairwise tree,
    which the kernel gives bit for bit: a float32 sum in another order flips the bf16 rounding of q/|q| and
    k/|k| that follows, and the logit scale carries one flip past the kernel's rule (``ROADMAP.md``, fault 1)."""
    _check(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads, v2, nw_img, ln_count)
    nw, s, c = x.shape
    hd = c // heads
    dtype = w_qkv.dtype
    exact = v2 and dtype == torch.bfloat16
    x32, g32, b32 = x.float(), ln_g.float(), ln_b.float()
    with full_float32():
        h = x32.to(dtype) if v2 else _ln_f32(x32, g32, b32, eps, ln_count).to(dtype)
        qkv = _qkv_rows(h, w_qkv, b_qkv, exact)
        q, k, v = (a.reshape(nw, s, heads, hd) for a in qkv.split(c, dim=-1))
        v = v.to(dtype).float()
        if v2:
            sum_sq = _sum_of_squares if exact else (lambda t: (t * t).sum(dim=-1, keepdim=True))
            q = q * torch.rsqrt(sum_sq(q).clamp_min(1e-12))
            k = k * torch.rsqrt(sum_sq(k).clamp_min(1e-12))
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


def _window_attention_block_f64(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads: int,
                                scale: float, eps: float, v2: bool, nw_img: int, ln_count: int = 0) -> torch.Tensor:
    """The function of ``window_attention_block`` in float64 throughout, nothing rounded to the weights' dtype: the
    yardstick that the float32 kernel (split-TF32 products) and its twin are both held to by the checks.  No route
    calls it."""
    x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias = (t.double() for t in (x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o,
                                                                             rel_bias))
    nw, s, c = x.shape
    h = x if v2 else _ln_f32(x, ln_g, ln_b, eps, ln_count)
    q, k, v = (a.reshape(nw, s, heads, c // heads) for a in (h @ w_qkv + b_qkv).split(c, dim=-1))
    if v2:
        q = q * torch.rsqrt((q * q).sum(dim=-1, keepdim=True).clamp_min(1e-12))
        k = k * torch.rsqrt((k * k).sum(dim=-1, keepdim=True).clamp_min(1e-12))
        scores = torch.einsum("bnhd,bmhd->bhnm", q, k)
        scores = scores * torch.exp(logit_scale.double().reshape(1, heads, 1, 1).clamp_max(math.log(100.0)))
    else:
        scores = torch.einsum("bnhd,bmhd->bhnm", q * scale, k)
    scores = scores + rel_bias[None]
    if mask is not None:
        scores = scores.reshape(nw // nw_img, nw_img, heads, s, s) + mask.double()[None, :, None]
        scores = scores.reshape(nw, heads, s, s)
    o = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(scores, dim=-1), v).reshape(nw, s, c) @ w_o + b_o
    return x + (_ln_f32(o, ln_g, ln_b, eps, ln_count) if v2 else o)


def kernel_info(name: str, device=None) -> dict:
    """``{"regs", "smem_bytes", "blocks_per_sm"}`` of the window core ``name`` of ``KERNEL_INFO`` on the card: its
    registers a thread, its dynamic shared memory a block, and the blocks an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = _lib().cvt_window_core_info(KERNEL_INFO[name], *(ctypes.addressof(x) for x in vals))
    if err != 0:
        raise RuntimeError(f"cvt_window_core_info({name}) failed with CUDA error {err}")
    return dict(zip(("regs", "smem_bytes", "blocks_per_sm"), (x.value for x in vals)))


def kernel_takes(c: int, heads: int, s: int) -> bool:
    """Whether the kernels take ``c`` channels in ``heads`` heads and windows of ``s`` tokens."""
    return heads >= 1 and c % heads == 0 and c // heads == HEAD_DIM and s <= MAX_TOKENS and c % 16 == 0


def window_attention_block(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads: int,
                           scale: float, eps: float, v2: bool, nw_img: int, ln_count: int = 0) -> torch.Tensor:
    """``x + Proj(WindowMSA(LN(x)))`` over ``x`` (num_windows, S, C); on the
    card four hand-written launches with no transposed copy of q, k, v or the
    heads.  The backward is the twin's, recomputed;
    ``mask`` gets no gradient."""
    _check(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads, v2, nw_img, ln_count)
    mask = None if mask is None else mask.detach()
    return _grad.recompute_backward(_kernel, window_attention_block_plain, x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o,
                                    rel_bias, mask, logit_scale, heads, scale, eps, v2, nw_img, ln_count,
                                    dtype=w_qkv.dtype)


def _kernel(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, heads, scale, eps, v2, nw_img,
            ln_count) -> torch.Tensor:
    """The launches of ``cvt_window_attention_block`` on CUDA tensors, the twin on CPU tensors."""
    if not _build.on_card(x):
        return window_attention_block_plain(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale,
                                            heads, scale, eps, v2, nw_img, ln_count)
    nw, s, c = x.shape
    if not kernel_takes(c, heads, s):
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}, at most {MAX_TOKENS} tokens a window and C a "
                         f"multiple of 16, got C = {c}, {heads} heads, S = {s}")
    _check_card(x, w_qkv, w_o)
    tokens = nw * s
    bf16 = x.dtype == torch.bfloat16
    qkv = torch.empty((tokens, 3 * c), dtype=torch.float32, device=x.device)
    joined = torch.empty_like(x)
    branch = torch.empty((tokens, c), dtype=torch.float32, device=x.device) if v2 else None
    ln_rows = None if v2 else torch.empty_like(x)
    out = torch.empty_like(x)
    ln_g, ln_b, b_qkv, b_o, rel_bias = _f32c(ln_g), _f32c(ln_b), _f32c(b_qkv), _f32c(b_o), _f32c(rel_bias)
    mask = None if mask is None else _f32c(mask)
    logit_scale = None if logit_scale is None else _f32c(logit_scale)
    _build.launch(_lib(), "cvt_window_attention_block", x, x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
                  w_qkv.data_ptr(), b_qkv.data_ptr(), w_o.data_ptr(), b_o.data_ptr(), rel_bias.data_ptr(), _ptr(mask),
                  _ptr(logit_scale), qkv.data_ptr(), joined.data_ptr(), _ptr(branch), _ptr(ln_rows), out.data_ptr(),
                  nw, s, c, heads, nw_img, float(scale), float(eps), int(bool(v2)), int(ln_count), int(bf16))
    _build.count_launch(window_attention_block, x)
    window_attention_block.kernel_launches += 5 if bf16 and v2 else 4
    return out


_build.reset_count(window_attention_block)
window_attention_block.kernel_launches = 0
