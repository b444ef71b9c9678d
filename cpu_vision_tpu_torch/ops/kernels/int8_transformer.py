"""The int8 sub-blocks of a transformer encoder layer for post-training
quantised serving (CUDA, ``csrc/int8_transformer.cu``) and their plain
PyTorch twins.

Counterpart of the JAX package's ``ops/pallas/int8_transformer.py``:

* ``quantize_weight(w)``: per-output-channel (last axis) symmetric int8,
  ``(q, scale)``;
* ``mlp_block_int8``: ``x + (q2(gelu(q1(LN(x)) @ qw1 * s1 + b1)) @ qw2) * s2 + b2``
  for 2-D ``x`` (tokens, D);
* ``attention_block_int8``: ``x + qo(MHA(q1(LN(x)) @ qw_qkv * s_qkv + b_qkv)) @ qw_o * s_o + b_o``
  for 3-D ``x`` (N, S, D), ``qw_qkv`` (D, 3D) laid out [q | k | v] with each
  section head-major.

``q(f)[c] = clip(rint(f[c] / a[c]), -127, 127)`` quantises an activation to
its static scale ``a`` (a scalar or one a channel), multiplying by ``1 / a``
computed once in float32, never dividing.  The int8 weights are quantised from
float weights with the activation scales folded into their rows, so ``s1``,
``s2``, ``s_qkv`` and ``s_o`` are the whole dequantisation scales.  Products
sum exactly in int32; LayerNorm, gelu (the Abramowitz-Stegun erf), softmax and
every rescale are float32; the QKV product is rounded to x's dtype after its
bias, and the attention output is quantised from float32.  The JAX functions'
``block_m`` and ``interpret`` arguments have no counterpart here.

A wrapper given CUDA tensors launches its hand-written kernels, adds one to its
``launches`` count and raises if a launch fails or the kernels do not take
the arguments; given CPU tensors it runs the twin.  Every product runs on the
int8 tensor cores (``wgmma`` s8, int32 sums: ``csrc/int8_gemm.cuh``), after
the LayerNorm rows quantised to int8 by a launch of their own; the int8
activations between launches make one round trip through device memory.
``mlp_block_int8`` is three kernel launches a call, counted in its
``kernel_launches``: the LayerNorm rows, the up- and the down-projection.
``attention_block_int8`` is four: the LayerNorm rows, the QKV product, the
attention core and the output product.
On the card ``x`` is float32 or bfloat16 and contiguous, ``mlp_block_int8``
takes D in ``MLP_DIMS`` and Dh a multiple of 256, ``attention_block_int8`` D a
multiple of 16 and a head dim of ``flash_attention.HEAD_DIMS``.  The kernels
read the weights transposed: a weight that is the transposed view of a
contiguous tensor costs no copy.  ``mlp_block_int8`` sums the down-projection
in int32 over the whole hidden dim, where the JAX kernel sums float32 partials
of hidden blocks once the weights outgrow its memory (ViT-H).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..._dtype import full_float32
from . import _build
from .flash_attention import DTYPES, HEAD_DIMS
from .int8_matmul import int_mm, quantize_i8
from .transformer_block import _gelu_f32, _ln_f32

__all__ = ["quantize_weight", "mlp_block_int8", "mlp_block_int8_plain", "attention_block_int8",
           "attention_block_int8_plain", "attention_block_int8_joined", "attention_block_int8_joined_plain",
           "mlp_kernel_takes", "attention_kernel_takes", "MLP_DIMS"]

MLP_DIMS = (256, 512, 768, 1024, 1280)  # the widths held on the card (csrc takes D and Dh multiples of 128)
MLP_HIDDEN_STEP = 256

_c_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("int8_transformer")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cvt_mlp_block_int8.argtypes = [p] * 14 + [i, i, i, f, i, p]
        lib.cvt_mlp_block_int8.restype = ctypes.c_int
        lib.cvt_attention_block_int8.argtypes = [p] * 15 + [i, i, i, i, f, f, i, p]
        lib.cvt_attention_block_int8.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def quantize_weight(w: torch.Tensor):
    """Per-output-channel (last axis) symmetric int8: ``(q, scale)`` with
    ``scale = max(max |w|, 1e-8) / 127`` over every other axis and
    ``q = clip(rint(w / scale))`` (a (D, Dh) matrix, or an HWIO kernel)."""
    w32 = w.float()
    scale = torch.clamp_min(w32.abs().amax(dim=tuple(range(w.ndim - 1))), 1e-8) / 127.0
    return torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8), scale


def mlp_kernel_takes(d: int, dh: int) -> bool:
    """Whether ``mlp_block_int8``'s kernel takes width ``d`` and hidden width ``dh``."""
    return d in MLP_DIMS and dh >= MLP_HIDDEN_STEP and dh % MLP_HIDDEN_STEP == 0


def attention_kernel_takes(d: int, heads: int) -> bool:
    """Whether ``attention_block_int8``'s kernels take width ``d`` in ``heads`` heads."""
    return heads >= 1 and d % heads == 0 and d % 16 == 0 and d // heads in HEAD_DIMS


def _inverse(a, width: int, device) -> torch.Tensor:
    """``1 / a`` in float32 for a scalar or per-channel scale, as (width,)."""
    return (1.0 / torch.as_tensor(a, dtype=torch.float32, device=device).reshape(-1)).expand(width).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _check(x, vectors, weights) -> None:
    if not x.dtype.is_floating_point:
        raise TypeError(f"expects a floating-point x, got {x.dtype}")
    for w in weights:
        if w.dtype != torch.int8 or w.ndim != 2:
            raise TypeError("expects 2-D int8 weights")
    for t in (*vectors, *weights):
        if t.device != x.device:
            raise ValueError("all tensors must lie on one device")


def _check_mlp(x, ln_g, ln_b, qw1, s1, b1, qw2, s2, b2) -> None:
    _check(x, (ln_g, ln_b, s1, b1, s2, b2), (qw1, qw2))
    if x.ndim != 2 or min(x.shape) < 1:
        raise ValueError(f"expects non-empty (tokens, D) input, got {tuple(x.shape)}")
    d, dh = x.shape[1], qw1.shape[1]
    if qw1.shape[0] != d or tuple(qw2.shape) != (dh, d):
        raise ValueError("expects qw1 (D, Dh) and qw2 (Dh, D)")
    if any(t.shape != (n,) for t, n in ((ln_g, d), (ln_b, d), (s1, dh), (b1, dh), (s2, d), (b2, d))):
        raise ValueError("LayerNorm parameters, scales and biases do not match the weights")


def mlp_block_int8_plain(x, ln_g, ln_b, qw1, s1, b1, qw2, s2, b2, a1, a2, eps: float = 1e-6) -> torch.Tensor:
    """Twin of ``cvt_mlp_block_int8``: the same math in plain PyTorch operators."""
    _check_mlp(x, ln_g, ln_b, qw1, s1, b1, qw2, s2, b2)
    d, dh = x.shape[1], qw1.shape[1]
    x32 = x.float()
    q1 = quantize_i8(_ln_f32(x32, ln_g.float(), ln_b.float(), eps), _inverse(a1, d, x.device))
    f = _gelu_f32(int_mm(q1, qw1).float() * s1.float() + b1.float())
    q2 = quantize_i8(f, _inverse(a2, dh, x.device))
    return (x32 + (int_mm(q2, qw2).float() * s2.float() + b2.float())).to(x.dtype)


def _check_card(x: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"the kernels take float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def mlp_block_int8(x, ln_g, ln_b, qw1, s1, b1, qw2, s2, b2, a1, a2, eps: float = 1e-6) -> torch.Tensor:
    """``x + Dense2(gelu(Dense1(LN(x))))`` with int8 products for 2-D ``x``
    (tokens, D); on the card three hand-written launches (LN rows to int8, the
    two products on the int8 tensor cores)."""
    _check_mlp(x, ln_g, ln_b, qw1, s1, b1, qw2, s2, b2)
    if not _build.on_card(x):
        return mlp_block_int8_plain(x, ln_g, ln_b, qw1, s1, b1, qw2, s2, b2, a1, a2, eps)
    m, d = x.shape
    dh = qw1.shape[1]
    if not mlp_kernel_takes(d, dh):
        raise ValueError(f"the kernel takes D in {MLP_DIMS} and Dh a multiple of {MLP_HIDDEN_STEP}, got {d} and {dh}")
    _check_card(x)
    w1t, w2t = qw1.t().contiguous(), qw2.t().contiguous()
    inv1, inv2 = _inverse(a1, d, x.device), _inverse(a2, dh, x.device)
    ln_g, ln_b, s1, b1, s2, b2 = (_f32(t) for t in (ln_g, ln_b, s1, b1, s2, b2))
    q1 = torch.empty((m, d), dtype=torch.int8, device=x.device)
    hidden = torch.empty((m, dh), dtype=torch.int8, device=x.device)
    out = torch.empty_like(x)
    _build.launch(_lib(), "cvt_mlp_block_int8", x, x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), w1t.data_ptr(),
                  s1.data_ptr(), b1.data_ptr(), w2t.data_ptr(), s2.data_ptr(), b2.data_ptr(), inv1.data_ptr(),
                  inv2.data_ptr(), q1.data_ptr(), hidden.data_ptr(), out.data_ptr(), m, d, dh, float(eps),
                  int(x.dtype == torch.bfloat16))
    _build.count_launch(mlp_block_int8, x)
    mlp_block_int8.kernel_launches += 3
    return out


_build.reset_count(mlp_block_int8)
mlp_block_int8.kernel_launches = 0


def _check_attn(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, heads: int) -> None:
    _check(x, (ln_g, ln_b, s_qkv, b_qkv, s_o, b_o), (qw_qkv, qw_o))
    if x.ndim != 3 or min(x.shape) < 1:
        raise ValueError(f"expects non-empty (N, S, D) input, got {tuple(x.shape)}")
    d = x.shape[2]
    if heads < 1 or d % heads:
        raise ValueError(f"D = {d} is not a multiple of heads = {heads}")
    if tuple(qw_qkv.shape) != (d, 3 * d) or tuple(qw_o.shape) != (d, d):
        raise ValueError("expects qw_qkv (D, 3D) and qw_o (D, D)")
    if any(t.shape != (n,) for t, n in ((ln_g, d), (ln_b, d), (s_qkv, 3 * d), (b_qkv, 3 * d), (s_o, d), (b_o, d))):
        raise ValueError("LayerNorm parameters, scales and biases do not match the weights")


def _attention_int8_plain(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads, scale, eps):
    """The twin's block output and its int8 joined heads (N, S, D), the output product's input."""
    _check_attn(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, heads)
    n, s, d = x.shape
    x32 = x.float().reshape(n * s, d)
    q1 = quantize_i8(_ln_f32(x32, ln_g.float(), ln_b.float(), eps), _inverse(a1, d, x.device))
    qkv = (int_mm(q1, qw_qkv).float() * s_qkv.float() + b_qkv.float()).to(x.dtype)
    q, k, v = (t.reshape(n, s, heads, d // heads).float() for t in qkv.split(d, dim=-1))
    with full_float32():
        probs = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k) * scale, dim=-1).to(x.dtype)
        o = torch.einsum("nhqk,nkhd->nqhd", probs.float(), v).reshape(n * s, d)
    joined = quantize_i8(o, _inverse(ao, d, x.device))
    proj = int_mm(joined, qw_o)
    return ((x32 + proj.float() * s_o.float()) + b_o.float()).to(x.dtype).reshape(n, s, d), joined.reshape(n, s, d)


def attention_block_int8_plain(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads: int,
                               scale: float, eps: float = 1e-6) -> torch.Tensor:
    """Twin of ``cvt_attention_block_int8``: the same math in plain PyTorch operators."""
    return _attention_int8_plain(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads, scale, eps)[0]


def attention_block_int8_joined_plain(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads: int,
                                      scale: float, eps: float = 1e-6) -> torch.Tensor:
    """The twin's int8 joined heads (N, S, D): ``quantize_i8(o)`` of its attention output ``o``."""
    return _attention_int8_plain(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads, scale, eps)[1]


def _attention_int8(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads, scale, eps):
    """The block output and its int8 joined heads: the kernels' on CUDA tensors, the twin's on CPU tensors."""
    _check_attn(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, heads)
    if not _build.on_card(x):
        return _attention_int8_plain(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads, scale, eps)
    n, s, d = x.shape
    if not attention_kernel_takes(d, heads):
        raise ValueError(f"the kernels take D a multiple of 16 and head dims {HEAD_DIMS}, got D = {d}, {heads} heads")
    _check_card(x)
    wqkv_t, wo_t = qw_qkv.t().contiguous(), qw_o.t().contiguous()
    inv1, inv_o = _inverse(a1, d, x.device), _inverse(ao, d, x.device)
    ln_g, ln_b, s_qkv, b_qkv, s_o, b_o = (_f32(t) for t in (ln_g, ln_b, s_qkv, b_qkv, s_o, b_o))
    q1 = torch.empty((n, s, d), dtype=torch.int8, device=x.device)
    qkv = torch.empty((n, s, 3 * d), dtype=x.dtype, device=x.device)
    joined = torch.empty((n, s, d), dtype=torch.int8, device=x.device)
    out = torch.empty_like(x)
    _build.launch(_lib(), "cvt_attention_block_int8", x, x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
                  wqkv_t.data_ptr(), s_qkv.data_ptr(), b_qkv.data_ptr(), wo_t.data_ptr(), s_o.data_ptr(),
                  b_o.data_ptr(), inv1.data_ptr(), inv_o.data_ptr(), q1.data_ptr(), qkv.data_ptr(),
                  joined.data_ptr(), out.data_ptr(), n, s, d, heads, float(scale), float(eps),
                  int(x.dtype == torch.bfloat16))
    _build.count_launch(attention_block_int8, x)
    attention_block_int8.kernel_launches += 4
    return out, joined


def attention_block_int8(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads: int, scale: float,
                         eps: float = 1e-6) -> torch.Tensor:
    """``x + Out(MHA(LN(x)))`` with int8 QKV and output products for 3-D ``x``
    (N, S, D); on the card four hand-written launches (LN rows to int8, the QKV
    product, the attention core, the output product)."""
    return _attention_int8(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads, scale, eps)[0]


def attention_block_int8_joined(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads: int,
                                scale: float, eps: float = 1e-6) -> torch.Tensor:
    """The int8 joined heads (N, S, D) that ``attention_block_int8``'s output product reads, from the same four
    launches (counted as that wrapper's) on CUDA tensors, the twin's on CPU tensors.  The block's output is ``x``
    plus a small projection of them, so they are where a fault of the core into int8 shows: held against
    ``attention_block_int8_joined_plain``, every value within one int8 step."""
    return _attention_int8(x, ln_g, ln_b, qw_qkv, s_qkv, b_qkv, qw_o, s_o, b_o, a1, ao, heads, scale, eps)[1]


_build.reset_count(attention_block_int8)
attention_block_int8.kernel_launches = 0
