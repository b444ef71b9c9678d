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

A wrapper given CUDA tensors launches its hand-written kernels, adds one to its
``launches`` count and raises if a launch fails or the kernels do not take
the arguments; given CPU tensors it runs the twin.  Nothing falls back from
one to the other.  All three are differentiable from their saved inputs, the
counterpart of the JAX functions' ``custom_vjp``s, which take ``jax.grad`` of
the same math.  Which backward a call takes is decided by its arguments
(``mlp_backward_takes``, ``attention_backward_takes``), never after a failure:

* bfloat16 (``post_norm=False``, ``ln_count=0``; attention at head dim 64 and
  any S): a backward written for the card, bfloat16 with float32 sums, that
  rounds where the twin rounds and gives the twin's gradient to its
  rounding (``_mlp_backward``, ``_attention_backward``): the kernels
  ``mlp_gelu_backward`` (Kernel A, the gelu's elementwise backward),
  ``flash_attention.attention_core_backward`` (Kernel B, which also gives the
  joined heads again) and ``ln_backward_rows``; ``bf16_product`` for the
  activation gradients ``du·w1ᵀ``, ``g·w_oᵀ`` and ``dqkv·w_qkvᵀ``;
  ``wgrad_matmul`` for every weight gradient; float32 sums for the biases and
  ``cn_mlp_block``'s layer scale (``Σ w2 ∘ (aᵀ·g) + b2 Σ g``).  Three
  products stay ``torch.matmul`` in the twin's own operators, with LayerNorm:
  the recompute of LN(x)·w1 (``u``, float32) and of LN(x)·w_qkv, and the MLP's
  ``g·w2ᵀ``.  Their bfloat16 roundings feed row sums against large
  activations, and a product of another summation order flips ~0.02-0.1% of
  them, each flip moving a weight-gradient entry by up to several times the
  card test's ``1e-2·(1 + |ref|)`` from the twin's
  (``tools/torch_backward_rounding.py``).  ``du``
  and the core's ``ds`` are float32 in the twin and its TF32 products round
  them: here they are rounded to TF32 (to nearest) and every product that
  takes them runs on their two exact bfloat16 halves ([hi | lo]: the twin's
  products term for term).  On CPU tensors the same chain runs the kernels'
  plain versions (``mlp_block_backward_plain``,
  ``attention_block_backward_plain``);
* any other call (float32, ``post_norm``, ``ln_count``, other head dims, longer
  sequences): the twin, recomputed from the saved inputs and differentiated
  (``_grad.recompute_backward``).

On the card each wrapper is a chain of launches, counted in its
``kernel_launches``.  ``mlp_block`` and ``cn_mlp_block`` are three launches in
either dtype (LN, up-projection + gelu, down-projection + residual; with
``post_norm`` up, down into a float32 branch, LN + residual), all products on
the tensor cores: bfloat16 ``wgmma`` (``bf16_product``'s kernel,
``csrc/ln_gemm.cuh``), float32 split TF32, three tf32 products a product
with float32 sums (``csrc/tf32x3.cuh``); the (tokens, Dh) activations make
one round trip through device memory in the weights' dtype.
``attention_block`` is four launches in either dtype (LN, QKV product,
attention core, output projection + residual), its products on the tensor
cores as the MLP's (float32 split TF32).  The LN rows, the QKV product and
the joined heads pass through device memory once in either type; the Pallas
kernels keep all of these in VMEM.  On the card ``x`` (and ``res``)
must have the weights' dtype,
``mlp_block`` and ``cn_mlp_block`` need D in ``MLP_DIMS`` and Dh a multiple of
256, or of ``MLP_HIDDEN_STEP`` up to D = ``MLP_RAGGED_MAX_DIM``, and
``attention_block`` needs D a multiple of 16 and a head dim of
``flash_attention.HEAD_DIMS``.

``bf16_product`` is the bfloat16 tensor-core product alone, ``Epi(a @ w)``
with f32 sums and one of the three epilogues of the blocks: ``"bias"``
(``acc + bias``, bfloat16 or float32 out), ``"gelu"`` (``gelu(acc + bias)``) or
``"residual"`` (``resid + gamma * (acc + bias)``, ``gamma`` optional).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional

import torch

from ..._dtype import float32_products
from . import _build, _grad
from . import flash_attention
from .flash_attention import DTYPES, HEAD_DIMS
from .wgrad_matmul import wgrad_matmul, wgrad_matmul_plain

__all__ = ["mlp_block", "mlp_block_plain", "cn_mlp_block", "cn_mlp_block_plain", "attention_block",
           "attention_block_plain", "bf16_product", "bf16_product_plain", "mlp_kernel_takes", "attention_kernel_takes",
           "mlp_backward_takes", "attention_backward_takes", "mlp_gelu_backward", "mlp_gelu_backward_plain",
           "ln_backward_rows", "ln_backward_plain", "mlp_block_backward_plain", "attention_block_backward_plain",
           "MLP_DIMS", "PRODUCT_EPILOGUES"]

MLP_DIMS = (96, 128, 192, 256, 384, 512, 768, 1024, 1280, 1536)  # the widths held on the card (csrc takes D % 32 == 0)
MLP_HIDDEN_STEP = 64       # Dh is a multiple of 256, or of this up to D = MLP_RAGGED_MAX_DIM
MLP_RAGGED_MAX_DIM = 512
PRODUCT_EPILOGUES = ("bias", "gelu", "residual")  # bf16_product's, in the order of csrc's TC_BIAS, TC_GELU, TC_RESID
LN_BACKWARD_BLOCKS_AN_SM = 16    # room for ln_backward_rows' per-block sums: the most blocks of its kernels an SM holds

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
        lib.cvt_mlp_block.argtypes = [p] * 13 + [i, i, i, f, i, i, i, p]
        lib.cvt_mlp_block.restype = ctypes.c_int
        lib.cvt_attention_block.argtypes = [p] * 11 + [i, i, i, i, f, f, i, p]
        lib.cvt_attention_block.restype = ctypes.c_int
        lib.cvt_bf16_product.argtypes = [p] * 6 + [i, i, i, i, i, p]
        lib.cvt_bf16_product.restype = ctypes.c_int
        lib.cvt_mlp_gelu_backward.argtypes = [p] * 6 + [i, i, p]
        lib.cvt_mlp_gelu_backward.restype = ctypes.c_int
        lib.cvt_ln_backward.argtypes = [p] * 7 + [i, i, f, i, i, i, p]
        lib.cvt_ln_backward.restype = ctypes.c_int
        lib.cvt_ln_backward_info.argtypes = [p] * 5 + [i, i, i, i, i, p]
        lib.cvt_ln_backward_info.restype = ctypes.c_int
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


def _gelu_grad_f32(h: torch.Tensor) -> torch.Tensor:
    """d ``_gelu_f32`` / dh written out: the derivative of the polynomial erf, as autograd takes it."""
    z = h * (1.0 / math.sqrt(2.0))
    a = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    dpoly = 0.254829592 + t * (2 * -0.284496736 + t * (3 * 1.421413741 + t * (4 * -1.453152027 + t * 5 * 1.061405429)))
    e = torch.exp(-a * a)
    erf = torch.sign(z) * (1.0 - poly * e)
    derf = (dpoly * 0.3275911 * t * t + 2.0 * a * poly) * e
    return 0.5 * (1.0 + erf) + 0.5 * h * derf * (1.0 / math.sqrt(2.0))


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
    with float32_products(dtype):
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
    """The launches of ``cvt_mlp_block`` for the wrapper ``fn``; ``gamma`` None for no scale."""
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
    bf16 = x.dtype == torch.bfloat16
    # scratch: LN(x) rows, the gelu activations, post_norm's float32 branch
    ln_rows = None if post_norm else torch.empty_like(x)
    hidden = torch.empty((m, dh), dtype=x.dtype, device=x.device)
    branch = torch.empty((m, d), dtype=torch.float32, device=x.device) if post_norm else None
    _build.launch(_lib(), "cvt_mlp_block", x, x.data_ptr(), resid.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), _ptr(gamma), out.data_ptr(),
                  _ptr(ln_rows), _ptr(hidden), _ptr(branch), m, d, dh, float(eps), int(bool(post_norm)),
                  int(ln_count), int(bf16))
    _build.count_launch(fn, x)
    fn.kernel_launches += 3
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _mlp_kernel(x, ln_g, ln_b, w1, b1, w2, b2, eps, post_norm, ln_count) -> torch.Tensor:
    """The launches of ``cvt_mlp_block`` on CUDA tensors, the twin on CPU tensors."""
    if not _build.on_card(x):
        return mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2, eps, post_norm, ln_count)
    return _launch_mlp(mlp_block, x, x, ln_g, ln_b, w1, b1, w2, b2, None, eps, post_norm, ln_count)


def mlp_backward_takes(x: torch.Tensor, w1: torch.Tensor, post_norm: bool = False, ln_count: int = 0) -> bool:
    """Whether an MLP block (``mlp_block``, ``cn_mlp_block``) of these arguments takes the backward written for the
    card (bfloat16 ``x`` and weights, LayerNorm before the branch over all channels); else the recomputed twin's."""
    return x.dtype == w1.dtype == torch.bfloat16 and not post_norm and not ln_count


def _mlp_block_backward(args, grad, needs):
    x, ln_g, ln_b, w1, b1, w2, b2, eps, _, _ = args
    dx, dg, db, dw1, db1, dw2, db2, _ = _mlp_backward(x, ln_g, ln_b, w1, b1, w2, b2, None, grad, eps, True, False)
    return dx, dg, db, dw1, db1, dw2, db2, None, None, None


def mlp_block(x, ln_g, ln_b, w1, b1, w2, b2, eps: float = 1e-6, post_norm: bool = False,
              ln_count: int = 0) -> torch.Tensor:
    """``x + Dense2(gelu(Dense1(LN(x))))`` for 2-D ``x`` (tokens, D).  On the
    card three launches (LN, two tensor-core products: bfloat16 ``wgmma``, or
    split TF32 in float32), whose activations make one round trip through
    device memory.  The backward is the card's (Kernel A, ``ln_backward_rows``,
    products) where ``mlp_backward_takes`` the call, else the twin's,
    recomputed."""
    _check_mlp(x, ln_g, ln_b, w1, b1, w2, b2)
    if mlp_backward_takes(x, w1, post_norm, ln_count):
        return _grad.explicit_backward(_mlp_kernel, _mlp_block_backward, x, ln_g, ln_b, w1, b1, w2, b2, eps,
                                       post_norm, ln_count)
    return _grad.recompute_backward(_mlp_kernel, mlp_block_plain, x, ln_g, ln_b, w1, b1, w2, b2, eps, post_norm,
                                    ln_count, dtype=w1.dtype)


_build.reset_count(mlp_block)
mlp_block.kernel_launches = 0


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
    with float32_products(dtype):
        h = _ln_f32(y.float(), ln_g.float(), ln_b.float(), eps).to(dtype)
        h = _gelu_f32(_dot_f32(h, w1) + b1.float()).to(dtype)
        h = (_dot_f32(h, w2) + b2.float()) * layer_scale.float()
    return (res.float() + h).to(res.dtype)


def _cn_kernel(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps) -> torch.Tensor:
    """The launches of ``cvt_mlp_block`` with a residual and a scale on CUDA tensors, the twin on CPU tensors."""
    if not _build.on_card(y):
        return cn_mlp_block_plain(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps)
    return _launch_mlp(cn_mlp_block, y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps, False, 0)


def _cn_mlp_block_backward(args, grad, needs):
    y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps = args
    dy, dg, db, dw1, db1, dw2, db2, dls = _mlp_backward(y, ln_g, ln_b, w1, b1, w2, b2, layer_scale, grad, eps, False,
                                                        False)
    return dy, grad, dg, db, dw1, db1, dw2, db2, dls, None


def cn_mlp_block(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps: float = 1e-6) -> torch.Tensor:
    """``res + layer_scale * (Dense2(gelu(Dense1(LN(y)))) + b2)`` for 2-D ``y``
    and ``res`` (tokens, D), the tail of a ConvNeXt block after its depthwise
    convolution; on the card the launches of ``mlp_block`` with a residual
    and a scale.  The backward is ``mlp_block``'s card backward where
    ``mlp_backward_takes`` the call (``res`` gets ``g``, the branch
    ``g·layer_scale``), else the twin's, recomputed."""
    _check_cn(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale)
    args = (y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps)
    if mlp_backward_takes(y, w1) and res.dtype == y.dtype:
        return _grad.explicit_backward(_cn_kernel, _cn_mlp_block_backward, *args)
    return _grad.recompute_backward(_cn_kernel, cn_mlp_block_plain, *args, dtype=w1.dtype)


_build.reset_count(cn_mlp_block)
cn_mlp_block.kernel_launches = 0


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
    with float32_products(dtype):
        h = _ln_f32(x32, ln_g.float(), ln_b.float(), eps).to(dtype)
        qkv = (_dot_f32(h, w_qkv) + b_qkv.float()).to(dtype)
        q, k, v = (a.reshape(n, s, heads, d // heads).float() for a in qkv.split(d, dim=-1))
        scores = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
        probs = torch.softmax(scores, dim=-1).to(dtype)
        o = torch.einsum("nhqk,nkhd->nqhd", probs.float(), v).reshape(n, s, d).to(dtype)
        o = _dot_f32(o, w_o)
    return (x32 + o + b_o.float()).to(x.dtype)


def _attention_block_f64(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, scale: float,
                         eps: float = 1e-6) -> torch.Tensor:
    """The function of ``attention_block`` in float64 throughout, nothing rounded to the weights' dtype: the
    yardstick that the float32 kernel (split-TF32 products) and its twin are both held to by the checks.  No route
    calls it."""
    x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o = (t.double() for t in (x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o))
    n, s, d = x.shape
    q, k, v = (a.reshape(n, s, heads, d // heads) for a in (_ln_f32(x, ln_g, ln_b, eps) @ w_qkv + b_qkv).split(d, -1))
    probs = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k) * scale, dim=-1)
    return x + torch.einsum("nhqk,nkhd->nqhd", probs, v).reshape(n, s, d) @ w_o + b_o


def _attention_kernel(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads, scale, eps) -> torch.Tensor:
    """The four launches of ``cvt_attention_block`` on CUDA tensors, the twin on CPU tensors."""
    if not _build.on_card(x):
        return attention_block_plain(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads, scale, eps)
    n, s, d = x.shape
    if not attention_kernel_takes(d, heads):
        raise ValueError(f"the kernel takes D a multiple of 16 and head dims {HEAD_DIMS}, got D = {d}, {heads} heads")
    _check_card(x, w_qkv, w_o)
    bf16 = x.dtype == torch.bfloat16
    qkv = torch.empty((n, s, 3 * d), dtype=x.dtype, device=x.device)
    joined = torch.empty_like(x)
    ln_rows = torch.empty_like(x)
    out = torch.empty_like(x)
    ln_g, ln_b, b_qkv, b_o = _f32c(ln_g), _f32c(ln_b), _f32c(b_qkv), _f32c(b_o)
    _build.launch(_lib(), "cvt_attention_block", x, x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
                  w_qkv.data_ptr(), b_qkv.data_ptr(), w_o.data_ptr(), b_o.data_ptr(), qkv.data_ptr(),
                  joined.data_ptr(), ln_rows.data_ptr(), out.data_ptr(), n, s, d, heads, float(scale), float(eps),
                  int(bf16))
    _build.count_launch(attention_block, x)
    attention_block.kernel_launches += 4
    return out


def attention_backward_takes(x: torch.Tensor, w_qkv: torch.Tensor, heads: int) -> bool:
    """Whether ``attention_block`` of these arguments takes the backward written for the card (bfloat16 ``x`` and
    weights, a core that ``flash_attention.core_backward_takes``); else the recomputed twin's."""
    return (x.dtype == w_qkv.dtype == torch.bfloat16 and x.shape[2] % heads == 0
            and flash_attention.core_backward_takes(x.dtype, x.shape[1], x.shape[2] // heads))


def _attention_block_backward(args, grad, needs):
    x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads, scale, eps = args
    return (*_attention_backward(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, grad, heads, scale, eps, False), None, None,
            None)


def attention_block(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, scale: float,
                    eps: float = 1e-6) -> torch.Tensor:
    """``x + Out(MHA(LN(x)))`` for 3-D ``x`` (N, S, D); on the card four
    hand-written launches (LN rows, QKV product, core, output product) with no
    transposed copy of q, k, v or the heads.  The backward is the card's (Kernel B,
    ``ln_backward_rows``, products) where ``attention_backward_takes`` the
    call, else the twin's, recomputed."""
    _check_attn(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads)
    args = (x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads, scale, eps)
    if attention_backward_takes(x, w_qkv, heads):
        return _grad.explicit_backward(_attention_kernel, _attention_block_backward, *args)
    return _grad.recompute_backward(_attention_kernel, attention_block_plain, *args, dtype=w_qkv.dtype)


_build.reset_count(attention_block)
attention_block.kernel_launches = 0


def _check_product(a, w, bias, epilogue, resid, gamma, out_dtype) -> None:
    for t in (a, w):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the product takes bfloat16 a and w, got {t.dtype}")
    _check_float(a, w, bias, *(t for t in (resid, gamma) if t is not None))
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0] or min(a.shape) < 1 or w.shape[1] < 1:
        raise ValueError(f"expects a (m, k) and w (k, n), got {tuple(a.shape)} and {tuple(w.shape)}")
    m, n = a.shape[0], w.shape[1]
    if bias.shape != (n,):
        raise ValueError(f"expects bias ({n},), got {tuple(bias.shape)}")
    if epilogue not in PRODUCT_EPILOGUES:
        raise ValueError(f"epilogue must be one of {PRODUCT_EPILOGUES}, got {epilogue!r}")
    if (epilogue == "residual") != (resid is not None) or (gamma is not None and epilogue != "residual"):
        raise ValueError("resid goes with the residual epilogue, and gamma only with it")
    if resid is not None and (resid.shape != (m, n) or resid.dtype != torch.bfloat16):
        raise ValueError(f"expects resid ({m}, {n}) of bfloat16")
    if gamma is not None and gamma.shape != (n,):
        raise ValueError(f"expects gamma ({n},)")
    if out_dtype not in (torch.bfloat16, torch.float32) or (out_dtype == torch.float32 and epilogue != "bias"):
        raise ValueError(f"the product writes bfloat16, or float32 with the bias epilogue, got {out_dtype}")


def bf16_product_plain(a, w, bias, epilogue: str = "bias", resid=None, gamma=None,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Twin of ``cvt_bf16_product``: the same math in plain PyTorch operators."""
    _check_product(a, w, bias, epilogue, resid, gamma, out_dtype)
    with float32_products(torch.bfloat16):
        acc = _dot_f32(a, w) + bias.float()
    if epilogue == "gelu":
        acc = _gelu_f32(acc)
    elif epilogue == "residual":
        if gamma is not None:
            acc = acc * gamma.float()
        acc = resid.float() + acc
    return acc.to(out_dtype)


def bf16_product(a, w, bias, epilogue: str = "bias", resid=None, gamma=None,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``Epi(a @ w)`` for bfloat16 ``a`` (m, k) and ``w`` (k, n), the tensor-core
    product of the bf16 blocks alone (one launch on the card; k a multiple of
    16, n of 8), with ``epilogue`` in ``PRODUCT_EPILOGUES``."""
    _check_product(a, w, bias, epilogue, resid, gamma, out_dtype)
    if not _build.on_card(a):
        return bf16_product_plain(a, w, bias, epilogue, resid, gamma, out_dtype)
    (m, k), n = a.shape, w.shape[1]
    if k % 16 or n % 8:
        raise ValueError(f"the product takes k a multiple of 16 and n of 8, got k = {k}, n = {n}")
    _check_card(a, w, *(t for t in (resid,) if t is not None))
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    bias = _f32c(bias)
    gamma = None if gamma is None else _f32c(gamma)
    _build.launch(_lib(), "cvt_bf16_product", a, a.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(resid),
                  _ptr(gamma), out.data_ptr(), m, k, n, PRODUCT_EPILOGUES.index(epilogue),
                  int(out_dtype == torch.float32))
    _build.count_launch(bf16_product, a)
    return out


_build.reset_count(bf16_product)


# ------------------------------------------------------------------------- the bf16 blocks' backward


def _check_ln_backward(x, ln_g, dh, resid) -> None:
    _check_float(x, ln_g, dh, *(t for t in (resid,) if t is not None))
    if x.ndim != 2 or min(x.shape) < 1 or dh.shape != x.shape or ln_g.shape != (x.shape[1],):
        raise ValueError(f"expects x and dh (rows, D) and ln_g (D,), got {tuple(x.shape)}, {tuple(dh.shape)}, "
                         f"{tuple(ln_g.shape)}")
    if resid is not None and resid.shape != x.shape:
        raise ValueError("resid must be shaped like x")


def ln_backward_plain(x, ln_g, dh, resid=None, eps: float = 1e-6) -> tuple:
    """Plain version of ``ln_backward_rows``: ``(dx, d ln_g, d ln_b)`` of
    ``LN(x)·ln_g + ln_b`` over the rows of ``x`` given ``dh`` (the gradient of
    LN's output), with ``resid`` (the gradient that reaches ``x`` past the
    branch, or None) added to ``dx``; statistics from ``x`` in float32,
    ``dx`` in ``x``'s dtype, the parameters' gradients float32."""
    _check_ln_backward(x, ln_g, dh, resid)
    x32, dh32 = x.float(), dh.float()
    c = x32 - x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    xh = c * rstd
    gd = dh32 * ln_g.float()
    dx = rstd * (gd - gd.mean(dim=-1, keepdim=True) - xh * (gd * xh).mean(dim=-1, keepdim=True))
    if resid is not None:
        dx = resid.float() + dx
    return dx.to(x.dtype), (dh32 * xh).sum(dim=0), dh32.sum(dim=0)


def ln_backward_rows(x, ln_g, dh, resid=None, eps: float = 1e-6) -> tuple:
    """``(dx, d ln_g, d ln_b)`` as ``ln_backward_plain``: on the card (``x``,
    ``dh`` and ``resid`` of one dtype, contiguous) one kernel on a persistent
    grid, rows read once with 16-byte loads and the parameters' sums kept in
    registers (``ln_backward_vec_kernel``; any row it does not take, by width or
    alignment, goes to the scalar ``ln_backward_kernel``), then a pass that
    adds the blocks' sums in block order (the same bits every call); the plain
    version on CPU tensors."""
    _check_ln_backward(x, ln_g, dh, resid)
    if not _build.on_card(x):
        return ln_backward_plain(x, ln_g, dh, resid, eps)
    _check_card(x, dh, *(t for t in (resid,) if t is not None))
    m, d = x.shape
    capacity = LN_BACKWARD_BLOCKS_AN_SM * _build.sm_count(x)
    dx = torch.empty_like(x)
    partial = torch.empty((capacity, 2, d), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, d), dtype=torch.float32, device=x.device)
    _build.launch(_lib(), "cvt_ln_backward", x, x.data_ptr(), _f32c(ln_g).data_ptr(), dh.data_ptr(), _ptr(resid),
                  dx.data_ptr(), partial.data_ptr(), sums.data_ptr(), m, d, float(eps), _build.sm_count(x), capacity,
                  int(x.dtype == torch.bfloat16))
    _build.count_launch(ln_backward_rows, x)
    return dx, sums[0], sums[1]


_LN_BACKWARD_INFO = ("chunks_a_lane", "threads", "shared_bytes", "blocks_per_sm", "registers", "grid")


def ln_backward_info(x, ln_g, dh, resid=None) -> dict:
    """What ``ln_backward_rows`` launches for these tensors: the 16-byte chunks of a row a lane holds
    (``chunks_a_lane``; 0 is the scalar kernel), threads and shared bytes a block, blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers a thread and the grid.  Launches nothing."""
    m, d = x.shape
    info = (ctypes.c_int * len(_LN_BACKWARD_INFO))()
    ln_g = _f32c(ln_g)
    with torch.cuda.device(x.device) if x.is_cuda else contextlib.nullcontext():  # a CPU tensor: the emulator
        err = _lib().cvt_ln_backward_info(x.data_ptr(), ln_g.data_ptr(), dh.data_ptr(), _ptr(resid), x.data_ptr(),
                                          m, d, _build.sm_count(x), LN_BACKWARD_BLOCKS_AN_SM * _build.sm_count(x),
                                          int(x.dtype == torch.bfloat16), info)
    if err != 0:
        raise RuntimeError(f"cvt_ln_backward_info: CUDA error {err}")
    return dict(zip(_LN_BACKWARD_INFO, info))


_build.reset_count(ln_backward_rows)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """The float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest with ties away from zero (``cvt.rna``)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The float32 ``x`` as [hi | lo] (rows, 2 cols) of ``dtype``: for bfloat16, ``x`` rounded to TF32 (what a TF32
    product does to it) = hi + lo exactly; for float32, ``x`` and zeros."""
    if dtype == torch.float32:
        return torch.cat([x, torch.zeros_like(x)], dim=-1)
    t = _tf32_rna(x)
    hi = t.to(dtype)
    return torch.cat([hi, (t - hi.float()).to(dtype)], dim=-1)


GELU_BACKWARD_ROWS = 64  # rows whose column sums a block of Kernel A adds (csrc/transformer_block.cu: GB_ROWS)


def mlp_gelu_backward_plain(da32, hw, b1, dtype: torch.dtype = torch.bfloat16) -> tuple:
    """Plain version of Kernel A: from the float32 products ``da32 = g·w2ᵀ``
    (the gradient of the MLP's gelu output) and ``hw = h·w1`` (the
    pre-activation without its bias), with ``u = hw + b1`` and ``da`` =
    ``da32`` rounded to the block's compute ``dtype``: ``(du2, a, db1)``, ``du =
    da·gelu'(u)`` as ``du2`` = [hi | lo] (``_split``), ``a = gelu(u)`` rounded to
    ``dtype``, and ``db1``, the column sums of the unrounded ``du``."""
    u = hw.float() + b1.float()
    du = da32.to(dtype).float() * _gelu_grad_f32(u)
    return _split(du, dtype), _gelu_f32(u).to(dtype), du.sum(dim=0)


def mlp_gelu_backward(da32, hw, b1) -> tuple:
    """``(du2, a, db1)`` of the bfloat16 MLP as ``mlp_gelu_backward_plain``,
    for ``da32`` and ``hw`` (m, Dh) of float32 and ``b1`` (Dh,): Kernel A, one
    launch of ``gelu_backward_kernel`` on the card (Dh even), whose per-block
    column sums are then added in block order; the plain version on CPU
    tensors."""
    _check_float(da32, hw, b1)
    if da32.ndim != 2 or hw.shape != da32.shape or b1.shape != (da32.shape[1],):
        raise ValueError(f"expects da32 and hw of one (m, Dh) shape and b1 (Dh,), got {tuple(da32.shape)}, "
                         f"{tuple(hw.shape)} and {tuple(b1.shape)}")
    if not _build.on_card(da32):
        return mlp_gelu_backward_plain(da32, hw, b1)
    m, dh = da32.shape
    if da32.dtype != torch.float32 or hw.dtype != torch.float32 or dh % 2:
        raise ValueError(f"the kernel takes float32 products and an even Dh, got {da32.dtype}, {hw.dtype}, {dh}")
    da32, hw = da32.contiguous(), hw.contiguous()
    du2 = torch.empty((m, 2 * dh), dtype=torch.bfloat16, device=da32.device)
    a = torch.empty((m, dh), dtype=torch.bfloat16, device=da32.device)
    partial = torch.empty((math.ceil(m / GELU_BACKWARD_ROWS), dh), dtype=torch.float32, device=da32.device)
    _build.launch(_lib(), "cvt_mlp_gelu_backward", da32, da32.data_ptr(), hw.data_ptr(), _f32c(b1).data_ptr(),
                  du2.data_ptr(), a.data_ptr(), partial.data_ptr(), m, dh)
    _build.count_launch(mlp_gelu_backward, da32)
    return du2, a, partial.sum(dim=0)


_build.reset_count(mlp_gelu_backward)


def _ln_product(x, ln_g, ln_b, w, eps) -> tuple:
    """(LN(x) rounded to ``w``'s dtype, LN(x)·w in float32, without a bias) for 2-D ``x``: the twin's own
    operators, its bits."""
    h = _ln_f32(x.float(), ln_g.float(), ln_b.float(), eps).to(w.dtype)
    with float32_products(w.dtype):
        return h, _dot_f32(h, w)


def _mlp_backward(x, ln_g, ln_b, w1, b1, w2, b2, layer_scale, g, eps, residual: bool, plain: bool) -> tuple:
    """Gradients of ``x``, ``ln_g``, ``ln_b``, ``w1``, ``b1``, ``w2``, ``b2`` and ``layer_scale`` (None without one) of
    ``[x +] layer_scale·(W2·gelu(W1·LN(x) + b1) + b2)`` given ``g``: the kernels on the card, unless ``plain``; plain
    operators whose products take the twin's (TF32 on the card, float32 on the CPU) otherwise."""
    dtype = w1.dtype
    g = g.contiguous()
    kernel = not plain and _build.on_card(x)
    h, hw = _ln_product(x, ln_g, ln_b, w1, eps)
    g_sum = g.sum(dim=0, dtype=torch.float32)
    dz = g.float() if layer_scale is None else g.float() * layer_scale.float()  # the gradient of W2·a + b2
    with float32_products(dtype):
        da32 = dz @ w2.float().t()  # the twin's product: a bfloat16 g exact in TF32, a float32 dz rounded
    d, dh_ = g.shape[1], w1.shape[1]
    atg = None
    if kernel:
        du2, a, db1 = mlp_gelu_backward(da32, hw, b1)
        del hw, da32
        if layer_scale is None:
            dw2 = wgrad_matmul(a, g)  # aᵀ·g, (Dh, D)
        else:  # dz rounded to TF32 as the twin's products round it, as its two halves; aᵀ·g for the scale
            prods = wgrad_matmul(a, torch.cat([g, _split(dz, dtype)], dim=-1))  # aᵀ·[g | hi | lo], (Dh, 3 D)
            atg, dw2 = prods[:, :d], prods[:, d:2 * d] + prods[:, 2 * d:]
        del a
        dw1 = wgrad_matmul(h, du2)  # hᵀ·[hi | lo]: the two halves' products side by side
        dw1 = dw1[:, :dh_] + dw1[:, dh_:]
        w1t = w1.t()
        dh = bf16_product(du2, torch.cat([w1t, w1t], dim=0), torch.zeros(d, device=x.device))  # du·w1ᵀ
        del du2
    else:
        u = hw + b1.float()
        du = da32.to(dtype).float() * _gelu_grad_f32(u)
        a = _gelu_f32(u).to(dtype)
        db1 = du.sum(dim=0)
        with float32_products(dtype):
            dw2 = _dot_f32(a.t(), dz)
            if layer_scale is not None:
                atg = _dot_f32(a.t(), g)
            dw1 = _dot_f32(h.t(), du)
            dh = _dot_f32(du, w1.t()).to(dtype)
        del u, du, a, hw, da32
    db2, dls = dz.sum(dim=0), None
    if layer_scale is not None:
        dls = (w2.float() * atg).sum(dim=0) + b2.float() * g_sum
    del dz
    dx, dg, db = (ln_backward_rows if kernel else ln_backward_plain)(x, ln_g, dh, g if residual else None, eps)
    return dx, dg, db, dw1, db1, dw2, db2, dls


def mlp_block_backward_plain(x, ln_g, ln_b, w1, b1, w2, b2, g, eps: float = 1e-6, layer_scale=None) -> tuple:
    """The backward of the bfloat16 MLP blocks in plain operators, with the
    kernels' rounding points (in float32 none: the twin's gradient): the
    gradients of ``mlp_block``'s seven tensors given ``g``, or with
    ``layer_scale`` (``cn_mlp_block``, whose ``res`` gets ``g`` itself) of
    ``y``, ``ln_g``, ``ln_b``, ``w1``, ``b1``, ``w2``, ``b2`` and
    ``layer_scale``, each in its input's dtype."""
    _check_mlp(x, ln_g, ln_b, w1, b1, w2, b2)
    grads = _mlp_backward(x, ln_g, ln_b, w1, b1, w2, b2, layer_scale, g, eps, layer_scale is None, True)
    inputs = (x, ln_g, ln_b, w1, b1, w2, b2, layer_scale)
    return tuple(t.to(a.dtype) for t, a in zip(grads, inputs) if a is not None)


def _attention_backward(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, g, heads, scale, eps, plain: bool) -> tuple:
    """Gradients of ``x``, ``ln_g``, ``ln_b``, ``w_qkv``, ``b_qkv``, ``w_o`` and ``b_o`` of ``attention_block`` given
    ``g``: the kernels on the card, unless ``plain``; plain operators whose products take the twin's otherwise.  The
    core's backward gives the joined heads again, as the twin rounds them."""
    n, s, d = x.shape
    hd = d // heads
    dtype = w_qkv.dtype
    kernel = not plain and _build.on_card(x)
    x2, g2 = x.reshape(n * s, d), g.reshape(n * s, d).contiguous()
    h, qkv = _ln_product(x2, ln_g, ln_b, w_qkv, eps)
    qkv = (qkv + b_qkv.float()).to(dtype).reshape(n, s, 3 * d)
    views = [t.reshape(n, s, heads, hd) for t in qkv.split(d, dim=-1)]
    dqkv = torch.empty_like(qkv)
    outs = tuple(t.view(n, s, heads, hd) for t in dqkv.split(d, dim=-1))
    if kernel:
        d_joined = bf16_product(g2, w_o.t().contiguous(), torch.zeros(d, device=x.device))
        joined = torch.empty_like(h)
        flash_attention.attention_core_backward(*views, d_joined.reshape(n, s, heads, hd).transpose(1, 2), scale,
                                                out=outs, o=joined.view(n, s, heads, hd))
        del qkv, d_joined
        dw_o = wgrad_matmul(joined, g2)
        dw_qkv = wgrad_matmul(h, dqkv.reshape(n * s, 3 * d))
        dh = bf16_product(dqkv.reshape(n * s, 3 * d), w_qkv.t().contiguous(), torch.zeros(d, device=x.device))
    else:
        with float32_products(dtype):
            d_joined = _dot_f32(g2, w_o.t()).to(dtype)
        grads = flash_attention.attention_core_backward_plain(*views, d_joined.reshape(n, s, heads, hd).transpose(1, 2),
                                                              scale)
        for t, grad in zip(outs, grads):
            t.copy_(grad)
        joined = flash_attention.flash_mha_plain(*views, scale).transpose(1, 2).reshape(n * s, d)
        with float32_products(dtype):
            dw_o = _dot_f32(joined.t(), g2)
            dw_qkv = _dot_f32(h.t(), dqkv.reshape(n * s, 3 * d))
            dh = _dot_f32(dqkv.reshape(n * s, 3 * d), w_qkv.t()).to(dtype)
    del joined
    db_o = g2.sum(dim=0, dtype=torch.float32)
    db_qkv = dqkv.reshape(n * s, 3 * d).sum(dim=0, dtype=torch.float32)
    del dqkv
    dx, dg, db = (ln_backward_rows if kernel else ln_backward_plain)(x2, ln_g, dh, g2, eps)
    return dx.reshape(n, s, d), dg, db, dw_qkv, db_qkv, dw_o, db_o


def attention_block_backward_plain(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, g, heads: int, scale: float,
                                   eps: float = 1e-6) -> tuple:
    """The backward of the bfloat16 ``attention_block`` in plain operators, with
    the kernels' rounding points (in float32 none: the twin's gradient): the
    gradients of its seven tensors given ``g``, each in its input's dtype."""
    _check_attn(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads)
    grads = _attention_backward(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, g, heads, scale, eps, True)
    return tuple(t.to(a.dtype) for t, a in zip(grads, (x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o)))
