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
one to the other.  ``mlp_block`` and ``attention_block`` are differentiable:
their backward recomputes the twin from the saved inputs and differentiates it
(``_grad``), the counterpart of the JAX functions' ``custom_vjp``s, which take
``jax.grad`` of the same math; ``cn_mlp_block`` has no backward yet (ConvNeXt
training).

On the card each wrapper is a chain of launches, counted in its
``kernel_launches``.  ``mlp_block`` and ``cn_mlp_block`` are three launches in
either dtype (LN, up-projection + gelu, down-projection + residual; with
``post_norm`` up, down into a float32 branch, LN + residual), all products on
the tensor cores: bfloat16 ``wgmma`` (``bf16_product``'s kernel,
``csrc/ln_gemm.cuh``), float32 split TF32, three tf32 products a product
with float32 sums (``csrc/tf32x3.cuh``); the (tokens, Dh) activations make
one round trip through device memory in the weights' dtype.  In float32
``attention_block`` is three launches (LN + QKV product, attention core,
output projection + residual; scalar float32 products), in bfloat16 four (LN,
QKV product, attention core, output projection + residual).  The QKV product
and the joined heads pass through device memory once in either type; the
Pallas kernels keep all of these in VMEM.  On the card ``x`` (and ``res``)
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

import ctypes
import math
from typing import Optional

import torch

from ..._dtype import float32_products
from . import _build, _grad
from .flash_attention import DTYPES, HEAD_DIMS

__all__ = ["mlp_block", "mlp_block_plain", "cn_mlp_block", "cn_mlp_block_plain", "attention_block",
           "attention_block_plain", "bf16_product", "bf16_product_plain", "mlp_kernel_takes", "attention_kernel_takes",
           "MLP_DIMS", "PRODUCT_EPILOGUES"]

MLP_DIMS = (96, 128, 192, 256, 384, 512, 768, 1024, 1280, 1536)  # the widths held on the card (csrc takes D % 32 == 0)
MLP_HIDDEN_STEP = 64       # Dh is a multiple of 256, or of this up to D = MLP_RAGGED_MAX_DIM
MLP_RAGGED_MAX_DIM = 512
PRODUCT_EPILOGUES = ("bias", "gelu", "residual")  # bf16_product's, in the order of csrc's TC_BIAS, TC_GELU, TC_RESID

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


def mlp_block(x, ln_g, ln_b, w1, b1, w2, b2, eps: float = 1e-6, post_norm: bool = False,
              ln_count: int = 0) -> torch.Tensor:
    """``x + Dense2(gelu(Dense1(LN(x))))`` for 2-D ``x`` (tokens, D).  On the
    card three launches (LN, two tensor-core products: bfloat16 ``wgmma``, or
    split TF32 in float32), whose activations make one round trip through
    device memory."""
    _check_mlp(x, ln_g, ln_b, w1, b1, w2, b2)
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


def cn_mlp_block(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps: float = 1e-6) -> torch.Tensor:
    """``res + layer_scale * (Dense2(gelu(Dense1(LN(y)))) + b2)`` for 2-D ``y``
    and ``res`` (tokens, D), the tail of a ConvNeXt block after its depthwise
    convolution; on the card the launches of ``mlp_block`` with a residual
    and a scale."""
    _check_cn(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale)
    if not _build.on_card(y):
        return cn_mlp_block_plain(y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps)
    return _launch_mlp(cn_mlp_block, y, res, ln_g, ln_b, w1, b1, w2, b2, layer_scale, eps, False, 0)


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


def _attention_kernel(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads, scale, eps) -> torch.Tensor:
    """The three launches of ``cvt_attention_block`` on CUDA tensors, the twin on CPU tensors."""
    if not _build.on_card(x):
        return attention_block_plain(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads, scale, eps)
    n, s, d = x.shape
    if not attention_kernel_takes(d, heads):
        raise ValueError(f"the kernel takes D a multiple of 16 and head dims {HEAD_DIMS}, got D = {d}, {heads} heads")
    if n > 65535 or heads > 65535:
        raise ValueError(f"at most 65535 images and heads a launch, got {n} and {heads}")
    _check_card(x, w_qkv, w_o)
    bf16 = x.dtype == torch.bfloat16
    qkv = torch.empty((n, s, 3 * d), dtype=x.dtype, device=x.device)
    joined = torch.empty_like(x)
    ln_rows = torch.empty_like(x) if bf16 else None
    out = torch.empty_like(x)
    ln_g, ln_b, b_qkv, b_o = _f32c(ln_g), _f32c(ln_b), _f32c(b_qkv), _f32c(b_o)
    _build.launch(_lib(), "cvt_attention_block", x, x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
                  w_qkv.data_ptr(), b_qkv.data_ptr(), w_o.data_ptr(), b_o.data_ptr(), qkv.data_ptr(),
                  joined.data_ptr(), _ptr(ln_rows), out.data_ptr(), n, s, d, heads, float(scale), float(eps), int(bf16))
    _build.count_launch(attention_block, x)
    attention_block.kernel_launches += 4 if bf16 else 3
    return out


def attention_block(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads: int, scale: float,
                    eps: float = 1e-6) -> torch.Tensor:
    """``x + Out(MHA(LN(x)))`` for 3-D ``x`` (N, S, D); on the card three
    (float32) or four (bfloat16) hand-written launches with no transposed copy
    of q, k, v or the heads."""
    _check_attn(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads)
    return _grad.recompute_backward(_attention_kernel, attention_block_plain, x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o,
                                    heads, scale, eps, dtype=w_qkv.dtype)


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
