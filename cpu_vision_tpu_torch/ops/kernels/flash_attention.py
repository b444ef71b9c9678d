"""Fused multi-head attention (CUDA, ``csrc/attention.cu``) and its plain
PyTorch twin: ``softmax(q kᵀ · scale) v`` per head, scores never in device
memory.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``.  ``q``,
``k`` and ``v`` arrive as the QKV projection leaves them, (N, S, H, hd), and
the output is (N, H, S, hd), in ``q``'s dtype (float32 or bfloat16).  Scores
and softmax are float32; the probabilities are cast to ``q``'s dtype before
the product with ``v``, which sums in float32.  ``flash_mha`` given CUDA
tensors launches the hand-written kernel, adds one to its ``launches`` count
and raises if the launch fails; given CPU tensors it runs the twin.  Nothing
falls back from one to the other.  It is differentiable, from the saved
``q``, ``k``, ``v``.  In bfloat16 at head dim 64 (any S) the backward is
``attention_core_backward`` (Kernel B, ``csrc/tc_attention_bwd.cuh``; on CPU
tensors its plain version), the softmax backward the JAX package writes out
by hand (``flash_attention.py:_bwd``); any other call differentiates the
twin, recomputed (``_grad.recompute_backward``).

``attention_core_backward(q, k, v, do, scale)`` is that backward alone:
``dq``, ``dk``, ``dv`` in ``q``'s layout from ``do`` in the output's, with
``p`` in float32, ``dp = do·vᵀ`` rounded to bfloat16 and ``ds = p (dp − Σ dp p)
· scale`` rounded to TF32 before its products, as the twin's TF32 products
round it (the kernel multiplies its two exact bfloat16 halves), every sum
float32: the twin's gradient, its rounding points and all.  On the card it is
two launches (``attention_core_backward.kernel_launches``): query-tile blocks
(each row's softmax statistics into a float32 scratch, ``dq``, the output),
then key-tile blocks (``dk``, ``dv``).
``attention_block``'s backward hands it views of its (N, S, 3D) QKV buffer,
writes the gradients into one (N, S, 3D) tensor through ``out``, and has it
write the output again through ``o`` with the twin's rounding (probabilities
normalised, then rounded), for the gradient of its output projection.

The kernel streams key tiles with an online softmax and divides by the row
sum at the end; the twin normalises before the cast, as the Pallas kernel
does.  At every head dim of ``HEAD_DIMS`` the kernel runs on the tensor
cores (``wgmma``): bfloat16 as it is (``csrc/tc_attention.cuh``), float32 by
split TF32 (``csrc/tf32x3_attention.cuh``: three TF32 products a product,
within twice the scalar float32 core's distance from float64,
``_flash_mha_scalar``).  In float32 the two differ by the order and rounding
of sums; in bfloat16 also by where the probabilities are rounded (before or
after the division), both within the bfloat16 step.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..._dtype import float32_products
from . import _build, _grad

__all__ = ["flash_mha", "flash_mha_plain", "attention_core_backward",
           "attention_core_backward_plain", "core_backward_takes", "kernel_info", "HEAD_DIMS"]

HEAD_DIMS = (16, 64, 80)  # instantiations of the cores in csrc/attention.cuh, all on the tensor cores
BWD_HEAD_DIM = 64  # Kernel B's head dim (csrc/tc_attention_bwd.cuh)
DTYPES = (torch.float32, torch.bfloat16)
# the kernels kernel_info reports on, as (which, head dim) of cvt_attention_kernel_info: Kernel B's two launches, the
# split-TF32 float32 core and the bf16 core at each head dim
KERNEL_INFO = {"attention_bwd_q_kernel": (0, BWD_HEAD_DIM), "attention_bwd_kv_kernel": (1, BWD_HEAD_DIM),
               **{f"attention_x3_kernel<{hd}>": (2, hd) for hd in HEAD_DIMS},
               **{f"attention_tc_kernel<{hd}>": (3, hd) for hd in HEAD_DIMS}}

_c_lib: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _c_lib
    if _c_lib is None:
        lib = _build.load("attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cvt_flash_mha.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.cvt_flash_mha.restype = ctypes.c_int
        lib.cvt_attention_core_backward.argtypes = [p] * 9 + [i, i, i, ctypes.c_float] + [ctypes.c_longlong] * 9 + [p]
        lib.cvt_attention_core_backward.restype = ctypes.c_int
        lib.cvt_attention_core_backward_stats_floats.argtypes = [i, i, i]
        lib.cvt_attention_core_backward_stats_floats.restype = ctypes.c_longlong
        lib.cvt_attention_core_scalar.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, p]
        lib.cvt_attention_core_scalar.restype = ctypes.c_int
        lib.cvt_attention_kernel_info.argtypes = [i, i, p, p, p]
        lib.cvt_attention_kernel_info.restype = ctypes.c_int
        _c_lib = lib
    return _c_lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or min(q.shape) < 1:
        raise ValueError(f"expects non-empty (N, S, H, hd) tensors, got {tuple(q.shape)}")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share shape, dtype and device")
    if q.dtype not in DTYPES:
        raise TypeError(f"expects float32 or bfloat16 tensors, got {q.dtype}")


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Twin of ``cvt_flash_mha``: float32 scores and softmax, probabilities
    cast to ``q``'s dtype, float32 sums; (N, S, H, hd) → (N, H, S, hd)."""
    _check(q, k, v)
    with float32_products(q.dtype):
        scores = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * scale
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("nhqk,nkhd->nhqd", probs.float(), v.float()).to(q.dtype)


def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """One launch of ``cvt_flash_mha`` on CUDA tensors, the twin on CPU tensors."""
    if not _build.on_card(q):
        return flash_mha_plain(q, k, v, scale)
    n, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel has head dims {HEAD_DIMS}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries (the tensor-core cores copy 16 bytes at a "
                         "time)")
    out = torch.empty((n, h, s, hd), dtype=q.dtype, device=q.device)
    _build.launch(_lib(), "cvt_flash_mha", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  n, s, h, hd, float(scale), int(q.dtype == torch.bfloat16))
    _build.count_launch(flash_mha, q)
    return out


def _flash_mha_scalar(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The scalar float32 core (``csrc/attention.cuh:attention_core_kernel``, f32 FMAs) that the split-TF32 cores
    replaced, at a head dim of ``HEAD_DIMS``, as ``flash_mha`` lays it out: the yardstick of those cores' distance
    from float64, run by no path and counted nowhere.  On CPU tensors the twin."""
    _check(q, k, v)
    if not _build.on_card(q):
        return flash_mha_plain(q, k, v, scale)
    n, s, h, hd = q.shape
    if q.dtype != torch.float32 or hd not in HEAD_DIMS or not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"takes contiguous float32 q, k, v of head dims {HEAD_DIMS}, got {q.dtype}, head dim {hd}")
    out = torch.empty((n, h, s, hd), dtype=q.dtype, device=q.device)
    _build.launch(_lib(), "cvt_attention_core_scalar", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  n, s, h, hd, float(scale))
    return out


def kernel_info(name: str, device=None) -> dict:
    """``{"regs", "smem_bytes", "blocks_per_sm"}`` of the kernel ``name`` of ``KERNEL_INFO`` on the card: its
    registers a thread, its dynamic shared memory a block, and the blocks an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = _lib().cvt_attention_kernel_info(*KERNEL_INFO[name], *(ctypes.addressof(x) for x in vals))
    if err != 0:
        raise RuntimeError(f"cvt_attention_kernel_info({name}) failed with CUDA error {err}")
    return dict(zip(("regs", "smem_bytes", "blocks_per_sm"), (x.value for x in vals)))


def core_backward_takes(dtype: torch.dtype, s: int, hd: int) -> bool:
    """Whether ``attention_core_backward`` (Kernel B) takes a core of ``dtype``, ``s`` tokens and head dim ``hd``."""
    return dtype == torch.bfloat16 and hd == BWD_HEAD_DIM and s >= 1


def _flash_backward(args, grad, needs):
    q, k, v, scale = args
    return (*attention_core_backward(q, k, v, grad, scale), None)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """``softmax(q kᵀ · scale) v`` per head: (N, S, H, hd) in, (N, H, S, hd)
    out in ``q``'s dtype.  On the card the head dim must be one of
    ``HEAD_DIMS`` and the tensors contiguous.  The backward is
    ``attention_core_backward`` where ``core_backward_takes`` the call, else
    the twin's, recomputed."""
    _check(q, k, v)
    if core_backward_takes(q.dtype, q.shape[1], q.shape[3]):
        return _grad.explicit_backward(_kernel, _flash_backward, q, k, v, scale)
    return _grad.recompute_backward(_kernel, flash_mha_plain, q, k, v, scale, dtype=q.dtype)


_build.reset_count(flash_mha)


def _check_core_backward(q, k, v, do, out, o) -> None:
    _check(q, k, v)
    n, s, h, hd = q.shape
    if tuple(do.shape) != (n, h, s, hd) or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"expects do (N, H, S, hd) = {(n, h, s, hd)} of q's dtype, got {tuple(do.shape)} {do.dtype}")
    if out is not None and (len(out) != 3 or any(t.shape != q.shape or t.dtype != q.dtype for t in out)):
        raise ValueError("out must be three tensors shaped like q")
    if o is not None and (o.shape != q.shape or o.dtype != q.dtype):
        raise ValueError("o must be shaped like q")


def attention_core_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                                  scale: float) -> tuple:
    """Plain version of Kernel B: ``(dq, dk, dv)`` of ``flash_mha_plain(q, k,
    v, scale)`` given ``do`` (N, H, S, hd), in ``q``'s dtype and layout
    (N, S, H, hd): the twin's gradient written out, its products the twin's
    (in bfloat16 TF32 on the card, which rounds ``ds`` as the kernel does)."""
    _check_core_backward(q, k, v, do, None, None)
    dtype = q.dtype
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    with float32_products(dtype):
        p = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q32, k32) * scale, dim=-1)
        dv = torch.einsum("nhqk,nhqd->nkhd", p.to(dtype).float(), do32)
        dp = torch.einsum("nhqd,nkhd->nhqk", do32, v32).to(dtype).float()
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
        dq = torch.einsum("nhqk,nkhd->nqhd", ds, k32)
        dk = torch.einsum("nhqk,nqhd->nkhd", ds, q32)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def attention_core_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, scale: float,
                            out: Optional[tuple] = None, o: Optional[torch.Tensor] = None) -> tuple:
    """``(dq, dk, dv)`` of ``softmax(q kᵀ · scale) v`` given ``do``: Kernel B,
    two launches on the card (bfloat16, head dim 64, any S;
    ``q``, ``k``, ``v`` may be strided views sharing their strides, with the
    head dim contiguous), its plain version on CPU tensors.  ``out``: three
    tensors to write into, with ``q``'s strides (else new ones like ``q``);
    ``o``: a tensor shaped like ``q`` (N, S, H, hd) to write the output
    ``flash_mha_plain(q, k, v, scale)`` into, transposed, or None."""
    _check_core_backward(q, k, v, do, out, o)
    if not _build.on_card(q):
        grads = attention_core_backward_plain(q, k, v, do, scale)
        if o is not None:
            o.copy_(flash_mha_plain(q, k, v, scale).transpose(1, 2))
        if out is None:
            return grads
        for t, g in zip(out, grads):
            t.copy_(g)
        return tuple(out)
    n, s, h, hd = q.shape
    if not core_backward_takes(q.dtype, s, hd):
        raise ValueError(f"the kernel takes bfloat16 at head dim {BWD_HEAD_DIM}, got {q.dtype}, head dim {hd}")
    if do.stride(3) != 1:
        do = do.contiguous()
    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
        if q.stride() != out[0].stride():
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    strides = q.stride()
    if any(t.stride() != strides for t in (k, v, *out)) or strides[3] != 1:
        raise ValueError("q, k, v and out must share their strides, with the head dim contiguous")
    o_strides = (0, 0, 0) if o is None else o.stride()
    if o is not None and o_strides[3] != 1:
        raise ValueError("o must have its head dim contiguous")
    if (any(t.data_ptr() % 16 for t in (q, k, v, do, *out, *(() if o is None else (o,))))
            or any(x % 8 for x in (*strides[:3], *do.stride()[:3], *o_strides[:3]))):
        raise ValueError("the kernel copies 16 bytes at a time: bases 16-byte aligned, strides multiples of 8")
    lib = _lib()
    stats = torch.empty(lib.cvt_attention_core_backward_stats_floats(n, s, h), dtype=torch.float32, device=q.device)
    _build.launch(lib, "cvt_attention_core_backward", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), None if o is None else o.data_ptr(),
                  stats.data_ptr(), n, s, h, float(scale), strides[0], strides[1], strides[2], do.stride(0),
                  do.stride(2), do.stride(1), o_strides[0], o_strides[1], o_strides[2])
    _build.count_launch(attention_core_backward, q)
    attention_core_backward.kernel_launches += 2
    return tuple(out)


_build.reset_count(attention_core_backward)
attention_core_backward.kernel_launches = 0
