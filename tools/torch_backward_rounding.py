#!/usr/bin/env python3
"""Why the bf16 blocks' backward rounds where it does: variants of it against
the twin's gradients, on the card.

Run from the repository root on a machine with an NVIDIA card:

    python3 tools/torch_backward_rounding.py

At the shapes and seeds of ``tests/test_torch_cuda.py::
test_kernel_routes_give_the_plain_routes_gradients`` (ViT-B/16's width:
``flash_mha`` at (2, 197, 12, 64), ``attention_block`` at (2, 197, 768),
``mlp_block`` at (394, 768, 3072), bfloat16), it computes the twin's
gradients as that test holds the kernel routes to them (``float32_products``:
the twin's float32 cotangents rounded to TF32 by its products) and prints, for
each variant of the backward written out in plain operators, every
gradient's ``max |a - twin| / (1 + |twin|)`` (the test allows 1e-2) and its
distance from the float32 function's gradient over the twin's (the test
allows 1.5):

* ``du``/``ds`` (the MLP's gelu gradient, the core's score gradient, float32
  in the twin) rounded to bfloat16; kept to 16 bits as two bfloat16 halves;
  rounded to TF32 to nearest (``cvt.rna``, the port's choice) or toward zero,
  then taken as two exact bfloat16 halves; each product in full float32;
* the recompute and the MLP's ``g·w2ᵀ`` on the port's own tensor-core product
  (``kernels.bf16_product``, float32 out) instead of the twin's cuBLAS call,
  and the joined heads from the forward core (``kernels.flash_mha``) instead
  of the twin's rounding.

Without a card it exits 1.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BF = torch.bfloat16


def tf32(x: torch.Tensor, nearest: bool) -> torch.Tensor:
    """``x`` with its 13 low mantissa bits dropped, after rounding to nearest (ties away) where ``nearest``."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000 if nearest else u) & -0x2000).view(torch.float32)


def halves(t: torch.Tensor):
    hi = t.to(BF)
    return hi, (t - hi.float()).to(BF)


# a variant of du / ds: the operand(s) its products take, all exact in float32
ROUNDINGS = {
    "bf16": lambda x: (x.to(BF),),
    "hi+lo 16 bits": lambda x: halves(x),
    "tf32 nearest (port)": lambda x: halves(tf32(x, True)),
    "tf32 toward zero": lambda x: halves(tf32(x, False)),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_backward_rounding: no CUDA card", file=sys.stderr)
        return 1
    from cpu_vision_tpu_torch import _dtype
    from cpu_vision_tpu_torch.ops import kernels
    from cpu_vision_tpu_torch.ops.kernels import flash_attention as fa
    from cpu_vision_tpu_torch.ops.kernels import transformer_block as tb

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, dt=torch.float32, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dt)

    def cotangent(shape, dt):
        return torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev).to(dt)

    def grads(fn, args):
        args = [a.detach().requires_grad_(a.dtype.is_floating_point) for a in args]
        out = fn(*args)
        out.backward(cotangent(out.shape, out.dtype))
        return [a.grad for a in args]

    def mm(a, b):
        with _dtype.full_float32():
            return a.float() @ b.float()

    def mm_parts(parts, b, left=True):  # the sum of the products of each part, in float32
        out = None
        for p in parts:
            y = mm(p, b) if left else mm(b, p)
            out = y if out is None else out + y
        return out

    def core_backward(q, k, v, do, scale, rnd):
        q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
        with _dtype.full_float32():
            p = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q32, k32) * scale, dim=-1)
            dv = torch.einsum("nhqk,nhqd->nkhd", p.to(BF).float(), do32)
            dp = torch.einsum("nhqd,nkhd->nhqk", do32, v32).to(BF).float()
            parts = rnd(p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale)
            dq = sum(torch.einsum("nhqk,nkhd->nqhd", x.float(), k32) for x in parts)
            dk = sum(torch.einsum("nhqk,nqhd->nkhd", x.float(), q32) for x in parts)
        return dq.to(BF), dk.to(BF), dv.to(BF)

    def product(a, w, kernel):  # a·w in float32 (bf16 operands): the twin's cuBLAS call, or the port's product
        if kernel:
            return kernels.bf16_product(a.contiguous(), w.contiguous(), torch.zeros(w.shape[1], device=dev),
                                        out_dtype=torch.float32)
        with _dtype.float32_products(BF):
            return tb._dot_f32(a, w)

    def mlp(x, ln_g, ln_b, w1, b1, w2, b2, g, rnd, kernel_u=False, kernel_da=False):
        h = tb._ln_f32(x.float(), ln_g, ln_b, 1e-6).to(BF)
        u = product(h, w1, kernel_u) + b1
        a = tb._gelu_f32(u).to(BF)
        da = product(g, w2.t(), kernel_da).to(BF).float()
        parts = rnd(da * tb._gelu_grad_f32(u))
        dh = mm_parts(parts, w1.t()).to(BF)
        dx, dg, db = tb.ln_backward_plain(x, ln_g, dh, g, 1e-6)
        db1 = sum(p.float() for p in parts).sum(0)
        return [dx, dg, db, mm_parts(parts, h.t(), left=False).to(BF), db1, mm(a.t(), g).to(BF),
                g.float().sum(0)]

    def attention(x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, g, rnd, kernel_qkv=False, kernel_joined=False, heads=12,
                  scale=0.125):
        n, s, d = x.shape
        hd = d // heads
        h = tb._ln_f32(x.float(), ln_g, ln_b, 1e-6).to(BF).reshape(n * s, d)
        qkv = (product(h, w_qkv, kernel_qkv) + b_qkv).to(BF)
        q, k, v = (t.reshape(n, s, heads, hd) for t in qkv.split(d, -1))
        if kernel_joined:
            joined = kernels.flash_mha(*(t.contiguous() for t in (q, k, v)), scale)
        else:
            joined = fa.flash_mha_plain(q, k, v, scale)
        joined = joined.transpose(1, 2).reshape(n * s, d)
        g2 = g.reshape(n * s, d)
        dj = mm(g2, w_o.t()).to(BF)
        dq, dk, dv = core_backward(q, k, v, dj.reshape(n, s, heads, hd).transpose(1, 2), scale, rnd)
        dqkv = torch.cat([t.reshape(n * s, d) for t in (dq, dk, dv)], -1)
        dh = mm(dqkv, w_qkv.t()).to(BF)
        dx, dg, db = tb.ln_backward_plain(x.reshape(n * s, d), ln_g, dh, g2, 1e-6)
        return [dx.reshape(n, s, d), dg, db, mm(h.t(), dqkv).to(BF), dqkv.float().sum(0), mm(joined.t(), g2).to(BF),
                g2.float().sum(0)]

    def report(name, chain, twin, args, variants):
        with _dtype.float32_products(BF):
            ref = grads(twin, args)
        with _dtype.full_float32():
            full = grads(twin, args)
            truth = grads(twin, [a.float() for a in args])
        out = twin(*[a.detach() for a in args])
        g = cotangent(out.shape, out.dtype)
        rows = [("twin, float32 products", full)] + [(label, chain(*args, g=g, **kw)) for label, kw in variants]
        print(f"{name}: per gradient, max |a - twin| / (1 + |twin|) (the card test allows 1e-2) | distance from the "
              f"float32 function's over the twin's (allows 1.5)")
        for label, got in rows:
            errs = [float(((a.float() - r.float()).abs() / (1 + r.float().abs())).max()) for a, r in zip(got, ref)]
            ratios = [float((a.double() - t.double()).norm()) / max(float((f.double() - t.double()).norm()), 1e-30)
                      for a, f, t in zip(got, full, truth)]
            print(f"  {label:44s} " + " ".join(f"{e:.4f}" for e in errs) + f"  max {max(errs):.4f}"
                  + f" {'meets' if max(errs) <= 1e-2 else 'FAILS'} | " + " ".join(f"{r:.3f}" for r in ratios))

    rounding_variants = [(label, dict(rnd=rnd)) for label, rnd in ROUNDINGS.items()]
    port = ROUNDINGS["tf32 nearest (port)"]
    q, k, v = (normal((2, 197, 12, 64), BF) for _ in range(3))
    report("flash_mha (2, 197, 12, 64)", lambda *a, g, rnd: list(core_backward(*a, g, 0.125, rnd)),
           lambda *a: fa.flash_mha_plain(*a, 0.125), [q, k, v], rounding_variants)
    d = 768
    attn = [normal((2, 197, d), BF), normal(d, std=0.2, mean=1.0), normal(d, std=0.1), normal((d, 3 * d), BF, d ** -0.5),
            normal(3 * d, std=0.1), normal((d, d), BF, d ** -0.5), normal(d, std=0.1)]
    report("attention_block (2, 197, 768)", attention, lambda *a: tb.attention_block_plain(*a, 12, 0.125), attn,
           rounding_variants + [("tf32 nearest, qkv on the port's product", dict(rnd=port, kernel_qkv=True)),
                                ("tf32 nearest, joined heads of the forward core", dict(rnd=port, kernel_joined=True))])
    mlp_args = [normal((394, d), BF), normal(d, std=0.2, mean=1.0), normal(d, std=0.1), normal((d, 3072), BF, d ** -0.5),
                normal(3072, std=0.1), normal((3072, d), BF, 3072 ** -0.5), normal(d, std=0.1)]
    report("mlp_block (394, 768, 3072)", mlp, tb.mlp_block_plain, mlp_args,
           rounding_variants + [("tf32 nearest, u on the port's product", dict(rnd=port, kernel_u=True)),
                                ("tf32 nearest, g·w2ᵀ on the port's product", dict(rnd=port, kernel_da=True))])
    print(f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
