#!/usr/bin/env python3
"""Stage by stage, where the bf16 v2 ``window_attention_block`` parts from its twin on the inputs of
``tests/test_torch_cuda.py::test_bf16_v2_window_block_over_seeds``.

    python3 tools/torch_window_fault1.py [--draws 0-23] [--detail 6] [--json FILE]

The card only.  For each draw (the test's own inputs: (4096, 49, 128), ``ln_count`` 96, Swin-T's shift mask,
logit scales about e^2.3, the k bias zero) it runs the block's C entry with its scratch buffers in view, the
window core alone (``window_core`` of ``csrc/swin_attention.cu``, bound from a small source built beside it), and
the twin's stages (``swin_attention.window_attention_block_plain``, split up), and prints:

* ``qkv``: the float32 QKV rows of the kernel against the twin's (elements that differ, largest gap in float32
  steps, read as integers: a sign change near zero reads large), and apart the q and k columns (``qk_differ``);
* ``qhat``/``khat``: bf16 q/|q| and k/|k| taken by the twin's formula from the kernel's rows against the
  twin's (rounding flips), and from the twin's rows with the sum of squares of the bf16 core before its repair
  (its earlier order: a chain of fused multiply-adds over each half of the head, the halves added) against the
  twin's;
* ``rsqrt_equal``: whether the core's ``rsqrtf`` gives ``torch.rsqrt``'s bits on every sum of squares;
* ``probs``: the twin's bf16 probabilities from the kernel's rows against its own (flips);
* each part's share of the output error as the rule's ratio ``max |err| / (2e-2 (1 + |twin|))`` (1 breaks it):
  ``all`` the kernel; ``qkv_only`` the twin on the kernel's QKV rows; ``norm_only`` the twin with that earlier sum of
  squares; ``core_only`` the kernel's core on the twin's QKV rows, then the twin's tail; ``tail_only`` the
  twin's tail on the kernel's joined heads against the kernel's output;
* for ``--detail`` draws, the worst element: its window, token, channel, twin value, its branch row's standard
  deviation, and the heads of its window whose q/|q| or k/|k|, probabilities or joined heads differ.

The card's name and power limit lead the output.  Exits 1 without a card.
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

DEBUG_SRC = r"""
#include "swin_attention.cu"
extern "C" int dbg_window_core_bf16(const float* qkv, const float* rel_bias, const float* mask, const float* ls,
                                    void* joined, int nw, int s, int c, int heads, int nw_img, float scale, int v2,
                                    void* stream) {
  return (int)window_core(qkv, rel_bias, mask, ls, (bf16*)joined, nw, s, c, heads, nw_img, scale, v2,
                          (cudaStream_t)stream);
}
__global__ void dbg_rsqrt_kernel(const float* x, float* y, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = rsqrtf(fmaxf(x[i], 1e-12f));
}
extern "C" int dbg_rsqrt(const float* x, float* y, long n, void* stream) {
  dbg_rsqrt_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}
"""


def _debug_lib():
    from cpu_vision_tpu_torch.ops.kernels import _build
    out = _build._build_dir()
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "window_fault1_dbg.cu", out / "libwindow_fault1_dbg.so"
    src.write_text(DEBUG_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(lib), str(src)],
                   check=True)
    dl = ctypes.CDLL(str(lib))
    p, i, f, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
    dl.dbg_window_core_bf16.argtypes = [p] * 5 + [i] * 5 + [f, i, p]
    dl.dbg_rsqrt.argtypes = [p, p, l, p]
    return dl


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", default="0-23")
    ap.add_argument("--detail", default="6")
    ap.add_argument("--json", default=None)
    a = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from cpu_vision_tpu_torch import models
    from cpu_vision_tpu_torch.ops.kernels import swin_attention
    from cpu_vision_tpu_torch.ops.kernels.transformer_block import _ln_f32
    from test_torch_cuda import TOL, _normal, _window_args

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    lo, hi = (int(v) for v in a.draws.split("-")) if "-" in a.draws else (int(a.draws),) * 2
    detail = {int(v) for v in a.detail.split(",") if v}
    dev = torch.device("cuda", 0)
    dl = _debug_lib()
    lib = swin_attention._lib()
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    nw, s, c, nw_img, ln_count, bf16 = 4096, 49, 128, 64, 96, torch.bfloat16
    heads, hd = c // 32, 32
    mask = models.swin._shift_mask(56, 56, 7, 3, 3).to(dev)
    tol = TOL[bf16]
    rows = []

    def ratio(out, ref):
        err = (out.float() - ref.float()).abs()
        return float((err / (tol * (1 + ref.float().abs()))).max())

    def f32_steps(u, v):
        iu, iv = u.view(torch.int32).long(), v.view(torch.int32).long()
        return int((iu - iv).abs().max())

    for seed in range(lo, hi + 1):
        rng = np.random.default_rng(seed)
        args = _window_args(rng, nw, s, c, True, True, nw_img, bf16, dev, ln_count)
        args[8] = mask
        args[9] = _normal(rng, (heads,), torch.float32, dev, 0.5, 2.3)
        args[4][c:2 * c] = 0
        x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, _, ls = args[:10]
        scale, eps = args[11], args[12]
        tokens = nw * s

        # the kernel with its scratch in view
        qkv_k = torch.empty((tokens, 3 * c), dtype=torch.float32, device=dev)
        joined_k = torch.empty_like(x)
        branch_k = torch.empty((tokens, c), dtype=torch.float32, device=dev)
        out_k = torch.empty_like(x)
        err = lib.cvt_window_attention_block(
            x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), w_o.data_ptr(),
            b_o.data_ptr(), rel_bias.data_ptr(), mask.data_ptr(), ls.data_ptr(), qkv_k.data_ptr(),
            joined_k.data_ptr(), branch_k.data_ptr(), None, out_k.data_ptr(), nw, s, c, heads, nw_img,
            float(scale), float(eps), 1, ln_count, 1, stream())
        assert err == 0, err
        out_w = swin_attention.window_attention_block(*args)  # the wrapper, as the test calls it
        twin = swin_attention.window_attention_block_plain(*args)

        # the twin's stages
        def twin_qkv():
            return swin_attention._qkv_rows(x, w_qkv, b_qkv, True)

        def sumsq_chain(t):  # (..., 32): the earlier order, a fused chain over each half, then the halves added
            halves = []
            for h0 in (0, 16):
                acc = torch.zeros(t.shape[:-1], dtype=torch.float32, device=dev)
                for i in range(h0, h0 + 16):
                    acc = (t[..., i].double() ** 2 + acc.double()).float()
                halves.append(acc)
            return halves[0] + halves[1]

        def sumsq_twin(t):
            return swin_attention._sum_of_squares(t)[..., 0]

        def hats(qkv, sumsq=sumsq_twin):
            q, k, v = (r.reshape(nw, s, heads, hd) for r in qkv.split(c, dim=-1))
            sq, sk = sumsq(q), sumsq(k)
            qh = (q * torch.rsqrt(sq.clamp_min(1e-12))[..., None]).to(bf16)
            kh = (k * torch.rsqrt(sk.clamp_min(1e-12))[..., None]).to(bf16)
            return qh, kh, v.to(bf16), sq, sk

        def core(qh, kh, v):
            sc = torch.einsum("bnhd,bmhd->bhnm", qh.float(), kh.float())
            sc = sc * torch.exp(ls.reshape(1, heads, 1, 1).clamp_max(math.log(100.0)))
            sc = sc + rel_bias[None]
            sc = (sc.reshape(nw // nw_img, nw_img, heads, s, s) + mask[None, :, None]).reshape(nw, heads, s, s)
            p = torch.softmax(sc, dim=-1).to(bf16)
            o = torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).reshape(nw, s, c).to(bf16)
            return p, o

        def tail(joined):
            br = joined.reshape(tokens, c).float() @ w_o.float() + b_o
            o = _ln_f32(br, ln_g, ln_b, eps, ln_count)
            return br, (x.float() + o.reshape(nw, s, c)).to(bf16)

        with torch.no_grad():
            qkv_t = twin_qkv().reshape(tokens, 3 * c)
            qh_t, kh_t, v_t, sq_t, sk_t = hats(qkv_t)
            p_t, joined_t = core(qh_t, kh_t, v_t)
            br_t, out_t = tail(joined_t)
            assert torch.equal(out_t, twin), "the split twin is not the twin"
            qh_q, kh_q, v_q, _, _ = hats(qkv_k)                       # the kernel's rows, the twin's norm
            p_q, joined_q = core(qh_q, kh_q, v_q)
            _, out_q = tail(joined_q)
            qh_n, kh_n, _, sq_n, sk_n = hats(qkv_t, sumsq_chain)  # the twin's rows, the earlier norm
            p_n, joined_n = core(qh_n, kh_n, v_t)
            _, out_n = tail(joined_n)
            joined_c = torch.empty_like(x)                           # the kernel's core on the twin's rows
            assert dl.dbg_window_core_bf16(qkv_t.data_ptr(), rel_bias.data_ptr(), mask.data_ptr(), ls.data_ptr(),
                                           joined_c.data_ptr(), nw, s, c, heads, nw_img, float(scale), 1,
                                           stream()) == 0
            _, out_c = tail(joined_c)
            _, out_tk = tail(joined_k)
            sums = torch.cat([sq_t.reshape(-1), sk_t.reshape(-1), sq_n.reshape(-1), sk_n.reshape(-1)])
            rs = torch.empty_like(sums)
            assert dl.dbg_rsqrt(sums.data_ptr(), rs.data_ptr(), sums.numel(), stream()) == 0
            rsqrt_equal = bool(torch.equal(rs, torch.rsqrt(sums.clamp_min(1e-12))))
            torch.cuda.synchronize()

        row = {
            "draw": seed,
            "qkv_differ": int((qkv_k != qkv_t).sum()), "qkv_max_f32_steps": f32_steps(qkv_k, qkv_t),
            "qk_differ": int((qkv_k[:, :2 * c] != qkv_t[:, :2 * c]).sum()),
            "qhat_flips_from_qkv": int((qh_q != qh_t).sum()), "khat_flips_from_qkv": int((kh_q != kh_t).sum()),
            "qhat_flips_from_norm": int((qh_n != qh_t).sum()), "khat_flips_from_norm": int((kh_n != kh_t).sum()),
            "sumsq_differ_norm_order": int((sq_n != sq_t).sum() + (sk_n != sk_t).sum()),
            "rsqrt_equal": rsqrt_equal,
            "probs_flips_from_qkv": int((p_q != p_t).sum()),
            "joined_differ": int((joined_k != joined_t).sum()),
            "joined_differ_core_only": int((joined_c != joined_t).sum()),
            "ratio": {"all": ratio(out_k, twin), "wrapper": ratio(out_w, twin), "qkv_only": ratio(out_q, twin),
                      "norm_only": ratio(out_n, twin), "core_only": ratio(out_c, twin),
                      "tail_only": ratio(out_k, out_tk)},
            "max_err": float((out_w.float() - twin.float()).abs().max()),
        }
        if seed in detail:
            e = (out_w.float() - twin.float()).abs() / (tol * (1 + twin.float().abs()))
            idx = int(e.argmax())
            wi, ti, ci = idx // (s * c), (idx // c) % s, idx % c
            tok = wi * s + ti
            brow = br_t[tok, :ln_count]
            row["worst"] = {
                "window": wi, "token": ti, "channel": ci, "twin": float(twin.float().reshape(-1)[idx]),
                "kernel": float(out_w.float().reshape(-1)[idx]), "err": float((out_w.float() - twin.float())
                                                                               .reshape(-1)[idx].abs()),
                "branch_row_std": float(brow.std(unbiased=False)), "branch_row_mean": float(brow.mean()),
                "ln_gain": float(ln_g[ci]),
                "logit_scale_exp": [float(v) for v in torch.exp(ls.clamp_max(math.log(100.0)))],
                "heads_qhat_flip_from_qkv": [h for h in range(heads) if bool((qh_q[wi, :, h] != qh_t[wi, :, h]).any())],
                "heads_khat_flip_from_qkv": [h for h in range(heads) if bool((kh_q[wi, :, h] != kh_t[wi, :, h]).any())],
                "heads_probs_flip_from_qkv_at_token": [h for h in range(heads)
                                                       if bool((p_q[wi, h, ti] != p_t[wi, h, ti]).any())],
                "heads_joined_differ_at_token": [h for h in range(heads)
                                                 if bool((joined_k[wi, ti, 32 * h:32 * h + 32]
                                                          != joined_t[wi, ti, 32 * h:32 * h + 32]).any())],
                "joined_max_gap_at_token": float((joined_k[wi, ti].float() - joined_t[wi, ti].float()).abs().max()),
                "branch_gap_at_token": float((branch_k[tok, :ln_count] - br_t[tok, :ln_count]).abs().max()),
                "probs_max_gap_from_qkv_at_token": float((p_q[wi, :, ti].float() - p_t[wi, :, ti].float())
                                                         .abs().max()),
            }
        print(json.dumps(row), flush=True)
        rows.append(row)
        del args, qkv_k, joined_k, branch_k, out_k, out_w, twin
        torch.cuda.empty_cache()

    summary = {k: max(r["ratio"][k] for r in rows) for k in rows[0]["ratio"]}
    failing = [r["draw"] for r in rows if r["ratio"]["wrapper"] > 1]
    print(json.dumps({"card": smi, "max_ratio": summary, "draws_past_the_rule": failing}), flush=True)
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        Path(a.json).write_text(json.dumps({"card": smi, "draws": rows, "max_ratio": summary,
                                            "draws_past_the_rule": failing}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
