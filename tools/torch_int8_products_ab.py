#!/usr/bin/env python3
"""Time ``int8_matmul_requant`` (``csrc/int8_matmul.cu``) and ``attention_block_int8``
(``csrc/int8_transformer.cu``) against an older tree's sources of them and against
PyTorch, in turns on one card, and check the bits.

    python3 tools/torch_int8_products_ab.py --old-tree DIR [--cases matmul attention mlp] [--rounds N] [--json PATH]

``--old-tree`` is the root of an older checkout (a ``git archive`` of its
``cpu_vision_tpu_torch`` unpacked under ``build/``): its ``int8_matmul.cu`` and
``int8_transformer.cu`` are built with its own headers, ``--fmad=false`` and
``-Xptxas -v``.  The C interfaces of its ``cvt_int8_matmul_requant`` and
``cvt_mlp_block_int8`` must be this tree's (as at commit 7797ae0), and its
``cvt_attention_block_int8`` this tree's or the three-launch one without the
int8 LayerNorm scratch, as at commit 7797ae0 (told apart by its source).

``matmul``: the int8 ResNet-50 b256 path (``models.Int8ResNet`` over
``resnet50``, weights from seed 0, batch norms perturbed from seed 1,
calibrated on 32 images, as ``chip_smoke.py``) is run once with
``int8_matmul.recording()``; every one of its 36 launches must equal its twin
and the older kernel bit for bit.  At each distinct (M, K, N) the kernel and
the older one (each called through its C entry on the path's own tensors) and
the stock composite (``torch._int_mm`` on the weight laid out for cuBLASLt,
then the epilogue) are timed on the device clock (CUDA events) in
``--rounds`` rounds, the order reversed every other round; the least of the
rounds, times the launches at that shape, is summed over the forward.

``attention``: ``attention_block_int8`` at ViT-B/16 b256's (256, 197, 768)
bfloat16 and at every shape of ``tests/test_torch_cuda.py::
test_attention_block_int8_matches_twin`` in bfloat16 and float32: the output
must equal the older kernels' bit for bit and the twin's within the card
test's rule (``max |a - b| / (1 + |b|) <= 2e-2``), two calls must give the
same bits, and a call must be four kernel launches.  At ViT-B/16's shape the
kernels and the older ones (C entries) and the stock composite (``layer_norm``,
quantise, ``torch._int_mm``, SDPA, quantise, ``torch._int_mm``, epilogue) are
timed in turns, and each launch of a call apart (``torch.profiler``).

``mlp``: ``mlp_block_int8`` at ViT-B/16 b256's (50,432, 768, 3072) bfloat16,
the same product behind its two projections: the bits of the older tree, the
twin's rule, both kernels timed in turns, launches apart.

Prints the card's name and power limit, the int8 products' registers and
spills, their SASS opcodes (``IGMMA`` must be there, ``IDP4A`` and
``i8_gemm_kernel`` not, in both libraries), one line a case and a JSON line of
every figure (also written to ``--json``).  Exits 1 if a check fails.  No test
imports it.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from cpu_vision_tpu_torch import models  # noqa: E402
from cpu_vision_tpu_torch.ops import kernels  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import _build, int8_matmul, int8_transformer  # noqa: E402

ATTN_CASES = [(256, 197, 768, 12, torch.bfloat16)] + [
    (n, s, d, h, dtype) for dtype in (torch.bfloat16, torch.float32)
    for n, s, d, h in ((4, 197, 768, 12), (2, 257, 1280, 16), (3, 50, 1024, 16), (2, 33, 256, 4), (1, 5, 64, 4))]
STEMS = ("int8_matmul", "int8_transformer")
CASES = ("matmul", "attention", "mlp")
INT8_OPS_PER_S, BF16_OPS_PER_S, HBM_BYTES_PER_S = 1979e12, 989e12, 3.35e12
P, I, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ptxas_lines(label: str, log: str) -> list:
    """Print the registers and spills of the int8 products; the faults, listed (a spill, a serialised wgmma)."""
    fn, faults = "", []
    for line in log.splitlines():
        named = re.search(r"Compiling entry function '(\S+)'", line)
        fn = named.group(1) if named else fn
        if "gemm_kernel" not in fn:
            continue
        if "Used" in line or "spill" in line:
            print(f"  {label}: {fn}: {line.strip()}")
        if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
            faults.append(f"{label}: {fn} spills: {line.strip()}")
        if "serialized" in line:
            print(f"  {label}: {line.strip()}")
            faults.append(f"{label}: {line.strip()}")
    return faults


def build_old(tree: Path) -> dict:
    csrc = tree / "cpu_vision_tpu_torch" / "csrc"
    out = REPO / "build" / "int8_products_ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem in STEMS:
        lib = out / f"lib{stem}_old.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "--fmad=false", "-Xptxas", "-v", "-I", str(csrc), "-o", str(lib),
               str(csrc / f"{stem}.cu")]
        jobs[stem] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stem, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        ptxas_lines("older", log)  # printed, not held: the older build's own
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the older {stem}.cu:\n{log}")
        libs[stem] = ctypes.CDLL(str(lib))
    libs["int8_matmul"].cvt_int8_matmul_requant.argtypes = [P] * 6 + [I, I, I, I, P]
    libs["int8_transformer"].cvt_mlp_block_int8.argtypes = [P] * 14 + [I, I, I, FL, I, P]
    libs["ln_scratch"] = "void* q1, void* qkv" in (csrc / "int8_transformer.cu").read_text()
    libs["int8_transformer"].cvt_attention_block_int8.argtypes = ([P] * (15 if libs["ln_scratch"] else 14)
                                                                  + [I, I, I, I, FL, FL, I, P])
    return libs


def device_ms(fn, calls: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def in_turns(fns: dict, rounds: int, calls: int) -> dict:
    """{name: [ms of each round]}, the order of ``fns`` reversed every other round."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(device_ms(fns[name], calls))
    return times


def launches_apart(fn, calls: int = 5) -> list:
    """[(kernel, device ms a call)] of the ``cvt::`` and anonymous-namespace kernels of ``fn`` (not the wrapper's
    stock set-up), in launch order, from ``torch.profiler`` over ``calls`` calls after one that warms up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and ("cvt::" in e.name or "anonymous" in e.name))
    chain = len(spans) // calls
    return [(spans[i][2][:90],
             sum(spans[c * chain + i][1] - spans[c * chain + i][0] for c in range(calls)) / calls / 1e3)
            for i in range(chain)]


def check(result: dict, faults: list, what: str) -> None:
    faults += [f"{what}: {k}" for k, ok in result.items() if not ok]


def r50_calls(dev) -> list:
    """The 36 launches of one int8 ResNet-50 b256 forward: (qx, qw, scale, bias, out_scale, relu, out)."""
    images = torch.from_numpy(np.random.default_rng(0).random((256, 224, 224, 3), dtype=np.float32)).to(dev)
    r50 = models.get_model("resnet50", generator=torch.Generator().manual_seed(0))
    bn_gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():  # else each block's last batch-norm scale is 0 and its residual branch vanishes
        for m_ in r50.modules():
            if isinstance(m_, torch.nn.BatchNorm2d):
                m_.weight.uniform_(0.5, 1.5, generator=bn_gen)
                m_.bias.uniform_(-0.1, 0.1, generator=bn_gen)
                m_.running_mean.uniform_(-0.3, 0.3, generator=bn_gen)
                m_.running_var.uniform_(0.5, 1.5, generator=bn_gen)
    eng = models.Int8ResNet.from_model(r50).calibrate([images[:32]])
    with int8_matmul.recording() as calls:
        eng(images)
    torch.cuda.synchronize()
    return calls


def matmul_cases(old, rounds: int, faults: list) -> list:
    dev = torch.device("cuda", 0)
    new_lib, old_lib = int8_matmul._lib(), old["int8_matmul"]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    calls = r50_calls(dev)
    if len(calls) != 36:
        faults.append(f"matmul: the ResNet-50 path launched {len(calls)} products, not 36")

    def c_call(lib, qx, qwt, sc, b, inv, out, relu):
        m, k = qx.shape
        err = lib.cvt_int8_matmul_requant(qx.data_ptr(), qwt.data_ptr(), sc.data_ptr(), b.data_ptr(),
                                          None if inv is None else inv.data_ptr(), out.data_ptr(), m, k,
                                          out.shape[1], int(relu), stream())
        if err != 0:
            raise RuntimeError(f"cvt_int8_matmul_requant: CUDA error {err}")
        return out

    shapes = {}
    for qx, qw, sc, b, os_, relu, out in calls:
        inv = None if os_ is None else int8_matmul._inverse(os_, dev)
        qwt = qw.t().contiguous()
        older = c_call(old_lib, qx, qwt, sc, b, inv, torch.empty_like(out), relu)
        key = (qx.shape[0], qx.shape[1], qw.shape[1])
        ok = {"twin": torch.equal(out, int8_matmul.int8_matmul_requant_plain(qx, qw, sc, b, os_, relu)),
              "bits_of_older": torch.equal(out, older)}
        check(ok, faults, f"int8_matmul_requant {key}")
        entry = shapes.setdefault(key, {"launches": 0, "args": (qx, qw, qwt, sc, b, os_, inv, relu, out), "ok": {}})
        entry["launches"] += 1
        entry["ok"] = {k: entry["ok"].get(k, True) and v for k, v in ok.items()}
    del calls

    rows = []
    for (m, k, n), entry in shapes.items():
        qx, qw, qwt, sc, b, os_, inv, relu, out = entry["args"]
        new_out, old_out = torch.empty_like(out), torch.empty_like(out)
        qw_cm = qw.t().contiguous().t()

        def composite():
            f = torch._int_mm(qx, qw_cm).float() * sc + b
            f = torch.relu(f) if relu else f
            return f if inv is None else int8_matmul.quantize_i8(f, inv)

        fns = {"ms": lambda: c_call(new_lib, qx, qwt, sc, b, inv, new_out, relu),
               "older_ms": lambda: c_call(old_lib, qx, qwt, sc, b, inv, old_out, relu), "library_ms": composite}
        reps = max(10, min(200, int(4e10 / (m * k * n))))
        times = in_turns(fns, rounds, reps)
        bound = max((m * k + k * n + m * n) / HBM_BYTES_PER_S, 2 * m * k * n / INT8_OPS_PER_S) * 1e3
        row = dict(case=f"int8_matmul_requant ({m}, {k}, {n})", shape=[m, k, n], launches=entry["launches"],
                   relu=relu, **{key: min(v) for key, v in times.items()}, rounds=times, calls_a_round=reps,
                   bound_ms=bound, bound_by="bytes" if (m * k + k * n + m * n) / HBM_BYTES_PER_S
                   >= 2 * m * k * n / INT8_OPS_PER_S else "operations", checks=entry["ok"])
        rows.append(row)
        print(f"{row['case']} x{row['launches']}: kernel {row['ms']:.4f} ms, older {row['older_ms']:.4f}, composite "
              f"{row['library_ms']:.4f}, bound {bound:.4f} ({row['bound_by']}) (least of {rounds} rounds of {reps}); "
              f"{entry['ok']}")
    total = {key: sum(r[key] * r["launches"] for r in rows) for key in ("ms", "older_ms", "library_ms", "bound_ms")}
    print(f"int8_matmul_requant over one int8 ResNet-50 b256 forward ({sum(r['launches'] for r in rows)} launches, "
          f"{len(rows)} shapes), ms: {total}")
    rows.append(dict(case="int8_matmul_requant, one int8 ResNet-50 b256 forward", shapes=len(rows),
                     launches=sum(r["launches"] for r in rows), **total))
    return rows


def attn_args(gen, n, s, d, heads, dtype, dev):
    """``tests/test_torch_cuda.py::_int8_attn_args``'s distributions, drawn on the card."""
    def u(k, lo, hi):
        return torch.rand(k, generator=gen, device=dev) * (hi - lo) + lo

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = nrm(n, s, d).to(dtype)
    g, b = u(d, 0.5, 1.5), nrm(d) * 0.1
    a1, ao = u(d, 0.02, 0.05), u(d, 0.01, 0.03)
    qwqkv, sqkv = int8_transformer.quantize_weight(nrm(d, 3 * d) * d ** -0.5 * a1[:, None])
    qwo, so = int8_transformer.quantize_weight(nrm(d, d) * d ** -0.5 * ao[:, None])
    return x, g, b, qwqkv, sqkv, nrm(3 * d) * 0.1, qwo, so, nrm(d) * 0.1, a1, ao, heads, (d // heads) ** -0.5


def attention_cases(old, rounds: int, faults: list) -> list:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    new_lib, old_lib = int8_transformer._lib(), old["int8_transformer"]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows = []
    for n, s, d, heads, dtype in ATTN_CASES:
        a = attn_args(gen, n, s, d, heads, dtype, dev)
        x, g, b, qwqkv, sqkv, bqkv, qwo, so, bo, a1, ao, _, scale = a
        wqkv_t, wo_t = qwqkv.t().contiguous(), qwo.t().contiguous()
        inv1, inv_o = (1.0 / a1).contiguous(), (1.0 / ao).contiguous()
        m = n * s
        q1 = torch.empty((m, d), dtype=torch.int8, device=dev)
        qkv = torch.empty((m, 3 * d), dtype=dtype, device=dev)
        joined = torch.empty((m, d), dtype=torch.int8, device=dev)
        new_out, old_out = torch.empty_like(x), torch.empty_like(x)
        head = (x.data_ptr(), g.data_ptr(), b.data_ptr(), wqkv_t.data_ptr(), sqkv.data_ptr(), bqkv.data_ptr(),
                wo_t.data_ptr(), so.data_ptr(), bo.data_ptr(), inv1.data_ptr(), inv_o.data_ptr())
        tail = (n, s, d, heads, scale, 1e-6, int(dtype == torch.bfloat16))

        def new_call():
            err = new_lib.cvt_attention_block_int8(*head, q1.data_ptr(), qkv.data_ptr(), joined.data_ptr(),
                                                   new_out.data_ptr(), *tail, stream())
            if err != 0:
                raise RuntimeError(f"attention_block_int8: CUDA error {err}")
            return new_out

        def old_call():
            scratch = (q1.data_ptr(),) if old["ln_scratch"] else ()
            err = old_lib.cvt_attention_block_int8(*head, *scratch, qkv.data_ptr(), joined.data_ptr(),
                                                   old_out.data_ptr(), *tail, stream())
            if err != 0:
                raise RuntimeError(f"older attention_block_int8: CUDA error {err}")
            return old_out

        wqkv_c, wo_c = qwqkv.t().contiguous().t(), qwo.t().contiguous().t()

        def composite():
            h = F.layer_norm(x.float(), (d,), g, b, 1e-6).reshape(-1, d)
            qkv_ = (torch._int_mm(int8_matmul.quantize_i8(h, inv1), wqkv_c).float() * sqkv + bqkv).to(dtype)
            q_, k_, v_ = (t.reshape(n, s, heads, d // heads).transpose(1, 2) for t in qkv_.split(d, dim=-1))
            o = F.scaled_dot_product_attention(q_, k_, v_, scale=scale).transpose(1, 2).reshape(-1, d)
            proj = torch._int_mm(int8_matmul.quantize_i8(o.float(), inv_o), wo_c)
            return ((x.float().reshape(-1, d) + proj.float() * so) + bo).to(dtype).reshape(n, s, d)

        kernels.reset_launch_counts()
        out = kernels.attention_block_int8(*a)
        launches = (kernels.attention_block_int8.launches, kernels.attention_block_int8.kernel_launches)
        want = int8_transformer.attention_block_int8_plain(*a)
        err = float(((out.float() - want.float()).abs() / (1 + want.float().abs())).max())
        ok = {"bits_of_older": torch.equal(out, old_call()),
              "same_bits_twice": torch.equal(out, kernels.attention_block_int8(*a)),
              "twin": err <= 2e-2, "four_kernels_a_call": launches == (1, 4),
              "kernels_alone_same_bits": torch.equal(out, new_call())}
        what = f"attention_block_int8 ({n}, {s}, {d}) {heads} heads {str(dtype).replace('torch.', '')}"
        check(ok, faults, what)
        row = dict(case=what, scaled_err=err, checks=ok)
        if (n, s, d, dtype) == ATTN_CASES[0][:3] + (ATTN_CASES[0][4],):
            fns = {"ms": new_call, "older_ms": old_call, "library_ms": composite}
            times = in_turns(fns, rounds, 10)
            core_ops = n * heads * s * s * (4 * (d // heads) + 5)
            row.update({k: min(v) for k, v in times.items()}, rounds=times, calls_a_round=10,
                       bound_ms=max((2 * x.numel() * x.element_size() + 4 * d * d) / HBM_BYTES_PER_S,
                                    8 * m * d * d / INT8_OPS_PER_S + core_ops / BF16_OPS_PER_S) * 1e3,
                       split_bytes_ms=(m * d + m * 3 * d * x.element_size() * 2 + m * d * 2) / HBM_BYTES_PER_S * 1e3,
                       launch_ms=launches_apart(new_call), older_launch_ms=launches_apart(old_call))
            print(f"{what}: kernels {row['ms']:.4f} ms, older {row['older_ms']:.4f}, composite "
                  f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} (least of {rounds} rounds of 10); launches "
                  f"apart {row['launch_ms']}; older {row['older_launch_ms']}")
        print(f"{what}: scaled err {err:.3e}; {ok}")
        rows.append(row)
        del a, x, out, want, q1, qkv, joined, new_out, old_out
    return rows


def mlp_cases(old, rounds: int, faults: list) -> list:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    m, d, dh, dtype = 50432, 768, 3072, torch.bfloat16
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = nrm(m, d).to(dtype)
    g, b = torch.rand(d, generator=gen, device=dev) + 0.5, nrm(d) * 0.1
    a1 = torch.rand(d, generator=gen, device=dev) * 0.03 + 0.02
    a2 = torch.rand(dh, generator=gen, device=dev) * 0.015 + 0.005
    qw1, s1 = int8_transformer.quantize_weight(nrm(d, dh) * d ** -0.5 * a1[:, None])
    qw2, s2 = int8_transformer.quantize_weight(nrm(dh, d) * dh ** -0.5 * a2[:, None])
    a = (x, g, b, qw1, s1, nrm(dh) * 0.1, qw2, s2, nrm(d) * 0.1, a1, a2)
    w1t, w2t = qw1.t().contiguous(), qw2.t().contiguous()
    inv1, inv2 = (1.0 / a1).contiguous(), (1.0 / a2).contiguous()
    q1 = torch.empty((m, d), dtype=torch.int8, device=dev)
    hidden = torch.empty((m, dh), dtype=torch.int8, device=dev)

    def c_call(lib, out):
        err = lib.cvt_mlp_block_int8(x.data_ptr(), g.data_ptr(), b.data_ptr(), w1t.data_ptr(), a[4].data_ptr(),
                                     a[5].data_ptr(), w2t.data_ptr(), a[7].data_ptr(), a[8].data_ptr(),
                                     inv1.data_ptr(), inv2.data_ptr(), q1.data_ptr(), hidden.data_ptr(),
                                     out.data_ptr(), m, d, dh, 1e-6, 1, stream())
        if err != 0:
            raise RuntimeError(f"mlp_block_int8: CUDA error {err}")
        return out

    new_out, old_out = torch.empty_like(x), torch.empty_like(x)
    new_fn = lambda: c_call(int8_transformer._lib(), new_out)  # noqa: E731
    old_fn = lambda: c_call(old["int8_transformer"], old_out)  # noqa: E731
    want = int8_transformer.mlp_block_int8_plain(*a)
    got = kernels.mlp_block_int8(*a)
    err = float(((got.float() - want.float()).abs() / (1 + want.float().abs())).max())
    ok = {"bits_of_older": torch.equal(got, old_fn()), "kernels_alone_same_bits": torch.equal(got, new_fn()),
          "twin": err <= 2e-2}
    what = f"mlp_block_int8 ({m}, {d}, {dh}) bfloat16"
    check(ok, faults, what)
    times = in_turns({"ms": new_fn, "older_ms": old_fn}, rounds, 10)
    row = dict(case=what, scaled_err=err, checks=ok, **{k: min(v) for k, v in times.items()}, rounds=times,
               calls_a_round=10, launch_ms=launches_apart(new_fn), older_launch_ms=launches_apart(old_fn))
    print(f"{what}: kernels {row['ms']:.4f} ms, older {row['older_ms']:.4f} (least of {rounds} rounds of 10); "
          f"launches apart {row['launch_ms']}; older {row['older_launch_ms']}; {ok}")
    return [row]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-tree", required=True, help="root of the older checkout, under build/")
    ap.add_argument("--cases", nargs="+", choices=CASES, default=list(CASES))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default=str(REPO / "build" / "int8_products_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_products_ab: no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    logs = _build.build(ptxas_verbose=True)
    faults = []
    sass = {}
    for stem in STEMS:
        faults += ptxas_lines("current", logs.get(stem, ""))
        igmma, idp4a = _build.sass_counts(stem, "IGMMA"), _build.sass_counts(stem, "IDP4A")
        products = {fn: (igmma[fn], idp4a.get(fn, 0)) for fn in igmma if "gemm_kernel" in fn}
        sass[stem] = products
        print(f"  {stem}: (IGMMA, IDP4A) in the int8 products' SASS {products}")
        if not products or not all(ig > 0 and dp == 0 for ig, dp in products.values()):
            faults.append(f"{stem}: an int8 product without IGMMA or with IDP4A: {products}")
        if any("i8_gemm_kernel" in fn for fn in igmma):
            faults.append(f"{stem}: the dp4a i8_gemm_kernel is left")
    old = build_old(Path(args.old_tree).resolve())
    results = []
    if "matmul" in args.cases:
        results += matmul_cases(old, args.rounds, faults)
    if "attention" in args.cases:
        results += attention_cases(old, args.rounds, faults)
    if "mlp" in args.cases:
        results += mlp_cases(old, args.rounds, faults)
    summary = {"card": card, "sass": {k: {fn: list(v) for fn, v in p.items()} for k, p in sass.items()},
               "cases": results, "failures": faults}
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if faults:
        print(f"FAILED: {faults}", file=sys.stderr)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
