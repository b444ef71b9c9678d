#!/usr/bin/env python3
"""Time ``mlp_block_int8`` (``csrc/int8_transformer.cu``) and ``ln_backward_rows``
(``csrc/ln_gemm.cuh``) against an older tree's sources of them and against
PyTorch, in turns on one card, and check the bits.

    python3 tools/torch_int8_mlp_ab.py --old-tree DIR [--trees DIR ...] [--rounds N] [--json PATH]

``--old-tree`` is the root of an older checkout (a ``git archive`` unpacked
under ``build/``), whose ``cpu_vision_tpu_torch/csrc/int8_transformer.cu`` and
``transformer_block.cu`` are built with its own headers and ``_build``'s flags
of the time (``--fmad=false`` for the int8 source), with ``-Xptxas -v``.  Its
C interfaces must be those of the dp4a ``mlp_int8_kernel`` (one launch) and of
the LayerNorm backward whose caller adds the blocks' partial sums
(``cvt_ln_backward`` with a block count), as at commit 4f2e03c.

``mlp_block_int8`` at ViT-B/16 b256's (50,432, 768, 3072) in bfloat16 and at
every width of ``tests/test_torch_cuda.py::test_mlp_block_int8_matches_twin``
in bfloat16 and float32: the output must equal the older kernel's bit for bit
and its plain twin's within the card test's rule (``max |a - b| / (1 + |b|)
<= 2e-2``), two calls must give the same bits; the current kernels and the
older one, each alone (direct calls of its C entry captured in a CUDA graph
and replayed: the device's time, ``ms`` and ``older_ms``) and inside its
wrapper's host work (checks, inverse scales: ``wrapper_ms``,
``older_wrapper_ms``; at small widths the host's time), and the stock composite (``layer_norm``, quantise, ``torch._int_mm``, ``gelu``,
quantise, ``torch._int_mm``, epilogue; none below 17 tokens, where
``torch._int_mm`` refuses) are timed on the device clock (CUDA events, calls a
round by size) in ``--rounds`` rounds, the order reversed every other round;
at ViT-B/16's shape also the three launches apart (``torch.profiler``).
``ln_backward_rows`` at ViT-B/16 b128's rows (25,216, 768) in bfloat16 with and
without the residual, and in float32: held to its plain version (dx within
the transformer kernels' rule, the parameters' gradients within 1e-5·(1 +
|plain|) and 1e-5 of their largest), the same bits twice, and timed against
the older source (its partials added by ``torch.sum`` as its wrapper did) and
``aten.native_layer_norm_backward``.  Prints the card's name and power limit,
the new kernels' registers and spills, the SASS opcodes of the int8 products
(``IGMMA`` must be there, ``IDP4A`` not), one line a case and a JSON line of
every figure (also written to ``--json``).  Exits 1 if a check fails.

``--trees`` adds variants of the current source at ViT-B/16's shape: roots of
trees under ``build/`` whose ``int8_transformer.cu`` has this one's C interface
(a copy with other constants, or a timing experiment); each is built beside
the current one, timed in the same turns, its launches apart, and whether it
kept the current bits is printed, not held.  No test imports it.
"""

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from cpu_vision_tpu_torch.ops import kernels  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import _build, int8_matmul, int8_transformer, transformer_block  # noqa: E402

MLP_CASES = [(50432, 768, 3072, torch.bfloat16)] + [
    (m, d, dh, dtype) for dtype in (torch.bfloat16, torch.float32)
    for m, d, dh in ((197, 768, 3072), (50, 1024, 4096), (33, 1280, 5120), (70, 256, 512), (1, 512, 256))]
LN_CASES = [(25216, 768, torch.bfloat16, True), (25216, 768, torch.bfloat16, False), (25216, 768, torch.float32, True)]
NEW_KERNELS = ("i8_tc_gemm_kernel", "ln_quant_rows_kernel", "ln_backward_vec_kernel", "ln_backward_kernel",
               "ln_backward_reduce_kernel")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ptxas_lines(label: str, log: str, names) -> list:
    """Print the registers and spills of the kernels whose names hold one of ``names``; the faults, listed (a spill,
    or a wgmma that ptxas serialised)."""
    fn, faults = "", []
    for line in log.splitlines():
        named = re.search(r"Compiling entry function '(\S+)'", line)
        fn = named.group(1) if named else fn
        if not any(n in fn for n in names):
            continue
        if "Used" in line or "spill" in line:
            print(f"  {label}: {fn}: {line.strip()}")
        if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
            faults.append(f"{label}: {fn} spills: {line.strip()}")
        if "serialized" in line:
            faults.append(f"{label}: {line.strip()}")
    return faults


def build_old(tree: Path, faults: list) -> dict:
    csrc = tree / "cpu_vision_tpu_torch" / "csrc"
    out = REPO / "build" / "int8_mlp_ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem, flags in (("int8_transformer", ["--fmad=false"]), ("transformer_block", [])):
        lib = out / f"lib{stem}_old.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-I", str(csrc), "-o", str(lib),
               str(csrc / f"{stem}.cu")]
        jobs[stem] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stem, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        ptxas_lines("older", log, ("mlp_int8_kernel", "ln_backward_kernel"))  # printed; the older build's own
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the older {stem}.cu:\n{log}")
        libs[stem] = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["int8_transformer"].cvt_mlp_block_int8.argtypes = [p] * 12 + [i, i, i, f, i, p]
    libs["transformer_block"].cvt_ln_backward.argtypes = [p] * 6 + [i, i, f, i, i, p]
    return libs


def build_variant(tree: Path) -> ctypes.CDLL:
    """The int8_transformer.cu of a variant tree, built with ``_build``'s flags for it; its registers printed."""
    csrc = tree / "cpu_vision_tpu_torch" / "csrc"
    lib = REPO / "build" / "int8_mlp_ab" / f"libint8_transformer_{tree.name}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS["int8_transformer"], "-Xptxas", "-v", "-I",
           str(csrc), "-o", str(lib), str(csrc / "int8_transformer.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    ptxas_lines(tree.name, done.stdout + done.stderr, ("i8_tc_gemm_kernel",))
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tree.name}:\n{done.stdout}{done.stderr}")
    out = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out.cvt_mlp_block_int8.argtypes = [p] * 14 + [i, i, i, f, i, p]
    return out


def device_ms(fn, calls: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def graphed(fn, calls: int) -> "torch.cuda.CUDAGraph":
    """A CUDA graph of ``calls`` calls of ``fn`` (whose kernels write preallocated tensors), captured after one call
    on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def in_turns(fns: dict, rounds: int, calls) -> dict:
    """{name: [ms of each round]}, the order of ``fns`` reversed every other round; ``calls`` a round, one number
    or one a name."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(device_ms(fns[name], calls[name] if isinstance(calls, dict) else calls))
    return times


def launches_apart(fn, names, calls: int = 5) -> list:
    """[(kernel, device ms a call)] of the kernels of ``fn`` whose names hold one of ``names``, in launch order, from
    ``torch.profiler`` over ``calls`` calls after one that warms up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.name for n in names))
    chain = len(spans) // calls
    return [(spans[i][2][:80],
             sum(spans[c * chain + i][1] - spans[c * chain + i][0] for c in range(calls)) / calls / 1e3)
            for i in range(chain)]


def mlp_args(gen, m, d, dh, dtype, dev):
    """``tests/test_torch_cuda.py::_int8_mlp_args``'s distributions, drawn on the card."""
    def u(n, lo, hi):
        return torch.rand(n, generator=gen, device=dev) * (hi - lo) + lo

    def nrm(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = nrm(m, d).to(dtype)
    g, b = u(d, 0.5, 1.5), nrm(d) * 0.1
    a1, a2 = u(d, 0.02, 0.05), u(dh, 0.005, 0.02)
    qw1, s1 = int8_transformer.quantize_weight(nrm(d, dh) * d ** -0.5 * a1[:, None])
    qw2, s2 = int8_transformer.quantize_weight(nrm(dh, d) * dh ** -0.5 * a2[:, None])
    return x, g, b, qw1, s1, nrm(dh) * 0.1, qw2, s2, nrm(d) * 0.1, a1, a2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-tree", required=True, help="root of the older checkout, under build/")
    ap.add_argument("--trees", nargs="*", default=[], help="variants' roots under build/, this C interface")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default=str(REPO / "build" / "int8_mlp_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_mlp_ab: no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    logs = _build.build(ptxas_verbose=True)
    faults = []
    for stem in ("int8_transformer", "transformer_block"):
        faults += ptxas_lines("current", logs.get(stem, ""), NEW_KERNELS)
    igmma = _build.sass_counts("int8_transformer", "IGMMA")
    idp4a = _build.sass_counts("int8_transformer", "IDP4A")
    # the MLP's epilogues (Q8_GELU 0, Q8_RESID 1) of the product the int8 kernels share, in both dtypes
    products = {fn: (igmma[fn], idp4a.get(fn, 0)) for fn in igmma
                if "i8_tc_gemm_kernel" in fn and ("ILi0E" in fn or "ILi1E" in fn)}
    print(f"  int8_transformer: (IGMMA, IDP4A) in the int8 MLP products' SASS {products}")
    if len(products) != 4 or not all(ig > 0 and dp == 0 for ig, dp in products.values()):
        faults.append(f"int8 MLP products: expected IGMMA and no IDP4A in four instantiations, got {products}")
    if any("mlp_int8_kernel" in fn for fn in igmma):
        faults.append("the dp4a mlp_int8_kernel is left")
    old = build_old(Path(args.old_tree).resolve(), faults)
    new_lib = int8_transformer._lib()
    variants = {Path(tree).name: build_variant(Path(tree).resolve()) for tree in args.trees}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    results = []

    for m, d, dh, dtype in MLP_CASES:
        a = mlp_args(gen, m, d, dh, dtype, dev)
        x, g, b, qw1, s1, b1, qw2, s2, b2, a1, a2 = a
        w1t, w2t = qw1.t().contiguous(), qw2.t().contiguous()
        inv1, inv2 = (1.0 / a1).contiguous(), (1.0 / a2).contiguous()
        w1c, w2c = qw1.t().contiguous().t(), qw2.t().contiguous().t()

        # the kernels alone (or a variant's), their outputs and scratch allocated once: a CUDA graph can replay them
        q1, hidden, new_out, old_out = (torch.empty((m, d), dtype=torch.int8, device=dev),
                                        torch.empty((m, dh), dtype=torch.int8, device=dev), torch.empty_like(x),
                                        torch.empty_like(x))

        def new_call(lib=None, out=new_out):
            err = (lib or new_lib).cvt_mlp_block_int8(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), w1t.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                s2.data_ptr(), b2.data_ptr(), inv1.data_ptr(), inv2.data_ptr(), q1.data_ptr(), hidden.data_ptr(),
                out.data_ptr(), m, d, dh, 1e-6, int(dtype == torch.bfloat16), stream())
            if err != 0:
                raise RuntimeError(f"mlp_block_int8: CUDA error {err}")
            return out

        def old_call(out=old_out):
            err = old["int8_transformer"].cvt_mlp_block_int8(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), w1t.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                s2.data_ptr(), b2.data_ptr(), inv1.data_ptr(), inv2.data_ptr(), out.data_ptr(), m, d, dh, 1e-6,
                int(dtype == torch.bfloat16), stream())
            if err != 0:
                raise RuntimeError(f"older mlp_block_int8: CUDA error {err}")
            return out

        def old_wrapper():  # the older wrapper's host work (checks, inverse scales, f32 vectors) around its kernel
            int8_transformer._check_mlp(x, g, b, qw1, s1, b1, qw2, s2, b2)
            int8_transformer._check_card(x)
            w1t_, w2t_ = qw1.t().contiguous(), qw2.t().contiguous()
            inv1_, inv2_ = int8_transformer._inverse(a1, d, dev), int8_transformer._inverse(a2, dh, dev)
            vecs = [int8_transformer._f32(t_) for t_ in (g, b, s1, b1, s2, b2)]
            out = torch.empty_like(x)
            err = old["int8_transformer"].cvt_mlp_block_int8(
                x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w1t_.data_ptr(), vecs[2].data_ptr(),
                vecs[3].data_ptr(), w2t_.data_ptr(), vecs[4].data_ptr(), vecs[5].data_ptr(), inv1_.data_ptr(),
                inv2_.data_ptr(), out.data_ptr(), m, d, dh, 1e-6, int(dtype == torch.bfloat16), stream())
            if err != 0:
                raise RuntimeError(f"older mlp_block_int8: CUDA error {err}")
            return out

        def composite():
            h = F.layer_norm(x.float(), (d,), g, b, 1e-6)
            f = F.gelu(torch._int_mm(int8_matmul.quantize_i8(h, inv1), w1c).float() * s1 + b1)
            return (x.float() + (torch._int_mm(int8_matmul.quantize_i8(f, inv2), w2c).float() * s2 + b2)).to(dtype)

        new_fn = lambda: kernels.mlp_block_int8(*a)  # noqa: E731
        kernels.reset_launch_counts()
        out = new_fn()
        launches = (kernels.mlp_block_int8.launches, kernels.mlp_block_int8.kernel_launches)
        want = int8_transformer.mlp_block_int8_plain(*a)
        err = float(((out.float() - want.float()).abs() / (1 + want.float().abs())).max())
        checks = {"bits_of_older": torch.equal(out, old_call()), "same_bits_twice": torch.equal(out, new_fn()),
                  "twin": err <= 2e-2, "three_kernels_a_call": launches == (1, 3),
                  "kernels_alone_same_bits": torch.equal(out, new_call().clone()),
                  "older_wrapper_same_bits": torch.equal(out, old_wrapper())}
        main_case = m == MLP_CASES[0][0]
        calls = max(5, min(200, int(2e9 / (m * d * dh))))
        # the kernels alone, CUDA graphs of `calls` calls replayed (the device's own time, no host work between
        # launches); then through the wrappers and the composite, the host's work included
        graphs = {"ms": graphed(new_call, calls), "older_ms": graphed(old_call, calls)}
        for name, lib in variants.items() if main_case else ():
            graphs[f"{name}_ms"] = graphed(lambda lib=lib: new_call(lib), calls)
        fns = {k: (lambda gr=gr: gr.replay()) for k, gr in graphs.items()}
        fns.update(wrapper_ms=new_fn, older_wrapper_ms=old_wrapper)
        if m > 16:
            fns["library_ms"] = composite
        times = in_turns(fns, args.rounds, {k: 2 if k in graphs else calls for k in fns})
        for k in graphs:  # a replay is `calls` calls
            times[k] = [ms / calls for ms in times[k]]
        what = f"mlp_block_int8 ({m}, {d}, {dh}) {str(dtype).replace('torch.', '')}"
        row = dict(case=what, **{k: min(v) for k, v in times.items()}, rounds=times, calls_a_round=calls,
                   scaled_err=err, checks=checks, bound_ms=max(2 * m * d * dh * 2 / 1979e12,
                                                               (2 * m * d * x.element_size() + 2 * d * dh) / 3.35e12)
                   * 1e3, split_bytes_ms=2 * m * (d + dh) / 3.35e12 * 1e3)
        if main_case:
            row["launch_ms"] = launches_apart(new_call, ("ln_quant_rows_kernel", "i8_tc_gemm_kernel"))
            row["variants"] = {name: {"ms": row.pop(f"{name}_ms"), "same_bits": torch.equal(out, new_call(lib)),
                                      "launch_ms": launches_apart(lambda lib=lib: new_call(lib),
                                                                  ("ln_quant_rows_kernel", "i8_tc_gemm_kernel"))}
                               for name, lib in variants.items()}
        results.append(row)
        lib = f"{row['library_ms']:.4f}" if "library_ms" in row else "null"
        print(f"{what}: kernels alone {row['ms']:.4f} ms, older {row['older_ms']:.4f}; through the wrappers "
              f"{row['wrapper_ms']:.4f}, older {row['older_wrapper_ms']:.4f}; composite {lib}, bound "
              f"{row['bound_ms']:.4f} (least of {args.rounds} rounds of {calls}); scaled err {err:.3e}; {checks}"
              f"{'; launches apart ' + str(row['launch_ms']) if 'launch_ms' in row else ''}")
        for name, v in row.get("variants", {}).items():
            print(f"  variant {name}: kernels alone {v['ms']:.4f} ms, same bits {v['same_bits']}, launches apart "
                  f"{v['launch_ms']}")
        faults += [f"{what}: {k}" for k, ok in checks.items() if not ok]
        del a, x, out, want

    for m, d, dtype, with_resid in LN_CASES:
        x, dh_, r = (torch.randn((m, d), generator=gen, device=dev).to(dtype) for _ in range(3))
        ln_g = torch.randn(d, generator=gen, device=dev) * 0.2 + 1.0
        resid = r if with_resid else None
        blocks = min(math.ceil(m / 4), 528)

        def old_call():
            dx = torch.empty_like(x)
            partial = torch.empty((blocks, 2, d), dtype=torch.float32, device=dev)
            err = old["transformer_block"].cvt_ln_backward(
                x.data_ptr(), ln_g.data_ptr(), dh_.data_ptr(), None if resid is None else resid.data_ptr(),
                dx.data_ptr(), partial.data_ptr(), m, d, 1e-6, blocks, int(dtype == torch.bfloat16), stream())
            if err != 0:
                raise RuntimeError(f"older ln_backward: CUDA error {err}")
            sums = partial.sum(dim=0)
            return dx, sums[0], sums[1]

        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], ln_g.to(dtype), None, 1e-6)

        def library():
            return torch.ops.aten.native_layer_norm_backward(dh_, x, [d], mean, rstd, ln_g.to(dtype), None,
                                                             [True, True, False])

        new_fn = lambda: kernels.ln_backward_rows(x, ln_g, dh_, resid)  # noqa: E731
        got, ref, older = new_fn(), kernels.ln_backward_plain(x, ln_g, dh_, resid), old_call()
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        dx_err = float(((got[0].float() - ref[0].float()).abs() / (1 + ref[0].float().abs())).max())
        p_ok = all(bool(((a_ - b_).abs() <= 1e-5 * (1 + b_.abs()) + 1e-5 * b_.abs().max()).all())
                   for a_, b_ in zip(got[1:], ref[1:]))
        checks = {"dx_twin": dx_err <= tol, "params_twin": p_ok,
                  "same_bits_twice": all(torch.equal(a_, b_) for a_, b_ in zip(got, new_fn()))}
        dx_vs_older = float((got[0].float() - older[0].float()).abs().max())
        flips = int((got[0] != older[0]).sum())
        times = in_turns({"ms": new_fn, "older_ms": old_call, "library_ms": library}, args.rounds, 50)
        what = f"ln_backward_rows ({m}, {d}) {str(dtype).replace('torch.', '')}{' + resid' if with_resid else ''}"
        row = dict(case=what, **{k: min(v) for k, v in times.items()}, rounds=times, dx_scaled_err=dx_err,
                   dx_max_diff_vs_older=dx_vs_older, dx_values_unlike_older=flips, checks=checks,
                   bound_ms=(3 + with_resid) * x.numel() * x.element_size() / 3.35e12 * 1e3,
                   kernel_info=transformer_block.ln_backward_info(x, ln_g, dh_, resid))
        results.append(row)
        print(f"{what}: kernel {row['ms']:.4f} ms, older {row['older_ms']:.4f}, native_layer_norm_backward "
              f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} (least of {args.rounds} rounds of 50); dx scaled "
              f"err {dx_err:.3e}, {flips} dx values unlike the older kernel's (max |diff| {dx_vs_older:.3e}); "
              f"{checks}; {row['kernel_info']}")
        faults += [f"{what}: {k}" for k, ok in checks.items() if not ok]
        del x, dh_, r, got, ref, older

    summary = {"card": card, "cases": results, "failures": faults}
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if faults:
        print(f"FAILED: {faults}", file=sys.stderr)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
