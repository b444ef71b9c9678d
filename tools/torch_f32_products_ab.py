#!/usr/bin/env python3
"""Build, check and time the split-TF32 products (``csrc/tf32x3.cuh``) behind the
float32 ``mlp_block`` and ``cn_mlp_block`` and ``wgrad_matmul`` (both dtypes), one
variant after another on one card.

    python3 tools/torch_f32_products_ab.py [VARIANT ...]

A VARIANT is ``NAME=VALUE[,NAME=VALUE...]`` over the ``constexpr int`` constants of
``tf32x3.cuh`` and ``wgrad_matmul.cu``, ``base`` for the files as they are, or the root
of another tree of this repository (its ``cpu_vision_tpu_torch/csrc/`` is built, with
this tree's wrappers).  Each is built from a copy of ``csrc/`` under ``build/x3_ab/``
(``wgrad_matmul.cu`` and ``transformer_block.cu``, with the flags of ``_build``, in
parallel); the products' ``ptxas`` lines (registers, spills) and each instantiation's
SASS ``HGMMA`` count are printed, and it fails on a spill, a ``wgmma`` that ptxas
serialises (C7518) or an instantiation without ``HGMMA``.  Then, for each variant:
``wgrad_matmul`` at ResNet-50 b128's twelve 1x1 shapes in float32 and bfloat16, held
within ``1e-5·max|twin|``, the same bits twice, its float64 error ``max|out - f64| /
max|f64|`` beside ``torch.mm``'s (TF32 off; bfloat16: casts and that call) and within
twice it, timed beside that call; the float32 ``mlp_block`` at ViT-B/16 b64 (12,608 x
768, Dh 3072) and at Swin-T's four stages at batch 32, and ``cn_mlp_block`` at the
first, held within ``2e-4·(1 + |twin|)``, the ViT shape's float64 error beside the
twin's, timed beside the stock composite (``layer_norm``, ``linear``, ``gelu``,
``linear``; TF32 off).  A check that fails is printed, the case is timed all the same,
and the exit code is then 1.  The variants run in the order given and then in reverse.
Default: ``base``.
"""

import ctypes
import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from cpu_vision_tpu_torch import _dtype  # noqa: E402
from cpu_vision_tpu_torch.ops import kernels  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import _build, transformer_block  # noqa: E402

# the package's name wgrad_matmul is the function; the module is imported by its path
wgrad_module = importlib.import_module("cpu_vision_tpu_torch.ops.kernels.wgrad_matmul")
STEMS = ("wgrad_matmul", "transformer_block")
MODULES = (wgrad_module, transformer_block)
HEADERS = ("tf32x3.cuh", "wgrad_matmul.cu")
PRODUCTS = ("x3_gemm_kernel", "wgrad_bf16_kernel")
# ResNet-50 b128's 1x1 convolutions with at least 16,384 rows: (M, Cin, Cout)
WGRAD_SHAPES = [(401408, 64, 64), (401408, 64, 256), (401408, 256, 64), (401408, 256, 128),
                (100352, 128, 512), (100352, 512, 128), (100352, 256, 512), (100352, 512, 256),
                (25088, 256, 1024), (25088, 1024, 256), (25088, 512, 1024), (25088, 1024, 512)]
WGRAD_TOL = 1e-5
TOL = 2e-4
CALLS = 10


def build(variant: str, out_dir: Path):
    """Start the compiles of ``STEMS`` for ``variant``; returns {stem: (process, library path)}."""
    src = out_dir / "csrc"
    shutil.rmtree(out_dir, ignore_errors=True)
    tree = Path(variant)
    shutil.copytree(tree / "cpu_vision_tpu_torch" / "csrc" if tree.is_dir() else _build.CSRC_DIR, src)
    if variant != "base" and not tree.is_dir():
        for item in variant.split(","):
            name, value = item.split("=")
            hits = 0
            for header in HEADERS:
                text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};",
                                  (src / header).read_text())
                (src / header).write_text(text)
                hits += n
            if hits != 1:
                raise ValueError(f"no constant {name} in {HEADERS}")
    jobs = {}
    for stem in STEMS:
        lib = out_dir / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(stem, []), "-Xptxas", "-v", "-I", str(src),
               "-o", str(lib), str(src / f"{stem}.cu")]
        jobs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return jobs


def sass_hgmma(lib: Path):
    """{mangled kernel name: HGMMA instructions} of a library's SASS."""
    dump = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name, shown = {}, None, set()
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and re.search(r"\bHGMMA\b", line):
            counts[name] += 1
            form = re.search(r"HGMMA\S*", line).group(0)
            if form not in shown:  # each form of the instruction once, as the SASS spells it
                shown.add(form)
                print(f"  {lib.name}: {line.strip()[:120]}")
    return counts


def ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def f64_err(out: torch.Tensor, ref64: torch.Tensor) -> float:
    """max |out - ref64| / max |ref64|, in float64."""
    return float((out.double() - ref64).abs().max() / ref64.abs().max())


def mlp_f64(x, ln_g, ln_b, w1, b1, w2, b2, eps, res=None, gamma=None):
    """The MLP block's function in float64 on the same inputs (the twins' LayerNorm and erf polynomial)."""
    h = transformer_block._ln_f32(x.double(), ln_g.double(), ln_b.double(), eps)
    h = transformer_block._gelu_f32(h @ w1.double() + b1.double()) @ w2.double() + b2.double()
    if gamma is not None:
        h = h * gamma.double()
    return (x if res is None else res).double() + h


def main() -> int:
    variants = sys.argv[1:] or ["base"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    root = REPO / "build" / "x3_ab"
    jobs = {v: build(v, root / f"v{i}") for i, v in enumerate(dict.fromkeys(variants))}
    libs = {}
    for v, by_stem in jobs.items():
        libs[v] = {}
        for stem, (proc, lib) in by_stem.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{v}: nvcc failed on {stem}\n{log}")
            name = ""
            for line in log.splitlines():
                found = re.search(r"Compiling entry function '(\S+)'", line)
                if found:
                    name = found.group(1)
                if "wgmma" in line.lower() or "warning" in line.lower():  # e.g. wgmma serialised by ptxas
                    print(f"{v}: {stem}: {line.strip()}")
                    if "serialized" in line and any(p in line for p in PRODUCTS):
                        raise AssertionError(f"{v}: {line.strip()}")
                if any(p in name for p in PRODUCTS) and ("Used" in line or "spill" in line):
                    print(f"{v}: {stem}: {name[:60]}: {line.strip()}")
                    if "spill" in line and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line):
                        raise AssertionError(f"{v}: {name} spills: {line.strip()}")
            counts = {fn: c for fn, c in sass_hgmma(lib).items() if any(p in fn for p in PRODUCTS)}
            print(f"{v}: {stem}: HGMMA in SASS {counts}")
            if not counts or not all(counts.values()):
                raise AssertionError(f"{v}: {stem}: a product without HGMMA")
            libs[v][stem] = lib

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    cases = []  # (name, fn, args, check(out) -> dict, library fn or None, flops)
    for dtype in (torch.float32, torch.bfloat16):
        for m, cin, cout in WGRAD_SHAPES:
            x, dy = normal((m, cin), dtype), normal((m, cout), dtype)
            with _dtype.full_float32():
                lib_out = torch.mm(x.t().float(), dy.float())
            ref64 = x.t().double() @ dy.double()
            lib_err = f64_err(lib_out, ref64)
            twin = wgrad_module.wgrad_matmul_plain(x, dy)

            def check(out, twin=twin, ref64=ref64, lib_err=lib_err):
                err = float((out - twin).abs().max())
                if err > WGRAD_TOL * float(twin.abs().max()):
                    raise AssertionError(f"max |err| {err} against the twin")
                k_err = f64_err(out, ref64)
                if k_err > 2 * lib_err:
                    raise AssertionError(f"float64 error {k_err} past twice torch.mm's {lib_err}")
                return {"max_abs_err": err, "f64_err": k_err, "library_f64_err": lib_err}

            def library(x=x, dy=dy):
                with _dtype.full_float32():
                    return torch.mm(x.t(), dy) if x.dtype == torch.float32 else torch.mm(x.t().float(), dy.float())

            cases.append((f"wgrad_matmul {m}x{cin}x{cout} {str(dtype)[6:]}", kernels.wgrad_matmul, (x, dy), check,
                          library, 2 * m * cin * cout))
    for tokens, d, label in ((64 * 197, 768, "vit_b_16 b64"), (32 * 56 * 56, 96, "S1 b32"), (32 * 28 * 28, 192, "S2 b32"),
                             (32 * 14 * 14, 384, "S3 b32"), (32 * 7 * 7, 768, "S4 b32")):
        dh = 4 * d
        eps = 1e-6 if label.startswith("vit") else 1e-5
        args = (normal((tokens, d), torch.float32), normal((d,), torch.float32, 0.2, 1.0),
                normal((d,), torch.float32, 0.1), normal((d, dh), torch.float32, d ** -0.5),
                normal((dh,), torch.float32, 0.1), normal((dh, d), torch.float32, dh ** -0.5),
                normal((d,), torch.float32, 0.1), eps)
        twin = transformer_block.mlp_block_plain(*args)
        ref64 = mlp_f64(*args) if label.startswith("vit") else None
        twin_err = None if ref64 is None else f64_err(twin, ref64)

        def check(out, twin=twin, ref64=ref64, twin_err=twin_err):
            err = (out - twin).abs()
            if not bool((err <= TOL * (1 + twin.abs())).all()):
                raise AssertionError(f"max |err| {float(err.max())} against the twin")
            got = {"max_abs_err": float(err.max())}
            if ref64 is not None:
                got.update(f64_err=f64_err(out, ref64), twin_f64_err=twin_err)
            return got

        def library(args=args, d=d):
            x, ln_g, ln_b, w1, b1, w2, b2, eps = args
            return x + F.linear(F.gelu(F.linear(F.layer_norm(x, (d,), ln_g, ln_b, eps), w1.t(), b1)), w2.t(), b2)

        cases.append((f"mlp_block f32 {label}", kernels.mlp_block, args, check, library, 4 * tokens * d * dh))
        if label.startswith("S1"):
            res, gamma = normal((tokens, d), torch.float32), normal((d,), torch.float32, 0.5)
            cn = (args[0], res, *args[1:7], gamma, 1e-6)
            cn_twin = transformer_block.cn_mlp_block_plain(*cn)

            def cn_check(out, twin=cn_twin):
                err = (out - twin).abs()
                if not bool((err <= TOL * (1 + twin.abs())).all()):
                    raise AssertionError(f"max |err| {float(err.max())} against the twin")
                return {"max_abs_err": float(err.max())}

            cases.append((f"cn_mlp_block f32 {label}", kernels.cn_mlp_block, cn, cn_check, None, 4 * tokens * d * dh))

    saved = _build.load
    results, failed = [], []
    try:
        for v in variants + variants[::-1]:
            _build.load = lambda stem, lib=libs[v]: ctypes.CDLL(str(lib[stem]))
            for module in MODULES:
                module._c_lib = None
            row = {"variant": v}
            for what, fn, args, check, library, flops in cases:
                out = fn(*args)
                try:
                    got = check(out)
                    if what.startswith("wgrad") and not torch.equal(fn(*args), out):
                        raise AssertionError("two calls differ")
                except AssertionError as fault:  # the variant is wrong here: noted, timed all the same
                    failed.append(f"{v}: {what}: {fault}")
                    print(f"FAILED {failed[-1]}", flush=True)
                    got = {}
                t = ms(lambda: fn(*args))
                lib_t = None if library is None else ms(library)
                row[what] = dict(got, ms=t, library_ms=lib_t)
                lib_s = "" if lib_t is None else f", library {lib_t:.4f} ms"
                print(f"{v}: {what}: {t:.4f} ms, {flops / t / 1e9:.1f} TFLOP/s{lib_s}; "
                      + ", ".join(f"{k} {val:.3e}" for k, val in got.items()) + f" ({card})", flush=True)
            results.append(row)
    finally:
        _build.load = saved
        for module in MODULES:
            module._c_lib = None
    print(json.dumps({"card": card, "readings": results, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
