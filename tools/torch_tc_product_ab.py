#!/usr/bin/env python3
"""Time the bf16 tensor-core product (``csrc/ln_gemm.cuh:tc_gemm_kernel``) under other
pipeline constants, one variant after another on one card.

    python3 tools/torch_tc_product_ab.py [VARIANT ...]

A VARIANT is ``NAME=VALUE[,NAME=VALUE...]`` over the ``constexpr int`` constants of
``ln_gemm.cuh`` (``TC_STAGES``, ``TC_INFLIGHT``, ``LN_HELD_MAX``), or ``base`` for the file
as it is.
Each is built from a copy of ``csrc/`` under ``build/tc_ab/`` (only
``transformer_block.cu``, with the flags of ``_build``), its ``ptxas`` line and SASS
``HGMMA`` count printed, held against the twin, and timed with CUDA events on the
products of the bf16 main paths: ViT-B/16 b256's MLP and QKV, Swin-T b256's first and
last stages, and ``mlp_block`` (ViT-B/16 and Swin-T's first stage) and ``attention_block``
whole.  The variants run in the
order given and then in reverse (name one twice to see the spread).  Default:
``base TC_STAGES=4,TC_INFLIGHT=1 TC_STAGES=3,TC_INFLIGHT=1 TC_STAGES=4,TC_INFLIGHT=0``.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from cpu_vision_tpu_torch.ops import kernels  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import _build, transformer_block  # noqa: E402

DEFAULT = ["base", "TC_STAGES=4,TC_INFLIGHT=1", "TC_STAGES=3,TC_INFLIGHT=1", "TC_STAGES=4,TC_INFLIGHT=0"]
# (m, k, n, epilogue): ViT-B/16 b256 up, down, QKV; Swin-T b256 S1 QKV (f32 out), up, down; S4 up
SHAPES = [(50432, 768, 3072, "gelu"), (50432, 3072, 768, "residual"), (50432, 768, 2304, "bias"),
          (802816, 96, 288, "bias_f32"), (802816, 96, 384, "gelu"), (802816, 384, 96, "residual"),
          (12544, 768, 3072, "gelu")]
CALLS = 10


def build(variant: str, out_dir: Path):
    """Build transformer_block.cu of ``variant``; returns (process, library path)."""
    src = out_dir / "csrc"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, src)
    if variant != "base":
        header = src / "ln_gemm.cuh"
        text = header.read_text()
        for item in variant.split(","):
            name, value = item.split("=")
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};", text)
            if n != 1:
                raise ValueError(f"no constant {name} in ln_gemm.cuh")
        header.write_text(text)
    lib = out_dir / "libtransformer_block.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src), "-o", str(lib),
           str(src / "transformer_block.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


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


def main() -> int:
    variants = sys.argv[1:] or DEFAULT
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    root = REPO / "build" / "tc_ab"
    jobs = {v: build(v, root / f"v{i}") for i, v in enumerate(dict.fromkeys(variants))}
    libs = {}
    for v, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{v}: nvcc failed\n{log}")
        name = ""
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                name = found.group(1)
            if "tc_gemm_kernelILi1E" in name and ("Used" in line or "spill" in line):
                print(f"{v}: {line.strip()}")
        dump = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "--dump-sass", str(lib)],
                              capture_output=True, text=True, check=True).stdout
        print(f"{v}: {len(re.findall(r'HGMMA', dump))} HGMMA instructions in the library")
        libs[v] = lib

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    cases = []
    for m, k, n, epi in SHAPES:
        a, w, bias = normal((m, k), torch.bfloat16), normal((k, n), torch.bfloat16, k ** -0.5), normal((n,), torch.float32, 0.1)
        resid = normal((m, n), torch.bfloat16) if epi == "residual" else None
        out_dtype = torch.float32 if epi == "bias_f32" else torch.bfloat16
        args = (a, w, bias, epi.replace("_f32", ""), resid, None, out_dtype)
        cases.append((f"product {m}x{k}x{n} {epi}", args, kernels.bf16_product, transformer_block.bf16_product_plain,
                      2 * m * k * n))
    d, dh = 768, 3072
    x = normal((50432, d), torch.bfloat16)
    ln = (normal((d,), torch.float32, 0.2, 1.0), normal((d,), torch.float32, 0.1))
    mlp = (x, *ln, normal((d, dh), torch.bfloat16, d ** -0.5), normal((dh,), torch.float32, 0.1),
           normal((dh, d), torch.bfloat16, dh ** -0.5), normal((d,), torch.float32, 0.1), 1e-6)
    cases.append(("mlp_block vit_b_16 b256", mlp, kernels.mlp_block, transformer_block.mlp_block_plain,
                  4 * 50432 * d * dh))
    d1, m1 = 96, 802816
    mlp1 = (normal((m1, d1), torch.bfloat16), normal((d1,), torch.float32, 0.2, 1.0), normal((d1,), torch.float32, 0.1),
            normal((d1, 4 * d1), torch.bfloat16, d1 ** -0.5), normal((4 * d1,), torch.float32, 0.1),
            normal((4 * d1, d1), torch.bfloat16, (4 * d1) ** -0.5), normal((d1,), torch.float32, 0.1), 1e-5)
    cases.append(("mlp_block swin_t b256 S1", mlp1, kernels.mlp_block, transformer_block.mlp_block_plain,
                  4 * m1 * d1 * 4 * d1))
    attn = (x.reshape(256, 197, d), *ln, normal((d, 3 * d), torch.bfloat16, d ** -0.5),
            normal((3 * d,), torch.float32, 0.1), normal((d, d), torch.bfloat16, d ** -0.5),
            normal((d,), torch.float32, 0.1), 12, 0.125, 1e-6)
    cases.append(("attention_block vit_b_16 b256", attn, kernels.attention_block,
                  transformer_block.attention_block_plain, 8 * 50432 * d * d))

    saved = _build.load
    results = []
    try:
        for v in variants + variants[::-1]:
            _build.load = lambda stem, lib=libs[v]: ctypes.CDLL(str(lib))
            transformer_block._c_lib = None
            row = {"variant": v}
            for what, args, fn, twin, flops in cases:
                got, want = fn(*args), twin(*args)
                err = (got.float() - want.float()).abs()
                if not bool((err <= 2e-2 * (1 + want.float().abs())).all()):
                    raise AssertionError(f"{v}: {what} disagrees with its twin, max |err| {float(err.max())}")
                t = ms(lambda: fn(*args))
                row[what] = t
                print(f"{v}: {what}: {t:.4f} ms, {flops / t / 1e9:.1f} TFLOP/s ({card})", flush=True)
            results.append(row)
    finally:
        _build.load = saved
        transformer_block._c_lib = None
    print(json.dumps({"card": card, "readings": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
