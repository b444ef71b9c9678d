#!/usr/bin/env python3
"""Build, check and time the attention core's backward (Kernel B,
``csrc/tc_attention_bwd.cuh``) and the float32 core at head dim 64 by split TF32
(``csrc/tf32x3_attention.cuh``) under other constants, one variant after another
on one card.

    python3 tools/torch_flash_kernels_ab.py [VARIANT ...]

A VARIANT is ``NAME=VALUE[,NAME=VALUE...]`` over the ``constexpr int`` constants of
``tc_attention_bwd.cuh`` (``ABW_BLOCKS``; ``ABW_STAGES`` below 3 would race), ``base`` for the files as they are, or the root
of another tree of this repository (an unpacked ``git archive`` of an older commit under
``build/``: its ``cpu_vision_tpu_torch/csrc/attention.cu`` is built, with this tree's
wrappers, so its C interface must be this tree's).  Each variant's ``attention.cu`` is
built under ``build/flash_ab/`` with the flags of ``_build`` (all compiles in parallel);
the ``ptxas`` lines of the backward's kernels and of the float32 cores (registers,
spills, ``wgmma`` notes), the ``HGMMA`` count and the most frequent opcodes in their SASS
(static counts), and each kernel's registers,
shared memory and blocks an SM (``flash_attention.kernel_info``) are printed.  Then, for
each variant in the order given and then in reverse:

- Kernel B at ViT-B/16 b128's (128, 197, 12, 64), at (64, 257, 16, 64) and at (16, 577,
  16, 64): dq, dk, dv and the joined heads held to ``attention_core_backward_plain`` and
  ``flash_mha_plain`` within ``2e-2·(1 + |plain|)`` (``base`` must agree; another variant,
  a timing experiment, is marked), the same bits twice (and whether they are the first
  variant's bits), the call timed with CUDA events and each of its two launches apart
  from ``torch.profiler``;
- ``flash_mha`` in float32 at ViT-B/16 b64's (64, 197, 12, 64): within ``2e-4·(1 +
  |twin|)`` of the twin, its distance from float64 (``max|out - f64| / max|f64|``) no more
  than twice the scalar float32 core's (``_flash_mha_scalar``), timed.

Once, beside them: SDPA's backward (its graph kept between calls, so that only the
backward's kernels run) and SDPA in float32 (TF32 off) on the same tensors.  Default:
``base``.
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
import torch.nn.functional as F  # noqa: E402

from cpu_vision_tpu_torch import _dtype  # noqa: E402
from cpu_vision_tpu_torch.ops import kernels  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import _build, flash_attention  # noqa: E402

HEADERS = ("tc_attention_bwd.cuh", "tf32x3_attention.cuh")
KERNELS = ("attention_bwd_", "attention_x3_kernel", "attention_core_kernelIfLi64Ef")
BWD_SHAPES = ((128, 197, 12), (64, 257, 16), (16, 577, 16))
CALLS = 10
SCALE = 0.125


def build(variant: str, out_dir: Path):
    """Start the compile of ``attention.cu`` for ``variant``; returns (process, library path)."""
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
    lib = out_dir / "libattention.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src), "-o", str(lib),
           str(src / "attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def sass_opcodes(lib: Path):
    """{mangled kernel name: {opcode: static count}} of a library's SASS (opcode without its modifiers)."""
    dump = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = {}
        elif name is not None:
            op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if op:
                counts[name][op.group(1)] = counts[name].get(op.group(1), 0) + 1
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


def launches_ms(fn, chain: int, calls: int = 3, tries: int = 5):
    """[(kernel, mean device ms)] of the ``chain`` launches of a call of ``fn`` from ``torch.profiler``'s kernel
    intervals over ``calls`` calls after one more, or None if no window saw them all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(1 + calls):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name.split("(")[0].replace("void ", ""))
                       for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if len(spans) >= calls * chain:
            spans = spans[-calls * chain:]
            return [(spans[i][2], sum(spans[c * chain + i][1] - spans[c * chain + i][0] for c in range(calls))
                     / calls / 1e3) for i in range(chain)]
    return None


def f64_err(out, ref64) -> float:
    return float((out.double() - ref64).abs().max() / ref64.abs().max())


def main() -> int:
    variants = sys.argv[1:] or ["base"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    root = REPO / "build" / "flash_ab"
    jobs = {v: build(v, root / f"v{i}") for i, v in enumerate(dict.fromkeys(variants))}
    libs = {}
    for v, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{v}: nvcc failed on attention.cu\n{log}")
        name = ""
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            name = found.group(1) if found else name
            if any(k in name for k in KERNELS) and ("Used" in line or "spill" in line):
                print(f"{v}: {name}: {line.strip()}")
            if "wgmma" in line.lower() and "warning" in line.lower():
                print(f"{v}: {line.strip()}")
        opcodes = {fn: c for fn, c in sass_opcodes(lib).items() if any(k in fn for k in KERNELS)}
        counts = {fn: c.get("HGMMA", 0) for fn, c in opcodes.items()}
        print(f"{v}: HGMMA in SASS: {counts}")
        for fn, c in opcodes.items():
            top = sorted(c.items(), key=lambda kv: -kv[1])[:24]
            print(f"{v}: {fn[:40]}: {sum(c.values())} instructions, most frequent {top}")
        if not all(c > 0 for fn, c in counts.items() if "attention_core_kernel" not in fn):
            raise AssertionError(f"{v}: a tensor-core kernel without HGMMA")
        libs[v] = lib

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    bwd_cases = []
    for n, s, h in BWD_SHAPES:
        q, k, v = (normal((n, s, h, 64), bf16) for _ in range(3))
        do, o = normal((n, h, s, 64), bf16), torch.empty((n, s, h, 64), dtype=bf16, device=dev)
        with _dtype.float32_products(bf16):
            want = (*flash_attention.attention_core_backward_plain(q, k, v, do, SCALE),
                    flash_attention.flash_mha_plain(q, k, v, SCALE).transpose(1, 2).contiguous())
        qh, kh, vh = (t.permute(0, 2, 1, 3).detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, scale=SCALE)

        def sdpa_bwd(out=out, qh=qh, kh=kh, vh=vh, do=do):  # the backward's kernels alone: the graph is kept
            torch.autograd.grad(out, (qh, kh, vh), do, retain_graph=True)

        library = ms(sdpa_bwd)
        print(f"Kernel B ({n}, {s}, {h}, 64): SDPA's backward {library:.4f} ms ({card})", flush=True)
        bwd_cases.append(((n, s, h), (q, k, v, do, o), want, library))
        del qh, kh, vh, out

    q, k, v = (normal((64, 197, 12, 64), torch.float32) for _ in range(3))
    twin = flash_attention.flash_mha_plain(q, k, v, SCALE)
    ref64 = torch.einsum("nhqk,nkhd->nhqd", torch.softmax(
        torch.einsum("nqhd,nkhd->nhqk", q.double(), k.double()) * SCALE, dim=-1), v.double())
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    with _dtype.full_float32():
        sdpa_f32 = ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=SCALE))
    print(f"flash_mha f32 (64, 197, 12, 64): SDPA f32 {sdpa_f32:.4f} ms ({card})", flush=True)

    saved = _build.load
    results, first_bits = [], {}  # Kernel B's outputs under the first variant, by shape
    try:
        for variant in variants + variants[::-1]:
            _build.load = lambda stem, lib=libs[variant]: ctypes.CDLL(str(lib))
            flash_attention._c_lib = None
            reading = {"variant": variant,
                       "kernels": {name: flash_attention.kernel_info(name) for name in flash_attention.KERNEL_INFO}}
            print(f"{variant}: {reading['kernels']}")
            for (n, s, h), (q_, k_, v_, do, o), want, library in bwd_cases:
                got = kernels.attention_core_backward(q_, k_, v_, do, SCALE, o=o)
                outs = (*got, o.clone())
                first = first_bits.setdefault((n, s, h), outs)
                errs, agrees = [], True
                for a, b in zip((*got, o), want):
                    err = (a.float() - b.float()).abs()
                    agrees = agrees and bool((err <= 2e-2 * (1 + b.float().abs())).all())
                    errs.append(float(err.max()))
                if not agrees and variant == "base":
                    raise AssertionError(f"{variant}: Kernel B ({n}, {s}, {h}) disagrees, max |err| {errs}")
                agrees = agrees and all(torch.equal(a, b) for a, b in
                                        zip(got, kernels.attention_core_backward(q_, k_, v_, do, SCALE)))
                if not agrees and variant == "base":
                    raise AssertionError(f"{variant}: Kernel B ({n}, {s}, {h}): two calls differ")

                def call(q_=q_, k_=k_, v_=v_, do=do, o=o):
                    kernels.attention_core_backward(q_, k_, v_, do, SCALE, o=o)

                reading[f"Kernel B ({n}, {s}, {h}, 64)"] = r = {
                    "ms": ms(call), "launches_ms": launches_ms(call, 2), "library_ms": library, "max_abs_err": errs,
                    "agrees": agrees,
                    "bits_of_the_first_variant": all(torch.equal(a, b) for a, b in zip(outs, first))}
                print(f"{variant}: Kernel B ({n}, {s}, {h}, 64): {r} ({card})", flush=True)
            out = kernels.flash_mha(q, k, v, SCALE)
            err = (out - twin).abs()
            if not bool((err <= 2e-4 * (1 + twin.abs())).all()) or not torch.equal(kernels.flash_mha(q, k, v, SCALE),
                                                                                  out):
                raise AssertionError(f"{variant}: flash_mha f32 disagrees with its twin ({float(err.max())}) or "
                                     f"differs between calls")
            scalar = flash_attention._flash_mha_scalar(q, k, v, SCALE)
            r = {"ms": ms(lambda: kernels.flash_mha(q, k, v, SCALE)),
                 "scalar_core_ms": ms(lambda: flash_attention._flash_mha_scalar(q, k, v, SCALE)),
                 "library_ms": sdpa_f32, "max_abs_err": float(err.max()), "f64_err": f64_err(out, ref64),
                 "scalar_f64_err": f64_err(scalar, ref64)}
            reading["flash_mha f32 (64, 197, 12, 64)"] = r
            print(f"{variant}: flash_mha f32 (64, 197, 12, 64): {r} ({card})", flush=True)
            if r["f64_err"] > 2 * r["scalar_f64_err"]:
                raise AssertionError(f"{variant}: flash_mha f32 strays from float64 past twice the scalar core")
            results.append(reading)
    finally:
        _build.load = saved
        flash_attention._c_lib = None
    print(json.dumps({"card": card, "readings": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
