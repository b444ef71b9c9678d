#!/usr/bin/env python3
"""Build, check and time the attention cores on the tensor cores
(``csrc/tc_attention.cuh:attention_tc_kernel``, ``csrc/swin_attention.cu:window_tc_kernel``
and the float32 window core ``window_x3_kernel``) under other constants, one variant
after another on one card.

    python3 tools/torch_attention_core_ab.py [--only TEXT] [VARIANT ...]

A VARIANT is ``NAME=VALUE[,NAME=VALUE...]`` over the ``constexpr int`` constants of
``tc_attention.cuh`` (``ATC_STAGES``) and ``swin_attention.cu`` (``WX_MIN_BLOCKS``, ...),
``base`` for the files as they are, or the root
of another tree of this repository (an unpacked ``git archive`` of an older commit, say
``build/parent``: its ``cpu_vision_tpu_torch/csrc/`` is built, with this tree's wrappers).
Each is built from a copy of ``csrc/`` under ``build/attention_ab/`` (``attention.cu``,
``transformer_block.cu``, ``int8_transformer.cu`` and ``swin_attention.cu``, with the
flags of ``_build``, all compiles in parallel); the cores' ``ptxas`` lines (registers,
spills, ``wgmma`` notes) and the SASS ``HGMMA`` count of each core's instantiation are
printed, and it fails if one has none or if a bf16 head-dim-64 ``attention_core_kernel``
or a bf16 ``window_core_kernel`` is left.  Then, on the bf16 main paths' shapes, each
wrapper is held against its twin within ``2e-2·(1 + |twin|)`` and timed with CUDA
events: ``flash_mha`` at ViT-B/16 b256 (256, 197, 12, 64), its core alone, beside
``F.scaled_dot_product_attention`` on the same tensors; ``attention_block`` and
``attention_block_int8`` at (256, 197, 768); ``window_attention_block`` at Swin-T b256's
first stage (16384 windows of 49 tokens, C 96, shifted mask) and Swin-v2-T b64's (4096
windows of 64, v2), in bf16 and, held within ``2e-4·(1 + |twin|)`` and no further from
the block in float64 than twice the twin (``f64_err``, ``twin_f64_err``), in float32 with
and without the mask, and there again with the projections made exact (channel
permutations, no biases: the core's own error beside the twin's); for the blocks the
core's own launch is timed apart from
``torch.profiler``'s kernel intervals.  ``--only TEXT`` keeps the cases whose name holds
TEXT.  The variants run in the order given and then in reverse (name one twice to see
the spread).  Default: ``base ATC_STAGES=3``.
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

from cpu_vision_tpu_torch import models  # noqa: E402
from cpu_vision_tpu_torch.ops import kernels  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import (_build, flash_attention, int8_transformer, swin_attention,  # noqa: E402
                                              transformer_block)

DEFAULT = ["base", "ATC_STAGES=3"]
STEMS = ("attention", "transformer_block", "int8_transformer", "swin_attention")
MODULES = (flash_attention, transformer_block, int8_transformer, swin_attention)
HEADERS = ("tc_attention.cuh", "swin_attention.cu")
CORES = ("attention_tc_kernel", "window_tc_kernel", "window_x3_kernel")
CALLS = 10
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}


def build(variant: str, out_dir: Path, stems=STEMS):
    """Start the compiles of ``stems`` for ``variant``; returns {stem: (process, library path)}."""
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
    for stem in stems:
        lib = out_dir / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(stem, []), "-Xptxas", "-v", "-I", str(src),
               "-o", str(lib), str(src / f"{stem}.cu")]
        jobs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return jobs


def sass_hgmma(lib: Path):
    """{mangled kernel name: HGMMA instructions} of a library's SASS."""
    dump = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and re.search(r"\bHGMMA\b", line):
            counts[name] += 1
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


def core_ms(fn, calls: int = 3, tries: int = 5):
    """Mean device ms of the core's launch in a call of ``fn`` (``torch.profiler``'s kernel intervals whose name
    holds one of ``CORES``, over ``calls`` calls after one more), or None if no window saw it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(1 + calls):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA and any(c in e.name for c in CORES))
        if len(spans) >= calls:
            return sum(end - start for start, end in spans[-calls:]) / calls / 1e3
    return None


def make_cases(dev, batch: int = 256):
    """[(what, args, wrapper, twin, library call or None, timed, float64 statement or None)] at the bf16 main paths'
    shapes (``batch`` images of ViT-B/16 and Swin-T, ``batch`` / 4 of Swin-v2-T, 64 windows an image) and Swin-T's
    first stage in float32, the inputs from seed 0 on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def normal(shape, dtype=torch.float32, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    cases = []
    q, k, v = (normal((batch, 197, 12, 64), bf16) for _ in range(3))
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    cases.append((f"flash_mha ({batch}, 197, 12, 64)", (q, k, v, 0.125), kernels.flash_mha,
                  flash_attention.flash_mha_plain, lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), True,
                  None))
    for s in (1, 65):  # one query and key; one real key in the second tile
        qs, ks, vs = (normal((3, s, 12, 64), bf16) for _ in range(3))
        cases.append((f"flash_mha (3, {s}, 12, 64)", (qs, ks, vs, 0.125), kernels.flash_mha,
                      flash_attention.flash_mha_plain, None, False, None))
    d = 768
    ln = (normal((d,), std=0.2, mean=1.0), normal((d,), std=0.1))
    x = normal((batch, 197, d), bf16)
    attn = (x, *ln, normal((d, 3 * d), bf16, d ** -0.5), normal((3 * d,), std=0.1), normal((d, d), bf16, d ** -0.5),
            normal((d,), std=0.1), 12, 0.125, 1e-6)
    cases.append((f"attention_block ({batch}, 197, 768)", attn, kernels.attention_block,
                  transformer_block.attention_block_plain, None, True, None))
    a1, ao = normal((d,), std=0.005, mean=0.02), normal((d,), std=0.005, mean=0.02)
    qw_qkv, s_qkv = kernels.quantize_weight(normal((d, 3 * d), std=d ** -0.5) * a1[:, None])
    qw_o, s_o = kernels.quantize_weight(normal((d, d), std=d ** -0.5) * ao[:, None])
    attn8 = (x, *ln, qw_qkv, s_qkv, normal((3 * d,), std=0.1), qw_o, s_o, normal((d,), std=0.1), a1, ao, 12, 0.125, 1e-6)
    cases.append((f"attention_block_int8 ({batch}, 197, 768)", attn8, kernels.attention_block_int8,
                  int8_transformer.attention_block_int8_plain, None, True, None))
    for nw, s, c, v2, dtype, masked in ((64 * batch, 49, 96, False, bf16, True), (64 * (batch // 4), 64, 96, True, bf16, True),
                                        (64 * batch, 49, 96, False, torch.float32, True),
                                        (64 * batch, 49, 96, False, torch.float32, False)):
        heads, ws, nw_img = c // 32, int(round(s ** 0.5)), 64
        side = 8 * ws
        mask = models.swin._shift_mask(side, side, ws, ws // 2, ws // 2).to(dev) if masked else None
        win = (normal((nw, s, c), dtype), normal((c,), std=0.2, mean=1.0), normal((c,), std=0.1),
               normal((c, 3 * c), dtype, c ** -0.5), normal((3 * c,), std=0.1), normal((c, c), dtype, c ** -0.5),
               normal((c,), std=0.1), normal((heads, s, s), std=0.3), mask,
               normal((heads,), std=0.5, mean=2.3) if v2 else None, heads, 32 ** -0.5, 1e-5, v2, nw_img)
        f64 = swin_attention._window_attention_block_f64 if dtype == torch.float32 else None
        cases.append((f"window_attention_block ({nw}, {s}, {c}) v2={v2} {str(dtype)[6:]} masked={masked}", win,
                      kernels.window_attention_block, swin_attention.window_attention_block_plain, None, True, f64))
        if dtype == torch.float32:
            # the core's own error: the projections exact (q = 2 LN(x), k, v and the output projection permutations of
            # the channels, no biases: every product a single term), so only the core and the LayerNorm round
            eye = torch.eye(c, device=dev)
            perm = [eye[torch.randperm(c, generator=torch.Generator().manual_seed(i))].to(dev) for i in range(4)]
            exact = (*win[:3], torch.cat([2.0 * perm[0], perm[1], perm[2]], 1), torch.zeros(3 * c, device=dev), perm[3],
                     torch.zeros(c, device=dev), *win[7:])
            cases.append((f"window_attention_block ({nw}, {s}, {c}) v2={v2} float32 masked={masked} exact projections",
                          exact, kernels.window_attention_block, swin_attention.window_attention_block_plain, None,
                          True, f64))
    return cases


def main() -> int:
    args = sys.argv[1:]
    only = ""
    if args[:1] == ["--only"]:
        only, args = args[1], args[2:]
    variants = args or DEFAULT
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    cases = [case for case in make_cases(torch.device("cuda", 0)) if only in case[0]]
    # the sources the kept cases run: each wrapper's module is the one of its stem
    stems = [stem for stem, module in zip(STEMS, MODULES) if any(case[2].__module__ == module.__name__ for case in cases)]
    root = REPO / "build" / "attention_ab"
    jobs = {v: build(v, root / f"v{i}", stems) for i, v in enumerate(dict.fromkeys(variants))}
    libs = {}
    for v, by_stem in jobs.items():
        libs[v] = {}
        for stem, (proc, lib) in by_stem.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{v}: nvcc failed on {stem}.cu\n{log}")
            name = ""
            for line in log.splitlines():
                found = re.search(r"Compiling entry function '(\S+)'", line)
                if found:
                    name = found.group(1)
                if any(c in name for c in CORES) and ("Used" in line or "spill" in line):
                    print(f"{v}: {stem}: {name}: {line.strip()}")
                if "wgmma" in line.lower() and ("warning" in line.lower() or "serialized" in line):
                    print(f"{v}: {stem}: {line.strip()}")
            counts = sass_hgmma(lib)
            cores = {fn: c for fn, c in counts.items() if any(core in fn for core in CORES)}
            print(f"{v}: {stem}: HGMMA in the cores' SASS: {cores}")
            if not cores or not all(c > 0 for c in cores.values()):
                raise AssertionError(f"{v}: {stem}: a core without HGMMA")
            if any("bfloat16" in fn and (("attention_core_kernel" in fn and "Li64E" in fn) or "window_core_kernel" in fn)
                   for fn in counts):
                raise AssertionError(f"{v}: {stem}: a bf16 instantiation of a scalar core is left")
            libs[v][stem] = lib

    saved = _build.load
    results = []
    try:
        for variant in variants + variants[::-1]:
            _build.load = lambda stem, by=libs[variant]: ctypes.CDLL(str(by[stem]))
            for module in MODULES:
                module._c_lib = None
            row = {"variant": variant}
            for what, args, fn, twin, library, timed, f64 in cases:
                got, want = fn(*args), twin(*args)
                if not torch.equal(fn(*args), got):
                    raise AssertionError(f"{variant}: {what}: two calls differ")
                err = (got.float() - want.float()).abs()
                if not bool((err <= TOL[got.dtype] * (1 + want.float().abs())).all()):
                    raise AssertionError(f"{variant}: {what} disagrees with its twin, max |err| {float(err.max())}")
                far = {}
                if f64 is not None:  # max |a - f64| / max |f64| of the kernel and of the twin (TF32 off)
                    ref64 = f64(*args)
                    far = {k: float((a.double() - ref64).abs().max() / ref64.abs().max())
                           for k, a in (("f64_err", got), ("twin_f64_err", want))}
                    far["f64_held"] = far["f64_err"] <= 2 * far["twin_f64_err"]
                    del ref64
                del got, want
                if not timed:
                    print(f"{variant}: {what}: held, max |err| {float(err.max()):.3e}", flush=True)
                    continue
                row[what] = {"ms": ms(lambda: fn(*args)), "core_ms": core_ms(lambda: fn(*args)),
                             "max_abs_err": float(err.max()), **far}
                if library is not None:
                    row[what]["library_ms"] = ms(library)
                print(f"{variant}: {what}: {row[what]} ({card})", flush=True)
            results.append(row)
    finally:
        _build.load = saved
        for module in MODULES:
            module._c_lib = None
    print(json.dumps({"card": card, "readings": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
