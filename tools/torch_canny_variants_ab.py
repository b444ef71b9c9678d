#!/usr/bin/env python3
"""Time Canny's two kernels (``csrc/stencil.cu``: ``canny_strip_kernel<5>``, ``hysteresis_bits_kernel<4>`` and
``<8>``), the blur (``blur_strip_kernel<5, C>``) and blur + Sobel (``blur_sobel_strip_kernel<5>``) under other
constants of ``stencil.cu``, in turns on one card, and check the bits.

    python3 tools/torch_canny_variants_ab.py [VARIANT ...] [--rounds N] [--json PATH]

A VARIANT is ``NAME=VALUE[,NAME=VALUE...]`` over the ``constexpr int`` constants of ``stencil.cu``
(``CS_TILE_H``, ``CS_MIN_BLOCKS``, ``CS_RING``, ``HY_TILE_H``, ``BL_TILE_H``, ``BL_MIN_BLOCKS``, ``BS_TILE_H``,
``BS_MIN_BLOCKS``, ``BS_WIDE_K``, ...), or ``base`` for the file as it is.  Each is a copy of ``stencil.cu`` under
``build/canny_variants/`` with only those instantiations (Canny at K 5, the sweeps at 4 and 8, Harris, the blur and
blur + Sobel at K 5), all built in parallel with the
flags of ``_build``; the registers and spills of the strip kernels and Canny's SASS instructions by opcode
(``cuobjdump``) are printed.  On the headline scene (8 x 1080 x 1920, thresholds 0.1/0.2) every variant's class
map and swept maps, its blur there and of 64 x 480 x 640 x 3 frames, and its blur + Sobel there and of one
512 x 512 map, must equal the twins' bit for bit; then ``cvt_canny_stage1``, ``cvt_hysteresis_sweeps``,
``cvt_gaussian_blur`` and ``cvt_blur_sobel`` of each are timed with CUDA events,
``--rounds`` rounds of 20 launches, the order of the variants reversed every other round, and the least of each
printed (blur + Sobel's 512 x 512 launch also alone, from the profiler's device interval: the events time the
host's launches there) with the card's name and power limit, one line a variant, and a JSON line
(also written to ``--json``).  Exits 1 if a variant fails to build or to keep the bits.  No test imports it.
Default: ``base CS_MIN_BLOCKS=1 CS_MIN_BLOCKS=6 CS_TILE_H=48 HY_TILE_H=12 HY_TILE_H=32``.
"""

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from chip_smoke import scene  # noqa: E402
from tools.torch_blur_nms_ab import launches_apart  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import _build, stencil  # noqa: E402

DEFAULT = ["base", "CS_MIN_BLOCKS=1", "CS_MIN_BLOCKS=6", "CS_TILE_H=48", "HY_TILE_H=12", "HY_TILE_H=32"]
KEEP = {"CVT_CANNY_K": {5}, "CVT_HYST_S": {4, 8}, "CVT_HARRIS_K": {5}, "CVT_BLUR_K": {5},  # what a variant builds
        "CVT_BLUR_SOBEL_K": {5}}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def variant_source(spec: str) -> str:
    """stencil.cu with the constants of ``spec`` set and only the instantiations of ``KEEP``."""
    src = (_build.CSRC_DIR / "stencil.cu").read_text()
    if spec != "base":
        for pair in spec.split(","):
            name, value = pair.split("=")
            src, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {int(value)};", src)
            if n != 1:
                raise ValueError(f"{name}: not one constexpr int of stencil.cu")
    lines = []
    for line in src.splitlines():
        for macro, keep in KEEP.items():
            if re.fullmatch(rf"\s+({macro}\(\d+\)\s*)+", line):
                line = "    " + " ".join(f"{macro}({k})" for k in map(int, re.findall(rf"{macro}\((\d+)\)", line))
                                         if k in keep)
        lines.append(line)
    return "\n".join(lines) + "\n"


def build(variants):
    """{spec: (CDLL or None, ptxas lines of the strip kernel)}, built in parallel."""
    out = REPO / "build" / "canny_variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n, spec in enumerate(variants):
        src = out / f"v{n}.cu"
        src.write_text(variant_source(spec))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS["stencil"], "-Xptxas", "-v", "-I",
               str(_build.CSRC_DIR), "-o", str(out / f"v{n}.so"), str(src)]
        jobs[spec] = (out / f"v{n}.so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                           text=True))
    built = {}
    for spec, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        fn, lines = "", []
        for line in log.splitlines():
            named = re.search(r"Compiling entry function '(\S+)'", line)
            fn = named.group(1) if named else fn
            if ("Used" in line or "spill" in line) and any(k in fn for k in ("canny_strip_kernel", "blur_strip_kernel",
                                                                              "blur_sobel_strip_kernel")):
                channels = re.search(r"ILi5ELi(\d)E", fn)
                kernel = (f"blur C {channels.group(1)}" if channels else
                          "blur_sobel" if "blur_sobel" in fn else "canny")
                lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        if proc.returncode != 0:
            print(f"{spec}: nvcc failed\n{log}", file=sys.stderr)
            built[spec] = (None, lines)
            continue
        lines.append(sass_opcodes(lib))
        built[spec] = (ctypes.CDLL(str(lib)), lines)
        for fn_name, args in (("cvt_canny_stage1", [P, P, I, I, I, P, I, F, F, I, I, P]),
                              ("cvt_hysteresis_sweeps", [P, P, I, I, I, I, P, P, I, P]),
                              ("cvt_gaussian_blur", [P, P, I, I, I, I, P, I, I, P]),
                              ("cvt_blur_sobel", [P, P, I, I, I, P, I, I, P])):
            getattr(built[spec][0], fn_name).argtypes = args
    return built


def sass_opcodes(lib: Path) -> dict:
    """{opcode: count} of canny_strip_kernel<5> in ``lib``'s SASS, most frequent first."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    ops, fn = collections.Counter(), ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line
        elif "canny_strip_kernel" in fn:
            op = re.match(r"\s+/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]+)", line)
            if op:
                ops[op.group(2)] += 1
    return dict(ops.most_common())


def device_ms(fn, calls: int = 20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=DEFAULT)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default=str(REPO / "build" / "canny_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_canny_variants_ab: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    built = build(args.variants)
    libs = {spec: lib for spec, (lib, _) in built.items() if lib is not None}
    faults = [f"{spec}: nvcc failed" for spec, (lib, _) in built.items() if lib is None]

    maps = torch.from_numpy(scene(1080, 1920, 8)).cuda()[..., 0].contiguous()
    n, h, w = maps.shape
    taps = stencil._c_taps(stencil.gaussian_taps(5, 1.4))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    twin_cls = stencil.canny_stage1_plain(maps, stencil.gaussian_taps(5, 1.4), 0.1, 0.2)
    twin_swept = {s: stencil.hysteresis_sweeps_plain(twin_cls, s) for s in (4, 8)}
    cls = {spec: torch.empty_like(twin_cls) for spec in libs}
    swept = {spec: torch.empty_like(twin_cls) for spec in libs}

    def canny(spec):
        err = libs[spec].cvt_canny_stage1(maps.data_ptr(), cls[spec].data_ptr(), n, h, w, taps, 5, 0.1, 0.2, 0, sms,
                                          stream)
        assert err == 0, err

    def sweeps(spec, s):
        err = libs[spec].cvt_hysteresis_sweeps(twin_cls.data_ptr(), swept[spec].data_ptr(), n, h, w, s, None, None,
                                               sms, stream)
        assert err == 0, err

    # the blur (K 5, sigma 1.5) of the scene (C 1) and of 64 RGB 640 x 480 frames (C 3), NHWC as they lie
    frames = {1: maps[..., None], 3: torch.rand((64, 480, 640, 3), generator=torch.Generator("cuda").manual_seed(0),
                                                device="cuda")}
    blur_taps = stencil._c_taps(stencil.gaussian_taps(5, 1.5))
    blurred = {spec: {c: torch.empty_like(x) for c, x in frames.items()} for spec in libs}
    twin_blur = {}
    for c, x in frames.items():
        m, restore = stencil._as_nhw(x)
        twin_blur[c] = restore(stencil.fused_gaussian_blur_plain(m, stencil.gaussian_taps(5, 1.5)))

    def blur(spec, c):
        x = frames[c]
        err = libs[spec].cvt_gaussian_blur(x.data_ptr(), blurred[spec][c].data_ptr(), *x.shape[:3], c, blur_taps, 5,
                                           sms, stream)
        assert err == 0, err

    # blur + Sobel (K 5, sigma 1.5) of the scene and of one 512 x 512 map
    bs_maps = {"1080p": maps, "512": torch.rand((1, 512, 512), generator=torch.Generator("cuda").manual_seed(1),
                                                 device="cuda")}
    bs_out = {spec: {k: torch.empty_like(m) for k, m in bs_maps.items()} for spec in libs}
    twin_bs = {k: stencil.fused_blur_sobel_plain(m, stencil.gaussian_taps(5, 1.5)) for k, m in bs_maps.items()}

    def blur_sobel(spec, k):
        m = bs_maps[k]
        err = libs[spec].cvt_blur_sobel(m.data_ptr(), bs_out[spec][k].data_ptr(), *m.shape, blur_taps, 5, sms, stream)
        assert err == 0, err

    for spec in libs:
        for k in bs_maps:
            blur_sobel(spec, k)
        if not all(torch.equal(bs_out[spec][k], twin_bs[k]) for k in bs_maps):
            faults.append(f"{spec}: blur + Sobel's bits differ from the twin's")
        canny(spec)
        same = torch.equal(cls[spec], twin_cls)
        for s in (4, 8):
            sweeps(spec, s)
            same = same and torch.equal(swept[spec], twin_swept[s])
        for c in frames:
            blur(spec, c)
            same = same and torch.equal(blurred[spec][c], twin_blur[c])
        if not same:
            faults.append(f"{spec}: bits differ from the twins'")
    times = {spec: {"canny_ms": [], "sweeps4_ms": [], "sweeps8_ms": [], "blur_c1_ms": [], "blur_c3_ms": [],
                    "blur_sobel_1080p_ms": [], "blur_sobel_512_ms": []} for spec in libs}
    for r in range(args.rounds):
        for spec in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
            times[spec]["canny_ms"].append(device_ms(lambda: canny(spec)))
            times[spec]["sweeps4_ms"].append(device_ms(lambda: sweeps(spec, 4)))
            times[spec]["sweeps8_ms"].append(device_ms(lambda: sweeps(spec, 8)))
            for c in frames:
                times[spec][f"blur_c{c}_ms"].append(device_ms(lambda: blur(spec, c)))
            for k in bs_maps:
                times[spec][f"blur_sobel_{k}_ms"].append(device_ms(lambda: blur_sobel(spec, k)))
    rows = []
    for spec in libs:
        # the 512 x 512 map's launch alone (the profiler's device interval): the events above time the host's
        # launches there
        kernel_512 = [ms for name, _, ms in launches_apart(lambda: blur_sobel(spec, "512"))
                      if "blur_sobel_strip_kernel" in name]
        row = dict(variant=spec, ptxas=built[spec][1], **{k: min(v) for k, v in times[spec].items()},
                   blur_sobel_512_kernel_ms=kernel_512[0] if kernel_512 else None, rounds=times[spec])
        rows.append(row)
        print(f"{spec}: canny_stage1 {row['canny_ms']:.4f} ms, hysteresis x4 {row['sweeps4_ms']:.4f} ms, "
              f"x8 {row['sweeps8_ms']:.4f} ms, blur 8x1080x1920x1 {row['blur_c1_ms']:.4f} ms, 64x480x640x3 "
              f"{row['blur_c3_ms']:.4f} ms, blur + Sobel 8x1080x1920 {row['blur_sobel_1080p_ms']:.4f} ms, 512x512 "
              f"{row['blur_sobel_512_ms']:.4f} ms (least of {args.rounds} rounds; the kernel alone "
              f"{row['blur_sobel_512_kernel_ms']} ms); strip kernels {built[spec][1]}")
    summary = {"card": card, "variants": rows, "failures": faults}
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if faults:
        print(f"FAILED: {faults}", file=sys.stderr)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
