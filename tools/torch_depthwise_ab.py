#!/usr/bin/env python3
"""Time the depthwise convolution kernel (``csrc/depthwise.cu``) against an older
source of it and against cuDNN, in turns on one card, and check the bits.

    python3 tools/torch_depthwise_ab.py [--old PATH] [--rounds N]

``--old`` is the older ``depthwise.cu`` (default: ``git show 88346ce:...``, the
first design, one 8 x 16 x 32 tile a block); it is built with this tree's
headers and ``_build``'s flags beside the current source, both with ``-Xptxas
-v`` (registers and spills printed; a spill fails the run after the timings).  Then, at
ConvNeXt-T's four stage shapes at batch 256 (7 x 7 taps), in float32 and
bfloat16, and for the backward's dx (the same kernel on flipped taps, no bias)
in bfloat16: the current kernel's output must equal the older one's bit for
bit (both sum each tap as an f32 fused multiply-add in (i, j) order and add the
bias last) and its plain twin's within the wrapper's rule, two calls must give
the same bits, and each of the current kernel, the older one and
``F.conv2d(groups=C)`` (cuDNN, TF32 off; for dx
``aten.convolution_backward``) is timed on the device clock (CUDA events, 20
calls) in ``--rounds`` rounds taken in turn.  Prints the current kernel's tile,
threads, shared memory, blocks an SM and registers
(``depthwise.kernel_info``), the card's name and power limit, one line a case,
and a JSON line of every figure, also written to
``build/depthwise_ab.json``.  Exits 1 if a check fails.  No test imports it.
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

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from cpu_vision_tpu_torch import _dtype  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import _build, depthwise  # noqa: E402

OLD_COMMIT = "88346ce"
OLD_PATH = "cpu_vision_tpu_torch/csrc/depthwise.cu"
STAGES = ((96, 56), (192, 28), (384, 14), (768, 7))  # ConvNeXt-T's widths and maps at 224x224
CALLS = 20


def old_source(path):
    if path:
        return Path(path).read_text()
    return subprocess.run(["git", "-C", str(REPO), "show", f"{OLD_COMMIT}:{OLD_PATH}"], capture_output=True, text=True,
                          check=True).stdout


def build_old(text: str, spills: list) -> ctypes.CDLL:
    out = REPO / "build" / "depthwise_ab"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "depthwise_old.cu", out / "libdepthwise_old.so"
    src.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC_DIR), "-o", str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    spills += print_ptxas("old", done.stdout + done.stderr)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on the older source:\n{done.stdout}{done.stderr}")
    lib_ = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib_.cvt_depthwise_conv2d.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib_.cvt_depthwise_conv2d.restype = ctypes.c_int
    return lib_


def print_ptxas(label: str, log: str) -> list:
    """Print each depthwise_kernel instantiation's registers and spills; the spills, listed."""
    fn, spills = "", []
    for line in log.splitlines():
        named = re.search(r"Compiling entry function '(\S+)'", line)
        fn = named.group(1) if named else fn
        if "depthwise_kernel" in fn and ("Used" in line or "spill" in line):
            kind = re.search(r"depthwise_kernelI(\w+?)Li(\d)E", fn)
            print(f"  {label}: {kind.groups() if kind else fn}: {line.strip()}")
            if "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line:
                spills.append(f"{label}: {fn} spills: {line.strip()}")
    return spills


def device_ms(fn) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=None, help="the older depthwise.cu (default: git show of the first design)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_depthwise_ab: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    text = old_source(args.old)
    spills = print_ptxas("current", _build.build(ptxas_verbose=True).get("depthwise", ""))
    old = build_old(text, spills)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    failures, results = list(spills), []

    def old_call(x, taps, bias):
        out = torch.empty_like(x)
        n, h, w, c = x.shape
        err = old.cvt_depthwise_conv2d(x.data_ptr(), taps.data_ptr(), None if bias is None else bias.data_ptr(),
                                       out.data_ptr(), n, h, w, c, taps.shape[0], int(x.dtype == torch.bfloat16),
                                       torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"older kernel: CUDA error {err}")
        return out

    cases = [(dtype, c, side, False) for dtype in (torch.float32, torch.bfloat16) for c, side in STAGES]
    cases += [(torch.bfloat16, c, side, True) for c, side in STAGES]
    for dtype, c, side, dx in cases:
        shape = (256, side, side, c)
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        taps = (torch.randn((7, 7, c), generator=gen, device=dev) / 7).to(dtype)
        bias = None if dx else torch.randn(c, generator=gen, device=dev)
        if dx:  # the backward's call: the gradient through the flipped taps (depthwise.py:_backward)
            taps = taps.flip(0, 1).contiguous()
        new_fn = lambda: depthwise._kernel(x, taps, bias)  # noqa: E731
        old_fn = lambda: old_call(x, taps, bias)  # noqa: E731
        weight = (taps.flip(0, 1) if dx else taps).permute(2, 0, 1)[:, None].contiguous()
        nchw = x.permute(0, 3, 1, 2)

        def library():
            with _dtype.full_float32():
                if dx:
                    return torch.ops.aten.convolution_backward(nchw, nchw, weight, None, [1, 1], [3, 3], [1, 1], False,
                                                               [0, 0], c, [True, False, False])[0]
                return F.conv2d(nchw, weight, bias.to(dtype), padding=3, groups=c)

        out = new_fn()
        what = f"{'dx ' if dx else ''}{list(shape)} {str(dtype).replace('torch.', '')}"
        checks = {"bits_of_older": torch.equal(out, old_fn()), "same_bits_twice": torch.equal(out, new_fn())}
        ref = depthwise.depthwise_conv2d_plain(x, taps, bias)
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7  # depthwise.py: 1e-5 + 1e-5 |twin|; one bf16 step
        err = (out.float() - ref.float()).abs()
        checks["twin"] = bool((err <= tol + tol * ref.float().abs()).all())
        lib_err = float((out.float() - library().permute(0, 2, 3, 1).float()).abs().max())
        times = {"ms": [], "older_ms": [], "library_ms": []}
        for _ in range(args.rounds):
            times["ms"].append(device_ms(new_fn))
            times["older_ms"].append(device_ms(old_fn))
            times["library_ms"].append(device_ms(library))
        info = depthwise.kernel_info(x, 7)
        row = dict(case=what, dx=dx, **{k: min(v) for k, v in times.items()}, rounds=times, max_abs_err=float(err.max()),
                   library_max_abs_err=lib_err, checks=checks, kernel_info=info)
        results.append(row)
        print(f"{what}: kernel {row['ms']:.4f} ms, older {row['older_ms']:.4f}, "
              f"{'aten.convolution_backward' if dx else 'F.conv2d'} {row['library_ms']:.4f} (least of {args.rounds} "
              f"rounds of {CALLS}); max|a - twin| {row['max_abs_err']:.3e}, vs library {lib_err:.3e}; {checks}; {info}")
        failures += [f"{what}: {k}" for k, ok in checks.items() if not ok]
        del x, taps, out, ref, err
    summary = {"card": card, "cases": results, "failures": failures}
    (REPO / "build").mkdir(exist_ok=True)
    (REPO / "build" / "depthwise_ab.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if failures:
        print(f"FAILED: {failures}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
