#!/usr/bin/env python3
"""Time ``fused_conv3x3_relu_pool`` (``csrc/conv_block.cu``) and ``harris_response_fused``
(``csrc/stencil.cu``) against an older tree's sources of them, in turns on one card,
and check the bits.

    python3 tools/torch_conv_harris_ab.py --old-tree DIR [--rounds N] [--json PATH]

``--old-tree`` is the root of an older checkout (a ``git archive`` of its
``cpu_vision_tpu_torch`` unpacked under ``build/``): its ``conv_block.cu`` and
``stencil.cu`` are built with its own headers and flags (``--fmad=false`` for
the stencils) and ``-Xptxas -v``.  Its ``cvt_conv3x3_relu_pool`` may lack this
tree's ``ldw`` argument, or take the card's multiprocessors after it, and its
``cvt_harris`` may lack the ``sms`` one (as at commit 43c46c5: told apart by
the source); the older kernels are called through this tree's wrappers, their
libraries put in place of this tree's.

``conv``: the CNN's four main-path stages, 28x28x1 -> 32, 14x14x32 -> 64,
224x224x3 -> 32 and 112x112x32 -> 64 at batch 256 (``ops.cnn_init`` weights of
seed 0, inputs of seed 0, as ``chip_smoke.py``), each stage's kernel and the
older one and the stock composite (``conv2d`` + ``relu`` + ``max_pool2d`` with
TF32 off) timed on the device clock (CUDA events) in ``--rounds`` rounds, the
order reversed every other round; both kernels held to the twin within
``1e-5 + 1e-5·|twin|``, and the float64 error on the first 16 images
(``max|out - f64| / max|f64|``) printed beside the twin's, the new kernel's held
to twice it.  Then the CNN 224x224x3 b256 forward (``ops.cnn_forward``) on
either library, in turns.

``harris``: 32 frames of 1080 x 1920 (2 MP), window 5: the kernel and the
older one must equal the twin bit for bit, and are timed in turns beside
``ops.harris_response`` (stock operators, a composite).

Prints the card's name and power limit, the kernels' registers and spills (a
spill is printed, a serialised ``wgmma`` is a fault),
their SASS opcodes (row 7: ``HGMMA`` with ``.TF32`` and ``FFMA``, the new kernel
with HGMMA and fewer FFMA than HGMMA: no FFMA main loop; Harris: ``LDS`` and
``FFMA``, none of those with ``--fmad=false``), one line a case and a JSON line
of every figure (also written to ``--json``).  Exits 1 if a check fails.  No
test imports it.
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

from cpu_vision_tpu_torch import _dtype, ops  # noqa: E402
from cpu_vision_tpu_torch.ops import kernels  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import _build, conv_block, stencil  # noqa: E402

STEMS = ("conv_block", "stencil")
TF32X3_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S = 495e12 / 3, 67e12, 3.35e12
P, I, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ptxas_lines(label: str, log: str) -> list:
    """Print the registers and spills of the two kernels; the faults, listed (a serialised wgmma)."""
    fn, faults = "", []
    for line in log.splitlines():
        named = re.search(r"Compiling entry function '(\S+)'", line)
        fn = named.group(1) if named else fn
        if "conv3x3" not in fn and "harris" not in fn:
            continue
        if "Used" in line or "spill" in line:
            print(f"  {label}: {fn}: {line.strip()}")
        if "serialized" in line:
            faults.append(f"{label}: {line.strip()}")
    return faults


def opcodes(lib: Path, names: tuple) -> dict:
    """{kernel: {opcode: count}} of the kernels of ``lib`` whose names hold ``conv3x3`` or ``harris``, from
    ``cuobjdump --dump-sass``; ``HGMMA.TF32`` counts the HGMMA whose modifiers hold ``.TF32``."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            fn = name if ("conv3x3" in name or "harris" in name) else None
            if fn is not None:
                out[fn] = {op: 0 for op in names}
        elif fn is not None:
            for op in names:
                base, _, suffix = op.partition(".")
                if re.search(rf"\b{base}(\.\S*)?{re.escape('.' + suffix) if suffix else ''}\b", line):
                    out[fn][op] += 1
    return out


def build_old(tree: Path) -> dict:
    csrc = tree / "cpu_vision_tpu_torch" / "csrc"
    out = REPO / "build" / "conv_harris_ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem in STEMS:
        lib = out / f"lib{stem}_old.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(stem, []), "-Xptxas", "-v", "-I", str(csrc),
               "-o", str(lib), str(csrc / f"{stem}.cu")]
        jobs[stem] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    old = {}
    for stem, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        ptxas_lines("older", log)  # printed, not held: the older build's own
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the older {stem}.cu:\n{log}")
        old[stem] = (ctypes.CDLL(str(lib)), lib)
    conv_src, stencil_src = (csrc / "conv_block.cu").read_text(), (csrc / "stencil.cu").read_text()
    conv_lib, harris_lib = old["conv_block"][0], old["stencil"][0]
    conv_ldw = re.search(r"int cvt_conv3x3_relu_pool\([^)]*int ldw", conv_src) is not None
    conv_sms = re.search(r"int cvt_conv3x3_relu_pool\([^)]*int sms", conv_src) is not None
    harris_sms = re.search(r"int cvt_harris\([^)]*int sms", stencil_src) is not None
    conv_lib.cvt_conv3x3_relu_pool.argtypes = [P] * 4 + [I] * (5 + conv_ldw + conv_sms) + [P]
    harris_lib.cvt_harris.argtypes = [P, P, I, I, I, P, I, FL] + ([I] if harris_sms else []) + [P]

    class Shim:
        """The older library under this tree's C interface (the wrappers pass ldw and sms)."""

        def cvt_conv3x3_relu_pool(self, x, w, b, out, n, h, wd, cin, cout, ldw, stream):
            if not conv_ldw and ldw != cout:
                raise ValueError("the older kernel reads w with row stride cout")
            args = [x, w, b, out, n, h, wd, cin, cout] + ([ldw] if conv_ldw else [])
            if conv_sms:
                args.append(torch.cuda.get_device_properties(0).multi_processor_count)
            return conv_lib.cvt_conv3x3_relu_pool(*args, stream)

        def cvt_harris(self, x, out, n, h, w, taps, ksize, k, sms, stream):
            if harris_sms:
                return harris_lib.cvt_harris(x, out, n, h, w, taps, ksize, k, sms, stream)
            return harris_lib.cvt_harris(x, out, n, h, w, taps, ksize, k, stream)

    return {"shim": Shim(), "libs": {stem: lib for stem, (_, lib) in old.items()}}


class older_kernels:
    """Inside, the wrappers launch the older tree's kernels."""

    def __init__(self, old):
        self.shim = old["shim"]

    def __enter__(self):
        self.saved = (conv_block._c_lib, stencil._lib)
        conv_block._c_lib = self.shim
        stencil._lib = lambda: self.shim

    def __exit__(self, *exc):
        conv_block._c_lib, stencil._lib = self.saved


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


def bound_ms(nbytes: float, nops: float, ops_per_s: float):
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def f64_err(out, ref64):
    return float((out.double() - ref64).abs().max() / ref64.abs().max())


def conv_cases(old, rounds: int, faults: list) -> list:
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    rows, forward = [], {}
    for hw, cin in ((28, 1), (224, 3)):
        params = ops.cnn_init(torch.Generator().manual_seed(0), (hw, hw), cin, (32, 64), 128, 10)
        x = torch.from_numpy(rng.random((256, hw, hw, cin), dtype=np.float32)).to(dev)
        if hw == 224:
            def fwd_new(x=x, params=params):
                return ops.cnn_forward(params, x)

            def fwd_old(x=x, params=params):
                with older_kernels(old):
                    return ops.cnn_forward(params, x)

            with torch.no_grad():
                same = bool(torch.allclose(fwd_new(), fwd_old(), rtol=1e-4, atol=1e-4))
            times = in_turns({"ms": fwd_new, "older_ms": fwd_old}, rounds, 10)
            forward = dict(case="cnn_forward 224x224x3 b256", logits_close_to_older=same,
                           **{k: min(v) for k, v in times.items()}, rounds=times)
            print(f"{forward['case']}: {forward['ms']:.4f} ms, older {forward['older_ms']:.4f} ms; logits within "
                  f"1e-4 of the older kernels' {same}")
            if not same:
                faults.append("cnn_forward 224: logits off the older kernels'")
        for i in (0, 1):
            wgt, bias = params[f"conv{i}"]["w"], params[f"conv{i}"]["b"]
            what = f"conv {list(x.shape)} -> {wgt.shape[3]}"
            new_fn = lambda x=x, wgt=wgt, bias=bias: kernels.fused_conv3x3_relu_pool(x, wgt, bias)  # noqa: E731

            def old_fn(x=x, wgt=wgt, bias=bias):
                with older_kernels(old):
                    return kernels.fused_conv3x3_relu_pool(x, wgt, bias)

            def stock(x=x, wgt=wgt, bias=bias):
                with _dtype.full_float32():
                    y = F.conv2d(x.permute(0, 3, 1, 2), wgt.permute(3, 2, 0, 1), bias, padding=1)
                return F.max_pool2d(torch.relu_(y), 2)

            with torch.no_grad():
                out, older = new_fn(), old_fn()
                twin = conv_block.fused_conv3x3_relu_pool_plain(x, wgt, bias)
                y64 = F.conv2d(x[:16].double().permute(0, 3, 1, 2), wgt.double().permute(3, 2, 0, 1), bias.double(),
                               padding=1)
                ref64 = F.max_pool2d(torch.relu(y64), 2).permute(0, 2, 3, 1)
            errs = {"new": float((out - twin).abs().max()), "older": float((older - twin).abs().max())}
            far = {"new": f64_err(out[:16], ref64), "older": f64_err(older[:16], ref64),
                   "twin": f64_err(twin[:16], ref64)}
            ok = {"new_within_twin_rule": bool(((out - twin).abs() <= 1e-5 + 1e-5 * twin.abs()).all()),
                  "older_within_twin_rule": bool(((older - twin).abs() <= 1e-5 + 1e-5 * twin.abs()).all()),
                  "new_f64_within_twice_twin": far["new"] <= 2 * far["twin"]}
            faults += [f"{what}: {k}" for k, v in ok.items() if not v]
            times = in_turns({"ms": new_fn, "older_ms": old_fn, "library_ms": stock}, rounds, 10)
            nops = x.shape[0] * x.shape[1] * x.shape[2] * 2 * 9 * wgt.shape[2] * wgt.shape[3] + 3 * out.numel()
            nbytes = 4 * (x.numel() + wgt.numel() + bias.numel() + out.numel())
            b_ms, b_by = bound_ms(nbytes, nops, TF32X3_OPS_PER_S)
            row = dict(case=what, max_abs_err=errs, f64_err=far, checks=ok, bound_ms=b_ms, bound_by=b_by,
                       fma_floor_ms=nops / F32_OPS_PER_S * 1e3, **{k: min(v) for k, v in times.items()}, rounds=times)
            print(f"{what}: kernel {row['ms']:.4f} ms, older {row['older_ms']:.4f}, stock composite "
                  f"{row['library_ms']:.4f}; bound {b_ms:.4f} ({b_by}, 165 TFLOP/s), FMA floor "
                  f"{row['fma_floor_ms']:.4f}; max |err| vs twin {errs}; float64 {far}; {ok}")
            rows.append(row)
            x = out
    return rows + [forward]


def harris_cases(old, rounds: int, faults: list) -> list:
    dev = torch.device("cuda", 0)
    maps = torch.from_numpy(np.random.default_rng(0).random((32, 1080, 1920), dtype=np.float32)).to(dev)
    img = maps[..., None]
    new_fn = lambda: kernels.harris_response_fused(img)  # noqa: E731

    def old_fn():
        with older_kernels(old):
            return kernels.harris_response_fused(img)

    twin = stencil.harris_response_fused_plain(maps, stencil.gaussian_taps(5, 1.0), 0.04)
    ok = {"new_equals_twin": torch.equal(new_fn()[..., 0], twin), "older_equals_twin": torch.equal(old_fn()[..., 0], twin)}
    faults += [f"harris: {k}" for k, v in ok.items() if not v]
    times = in_turns({"ms": new_fn, "older_ms": old_fn, "library_ms": lambda: ops.harris_response(img)}, rounds, 10)
    px = maps.numel()
    b_ms, b_by = bound_ms(px * 8, px * (18 + 3 + 3 * 18 + 7), F32_OPS_PER_S)
    row = dict(case="harris 32x1080x1920 window 5", checks=ok, bound_ms=b_ms, bound_by=b_by,
               **{k: min(v) for k, v in times.items()}, rounds=times)
    print(f"{row['case']}: kernel {row['ms']:.4f} ms, older {row['older_ms']:.4f}, ops.harris_response (composite) "
          f"{row['library_ms']:.4f}; bound {b_ms:.4f} ({b_by}); {ok}")
    return [row]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-tree", required=True, help="root of the older checkout, under build/")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default=str(REPO / "build" / "conv_harris_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_conv_harris_ab: no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    logs = _build.build(ptxas_verbose=True)
    faults = []
    for stem in STEMS:
        faults += ptxas_lines("current", logs.get(stem, ""))
    old = build_old(Path(args.old_tree).resolve())
    names = ("HGMMA.TF32", "FFMA", "LDS")
    sass = {"current": {stem: opcodes(_build._build_dir() / f"lib{stem}.so", names) for stem in STEMS},
            "older": {stem: opcodes(lib, names) for stem, lib in old["libs"].items()}}
    for label, by_stem in sass.items():
        for stem, fns in by_stem.items():
            print(f"  {label} {stem}: {fns}")
    conv = {fn: c for fn, c in sass["current"]["conv_block"].items()}
    if not conv or not all(0 < c["HGMMA.TF32"] and c["FFMA"] < c["HGMMA.TF32"] for c in conv.values()):
        faults.append(f"conv_block: an instantiation without HGMMA .TF32, or an FFMA loop: {conv}")
    results = conv_cases(old, args.rounds, faults) + harris_cases(old, args.rounds, faults)
    summary = {"card": card, "sass": sass, "cases": results, "failures": faults}
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if faults:
        print(f"FAILED: {faults}", file=sys.stderr)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
