#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cpu_vision_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``cpu_vision_tpu_torch/csrc/``, then:

1. drives the main paths through the public entry points, each with the
   kernels' launch counts set to 0 just before it and read just after:
   ``ops.canny`` on the synthetic 1080p scene at batch 8 (the headline
   benchmark's workload), ``ops.kernels.fused_blur_sobel`` on one 512x512
   image and ``ops.kernels.harris_response_fused`` on 2 MP images at
   batch 32, and checks their outputs against the op-by-op paths;
2. holds every kernel against its plain PyTorch twin on the card at those
   shapes and times both with CUDA events;
3. prints one JSON line of per-kernel results, then, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
Without a CUDA card it exits 1 at once.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the
# tensor cores.  A card below its 700 W limit runs slower than this bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Kernel vs twin: class maps must be equal; f32 maps must agree within
# F32_ATOL + F32_RTOL * |twin| (both run the same f32 operations in the
# same order without FMA, so the expected difference is 0).
F32_ATOL, F32_RTOL = 1e-5, 1e-6
STENCIL = "cpu_vision_tpu_torch/csrc/stencil.cu"
PALLAS = "cpu_vision_tpu/ops/pallas/stencil.py"


def scene(h: int, w: int, batch: int) -> np.ndarray:
    """Synthetic scene with realistic edge density: blocks, a disc, a smooth
    gradient, mild noise (the headline benchmark's input, ``bench.py``)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.3 + 0.2 * (xx / w)
    img[200:700, 300:900] = 0.8
    img[400:900, 1100:1700] = 0.15
    disc = (yy - 540) ** 2 + (xx - 960) ** 2 < 200**2
    img[disc] = 0.95
    img = img + rng.normal(0, 0.01, (h, w)).astype(np.float32)
    return np.broadcast_to(img, (batch, h, w)).reshape(batch, h, w, 1).copy()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    """(least time in ms, what bounds it) for moving ``nbytes`` and doing
    ``ops`` f32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err_f32(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    require(out.shape == ref.shape and out.dtype == ref.dtype, f"{what}: shape/dtype differ")
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs()
    require(bool((err <= F32_ATOL + F32_RTOL * ref.abs()).all()), f"{what}: max |err| {float(err.max())}")
    return float(err.max())


def exact(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    require(out.shape == ref.shape and out.dtype == ref.dtype, f"{what}: shape/dtype differ")
    diff = int((out != ref).sum())
    require(diff == 0, f"{what}: {diff} elements differ")
    return 0.0


def tie_confined(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The rule the repo's tests hold the fused Canny to against the op-by-op
    one on an image with tied magnitudes: under 2% of pixels differ, each
    next to a reference edge; returns the mismatch fraction."""
    mismatch = out != ref
    ref_dil = torch.nn.functional.max_pool2d(ref[None].float(), 3, 1, 1)[0] > 0
    require(bool((mismatch <= ref_dil).all()), "canny mismatch away from reference edges")
    frac = float(mismatch.float().mean())
    require(frac < 0.02, f"canny tie mismatch fraction {frac}")
    return frac


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from cpu_vision_tpu_torch import ops
    from cpu_vision_tpu_torch.ops import kernels
    from cpu_vision_tpu_torch.ops.kernels import _build, stencil

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for stem, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")

    # ---------------------------------------------- main path 1: Canny 1080p b8
    b, h, w = 8, 1080, 1920
    frames = scene(h, w, b)
    kernels.reset_launch_counts()
    edges = ops.canny(frames, low_threshold=0.1, high_threshold=0.2)  # numpy in: runs on the card
    torch.cuda.synchronize()
    canny_counts = kernels.launch_counts()
    print(f"canny main path launches: {canny_counts}")
    require(canny_counts["canny_stage1"] >= 1 and canny_counts["hysteresis_sweeps"] >= 1,
            "ops.canny did not go through canny_stage1 and hysteresis_sweeps")
    require(edges.device.type == "cuda" and edges.shape == (b, h, w, 1) and edges.dtype == torch.float32,
            "canny output shape/dtype/device")
    require(bool(((edges == 0) | (edges == 1)).all()), "canny output not 0/1")

    x = torch.from_numpy(frames).to(dev)
    maps = x[..., 0].contiguous()
    cls_twin = stencil.canny_stage1_plain(maps, ops.get_gaussian_kernel1d(5, 1.4, device="cpu").numpy(),
                                          0.1, 0.2)
    edges_twin = ops.hysteresis(cls_twin == 2, cls_twin >= 1).to(torch.float32)[..., None]
    exact(edges, edges_twin, "canny vs the plain twin path")
    edges_op = ops.canny(x, 0.1, 0.2, backend="plain")
    op_frac = float((edges != edges_op).float().mean())
    print(f"canny 1080p b8: edge pixels {int(edges.sum())}, equal to twin path; "
          f"mismatch vs op-by-op path {op_frac:.3e}")

    # small inputs held to the repo's test rules against the op-by-op path
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.random((56, 72), dtype=np.float32)).to(dev)
    exact(ops.canny(noise, 0.3, 0.6), ops.canny(noise, 0.3, 0.6, backend="plain"), "canny on noise")
    step = torch.full((64, 80), 0.1, device=dev)
    step[20:44, 24:60] = 0.9
    step_frac = tie_confined(ops.canny(step, 0.1, 0.3), ops.canny(step, 0.1, 0.3, backend="plain"))
    print(f"canny small inputs: noise exact, step mismatch {step_frac:.4f}")

    canny_ms = time_ms(lambda: ops.canny(x, 0.1, 0.2), iters=20)
    print(f"canny 1080p b8: {canny_ms:.4f} ms/batch, {b * h * w / canny_ms / 1e6:.3f} GPix/s ({card})")

    # ------------------------------------ main path 2: blur + Sobel, 512x512
    img512 = rng.random((512, 512), dtype=np.float32)
    kernels.reset_launch_counts()
    mag512 = kernels.fused_blur_sobel(img512, 5, 1.5)
    torch.cuda.synchronize()
    bs_counts = kernels.launch_counts()
    print(f"blur+sobel main path launches: {bs_counts}")
    require(bs_counts["fused_blur_sobel"] >= 1, "fused_blur_sobel did not launch")
    x512 = torch.from_numpy(img512).to(dev)
    op512 = ops.sobel(ops.gaussian_blur(x512, 5, 1.5))
    print(f"blur+sobel 512x512 vs op-by-op: max |err| {float((mag512 - op512).abs().max()):.3e}")
    require(bool(torch.allclose(mag512, op512, rtol=0, atol=1e-5)), "blur+sobel vs op-by-op")

    # ------------------------------------- main path 3: Harris 2 MP batch 32
    hb = 32
    imgs32 = rng.random((hb, h, w, 1), dtype=np.float32)
    kernels.reset_launch_counts()
    resp = kernels.harris_response_fused(imgs32)
    torch.cuda.synchronize()
    hr_counts = kernels.launch_counts()
    print(f"harris main path launches: {hr_counts}")
    require(hr_counts["harris_response_fused"] >= 1, "harris_response_fused did not launch")
    require(resp.shape == (hb, h, w, 1) and bool(torch.isfinite(resp).all()), "harris output")
    small = torch.from_numpy(imgs32[0, :64, :96]).to(dev)
    err_small = float((kernels.harris_response_fused(small) - ops.harris_response(small)).abs().max())
    print(f"harris 64x96 vs op-by-op: max |err| {err_small:.3e}")
    require(err_small <= 1e-5, "harris vs op-by-op")

    # ------------------------------------ each kernel against its plain twin
    rows = []

    def row(name, line, launches, err, ms, plain_ms, nbytes, nops):
        b_ms, b_by = bound(nbytes, nops)
        r = {"name": name, "route": "cuda", "source": STENCIL, "replaces": f"{PALLAS}:{line}",
             "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        print(f"{name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
              f"library_ms null, max_abs_err {err}, main-path launches {launches}")
        return r

    px = b * h * w
    k = 5
    t14, t15, t10 = (stencil.gaussian_taps(k, s) for s in (1.4, 1.5, 1.0))
    blur_ops = 2 * (2 * k - 1)  # separable: k mul + (k-1) add per axis
    sobel_ops = 18 + 4          # gx, gy (4 mul + 5 add each), mag (2 mul, add, sqrt)
    cls = kernels.canny_stage1(maps, 0.1, 0.2)
    err = exact(cls, stencil.canny_stage1_plain(maps, t14, 0.1, 0.2), "canny_stage1")
    rows.append(row("canny_stage1", 446, canny_counts["canny_stage1"], err,
                    time_ms(lambda: kernels.canny_stage1(maps, 0.1, 0.2), 50),
                    time_ms(lambda: stencil.canny_stage1_plain(maps, t14, 0.1, 0.2), 5),
                    px * (4 + 1), px * (blur_ops + sobel_ops + 15)))

    sweeps = stencil.SWEEPS_PER_PASS
    buf = torch.empty_like(cls)
    swept = kernels.hysteresis_sweeps(cls, sweeps)
    err = exact(swept, stencil.hysteresis_sweeps_plain(cls, sweeps), f"hysteresis_sweeps x{sweeps}")
    exact(kernels.hysteresis_fixpoint(cls) == 2, ops.hysteresis(cls == 2, cls >= 1), "hysteresis fixpoint")
    rows.append(row("hysteresis_sweeps", 404, canny_counts["hysteresis_sweeps"], err,
                    time_ms(lambda: kernels.hysteresis_sweeps(cls, sweeps, out=buf), 50),
                    time_ms(lambda: stencil.hysteresis_sweeps_plain(cls, sweeps), 5),
                    px * 2, px * sweeps * 8))

    m512 = x512[None]  # (N, H, W) for the twin; the wrapper takes the HW image
    err = max_err_f32(kernels.fused_blur_sobel(x512), stencil.fused_blur_sobel_plain(m512, t15)[0], "blur_sobel 512")
    rows.append(row("fused_blur_sobel", 377, bs_counts["fused_blur_sobel"], err,
                    time_ms(lambda: kernels.fused_blur_sobel(x512), 200),
                    time_ms(lambda: stencil.fused_blur_sobel_plain(m512, t15), 20),
                    512 * 512 * 8, 512 * 512 * (blur_ops + sobel_ops)))
    err = max_err_f32(kernels.fused_blur_sobel(x)[..., 0], stencil.fused_blur_sobel_plain(maps, t15), "blur_sobel 1080p")
    ms = time_ms(lambda: kernels.fused_blur_sobel(x), 50)
    plain_ms = time_ms(lambda: stencil.fused_blur_sobel_plain(maps, t15), 5)
    b_ms, b_by = bound(px * 8, px * (blur_ops + sobel_ops))
    print(f"fused_blur_sobel at 1080p b8: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"bound_ms {b_ms:.4f} ({b_by}) library_ms null, max_abs_err {err}")

    m32 = torch.from_numpy(imgs32[..., 0]).to(dev)
    hp = hb * h * w
    err = max_err_f32(kernels.harris_response_fused(m32[..., None]), stencil.harris_response_fused_plain(m32, t10, 0.04)[..., None],
                      "harris")
    rows.append(row("harris_response_fused", 591, hr_counts["harris_response_fused"], err,
                    time_ms(lambda: kernels.harris_response_fused(m32[..., None]), 20),
                    time_ms(lambda: stencil.harris_response_fused_plain(m32, t10, 0.04), 3),
                    hp * 8, hp * (sobel_ops - 4 + 3 + 3 * blur_ops + 7)))

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
