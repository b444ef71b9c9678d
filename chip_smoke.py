#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cpu_vision_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``cpu_vision_tpu_torch/csrc/``, then:

1. drives the main paths through the public entry points, each with the
   kernels' launch counts set to 0 just before it and read just after:
   ``ops.canny`` on the synthetic 1080p scene at batch 8 (the headline
   benchmark's workload), and the same with ``canny_stage1``'s in-tile
   hysteresis; ``ops.kernels.fused_blur_sobel`` on one 512x512 image;
   ``ops.kernels.harris_response_fused`` on 2 MP images at batch 32;
   ``ops.cnn_forward`` at batch 256 on 28x28x1 and 224x224x3 images with
   channels (32, 64) and 128 hidden units; and the 4-level Laplacian
   pyramid, antialiased bilinear resize, rotation and fused Gaussian blur
   of 64 RGB 640x480 images; and checks their outputs against the
   op-by-op paths and stock PyTorch operators;
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
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the
# tensor cores.  A card below its 700 W limit runs slower than this bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Kernel vs twin: class maps must be equal; f32 stencil maps must agree
# within F32_ATOL + F32_RTOL * |twin| (both run the same f32 operations in
# the same order without FMA, so the expected difference is 0).  The fused
# convolution sums over input channels in another order than its twin's
# matrix products, with FMAs: CONV_ATOL + CONV_RTOL * |twin|.  Logits of the
# CNN's three conv routes: LOGIT_TOL + LOGIT_TOL * |reference|.
F32_ATOL, F32_RTOL = 1e-5, 1e-6
CONV_ATOL, CONV_RTOL = 1e-5, 1e-5
LOGIT_TOL = 1e-4
STENCIL = "cpu_vision_tpu_torch/csrc/stencil.cu"
CONV_BLOCK = "cpu_vision_tpu_torch/csrc/conv_block.cu"
PALLAS = "cpu_vision_tpu/ops/pallas/stencil.py"
PALLAS_CONV = "cpu_vision_tpu/ops/pallas/conv_block.py"


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


def max_err_f32(out: torch.Tensor, ref: torch.Tensor, what: str, atol: float = F32_ATOL,
                rtol: float = F32_RTOL) -> float:
    require(out.shape == ref.shape and out.dtype == ref.dtype, f"{what}: shape/dtype differ")
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs_()
    worst = float(err.max())
    require(bool((err <= ref.abs().mul_(rtol).add_(atol)).all()), f"{what}: max |err| {worst}")
    return worst


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
    ref_dil = F.max_pool2d(ref[None].float(), 3, 1, 1)[0] > 0
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
    from cpu_vision_tpu_torch.ops.kernels import _build, conv_block, stencil

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

    # -------------------- main path 1b: Canny with the in-tile hysteresis, 1080p b8
    def passes_to_fixpoint(cls_map):
        kernels.reset_launch_counts()
        fixed = kernels.hysteresis_fixpoint(cls_map)
        return fixed, kernels.launch_counts()["hysteresis_sweeps"]

    kernels.reset_launch_counts()
    cls_tile = kernels.canny_stage1(maps, 0.1, 0.2, in_tile_hysteresis=True)
    fixed_tile = kernels.hysteresis_fixpoint(cls_tile)
    torch.cuda.synchronize()
    tile_counts = kernels.launch_counts()
    print(f"canny with in-tile hysteresis main path launches: {tile_counts}")
    require(tile_counts["canny_stage1_in_tile"] >= 1 and tile_counts["canny_stage1"] == 0,
            "the option did not go through the in-tile kernel")
    fixed_base, base_passes = passes_to_fixpoint(kernels.canny_stage1(maps, 0.1, 0.2))
    exact(fixed_tile, fixed_base, "in-tile hysteresis: global fixpoint on the scene")
    noise8 = torch.from_numpy(rng.random((b, h, w), dtype=np.float32)).to(dev)
    noise_tile, noise_tile_passes = passes_to_fixpoint(kernels.canny_stage1(noise8, 0.3, 0.6, in_tile_hysteresis=True))
    noise_base, noise_base_passes = passes_to_fixpoint(kernels.canny_stage1(noise8, 0.3, 0.6))
    exact(noise_tile, noise_base, "in-tile hysteresis: global fixpoint on noise")
    tile_passes = {"scene": (tile_counts["hysteresis_sweeps"], base_passes), "noise": (noise_tile_passes, noise_base_passes)}
    print("global hysteresis passes with / without the in-tile option: "
          + ", ".join(f"{k} {v[0]} / {v[1]}" for k, v in tile_passes.items()))
    del noise_tile, noise_base, fixed_tile, fixed_base

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

    del resp

    # -------------------- main path 4: the small CNN at full width, batch 256
    require(not torch.backends.cuda.matmul.allow_tf32, "float32 matrix products must not run in TF32")
    cnn = {}
    for hw, cin in ((28, 1), (224, 3)):
        params = ops.cnn_init(torch.Generator().manual_seed(0), (hw, hw), cin, (32, 64), 128, 10)
        images = rng.random((256, hw, hw, cin), dtype=np.float32)
        kernels.reset_launch_counts()
        logits = ops.cnn_forward(params, images)  # numpy in: runs on the card
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        print(f"cnn {hw}x{hw}x{cin} main path launches: {counts}")
        require(counts["fused_conv3x3_relu_pool"] == 2, "cnn_forward did not launch the fused stage twice")
        require(logits.device.type == "cuda" and logits.shape == (256, 10) and logits.dtype == torch.float32,
                "cnn logits shape/dtype/device")
        xc = torch.from_numpy(images).to(dev)
        errs = {backend: max_err_f32(logits, ops.cnn_forward(params, xc, backend=backend), f"cnn {hw} vs {backend}",
                                     LOGIT_TOL, LOGIT_TOL) for backend in ("plain", "stock")}
        ms = time_ms(lambda: ops.cnn_forward(params, xc), 20)
        stock_ms = time_ms(lambda: ops.cnn_forward(params, xc, backend="stock"), 20)
        print(f"cnn {hw}x{hw}x{cin} b256: {ms:.4f} ms/batch, {256 / ms * 1e3:.1f} img/s; stock route "
              f"{stock_ms:.4f} ms/batch, {256 / stock_ms * 1e3:.1f} img/s; logits max |err| vs plain "
              f"{errs['plain']:.3e}, vs stock {errs['stock']:.3e} ({card})")
        cnn[hw] = (params, xc, counts["fused_conv3x3_relu_pool"])
    del logits, images

    # ----------- main path 5: pyramid + resize + rotate + blur, 64 RGB 640x480
    batch3 = rng.random((64, 480, 640, 3), dtype=np.float32)
    kernels.reset_launch_counts()
    levels = ops.laplacian_pyramid(batch3, 4)  # numpy in: runs on the card
    small = ops.resize(levels[0], (240, 320), "bilinear", True)
    rec = ops.reconstruct_from_laplacian(levels)
    x3 = torch.from_numpy(batch3).to(dev)
    rot = ops.rotate(x3, 30.0, "bilinear", fill=0)
    blurred = kernels.fused_gaussian_blur(x3, 5, 1.5)
    torch.cuda.synchronize()
    p5_counts = kernels.launch_counts()
    print(f"pyramid/resize/rotate/blur main path launches: {p5_counts}")
    require(p5_counts["fused_gaussian_blur"] >= 1, "fused_gaussian_blur did not launch")
    require([tuple(lv.shape[1:3]) for lv in levels] == [(480, 640), (240, 320), (120, 160), (60, 80)]
            and all(lv.device.type == "cuda" and bool(torch.isfinite(lv).all()) for lv in levels), "pyramid levels")
    rec_err = float((rec - x3).abs().max())
    require(rec.shape == x3.shape and rec_err <= 1e-5, f"Laplacian reconstruction: max |err| {rec_err}")
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    small_ref = nhwc(F.interpolate(nchw(levels[0]), (240, 320), mode="bilinear", antialias=True))
    small_err = float((small - small_ref).abs().max())
    require(small.shape == (64, 240, 320, 3) and small_err <= 1e-4, f"resize vs F.interpolate: max |err| {small_err}")
    grid = ops.affine_grid(ops.get_rotation_matrix(-30.0), 640, 480, 640, 480).expand(4, -1, -1, -1)
    masked = torch.cat([x3[:4], torch.ones_like(x3[:4, :, :, :1])], dim=-1)  # fill=0 goes through a warped mask
    rot_ref = nhwc(F.grid_sample(nchw(masked), grid, mode="bilinear", padding_mode="zeros", align_corners=False))
    rot_ref = rot_ref[..., :3] * rot_ref[..., 3:]
    rot_err = float((rot[:4] - rot_ref).abs().max())
    require(rot.shape == x3.shape and bool(torch.isfinite(rot).all()) and rot_err <= 1e-4,
            f"rotate vs F.grid_sample: max |err| {rot_err}")
    blur_err = float((blurred - ops.gaussian_blur(x3, 5, 1.5)).abs().max())
    require(blurred.shape == x3.shape and blur_err <= 1e-5, f"fused blur vs ops.gaussian_blur: max |err| {blur_err}")
    print(f"config 3: reconstruction max |err| {rec_err:.3e}, resize vs F.interpolate {small_err:.3e}, "
          f"rotate vs F.grid_sample {rot_err:.3e}, fused blur vs op-by-op {blur_err:.3e}")
    del levels, small, small_ref, rec, rot, rot_ref, masked, blurred, grid
    pyr_ms = time_ms(lambda: ops.resize(ops.laplacian_pyramid(x3, 4)[0], (240, 320), "bilinear", True), 5)
    rot_ms = time_ms(lambda: ops.rotate(x3, 30.0, "bilinear", fill=0), 5)
    print(f"config 3, 64x480x640x3: pyramid + resize {pyr_ms:.4f} ms/batch, {64 / pyr_ms * 1e3:.1f} img/s; "
          f"rotate {rot_ms:.4f} ms/batch ({card})")

    # ------------------------------------ each kernel against its plain twin
    rows = []

    def row(name, replaces, launches, err, ms, plain_ms, nbytes, nops, library_ms=None, source=STENCIL, **extra):
        b_ms, b_by = bound(nbytes, nops)
        r = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, **extra}
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        print(f"{name}{' ' + str(extra['shape']) if 'shape' in extra else ''}: kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {lib}, max_abs_err {err}, "
              f"main-path launches {launches}")
        return r

    px = b * h * w
    k = 5
    t14, t15, t10 = (stencil.gaussian_taps(k, s) for s in (1.4, 1.5, 1.0))
    blur_ops = 2 * (2 * k - 1)  # separable: k mul + (k-1) add per axis
    sobel_ops = 18 + 4          # gx, gy (4 mul + 5 add each), mag (2 mul, add, sqrt)
    cls = kernels.canny_stage1(maps, 0.1, 0.2)
    err = exact(cls, stencil.canny_stage1_plain(maps, t14, 0.1, 0.2), "canny_stage1")
    rows.append(row("canny_stage1", f"{PALLAS}:446", canny_counts["canny_stage1"], err,
                    time_ms(lambda: kernels.canny_stage1(maps, 0.1, 0.2), 50),
                    time_ms(lambda: stencil.canny_stage1_plain(maps, t14, 0.1, 0.2), 5),
                    px * (4 + 1), px * (blur_ops + sobel_ops + 15)))

    # the in-tile rounds depend on the data and add integer work only: bytes bound it either way
    err = exact(cls_tile, stencil.canny_stage1_plain(maps, t14, 0.1, 0.2, in_tile=stencil.IN_TILE),
                "canny_stage1 with in-tile hysteresis")
    rows.append(row("canny_stage1_in_tile", f"{PALLAS}:499", tile_counts["canny_stage1_in_tile"], err,
                    time_ms(lambda: kernels.canny_stage1(maps, 0.1, 0.2, in_tile_hysteresis=True), 50),
                    time_ms(lambda: stencil.canny_stage1_plain(maps, t14, 0.1, 0.2, in_tile=stencil.IN_TILE), 3),
                    px * (4 + 1), px * (blur_ops + sobel_ops + 15 + 8),
                    global_passes_with_without=tile_passes))
    exact(kernels.canny_stage1(noise8, 0.3, 0.6, in_tile_hysteresis=True),
          stencil.canny_stage1_plain(noise8, t14, 0.3, 0.6, in_tile=stencil.IN_TILE), "in-tile hysteresis on noise")
    del cls_tile, noise8

    sweeps = stencil.SWEEPS_PER_PASS
    buf = torch.empty_like(cls)
    swept = kernels.hysteresis_sweeps(cls, sweeps)
    err = exact(swept, stencil.hysteresis_sweeps_plain(cls, sweeps), f"hysteresis_sweeps x{sweeps}")
    exact(kernels.hysteresis_fixpoint(cls) == 2, ops.hysteresis(cls == 2, cls >= 1), "hysteresis fixpoint")
    rows.append(row("hysteresis_sweeps", f"{PALLAS}:404", canny_counts["hysteresis_sweeps"], err,
                    time_ms(lambda: kernels.hysteresis_sweeps(cls, sweeps, out=buf), 50),
                    time_ms(lambda: stencil.hysteresis_sweeps_plain(cls, sweeps), 5),
                    px * 2, px * sweeps * 8))

    m512 = x512[None]  # (N, H, W) for the twin; the wrapper takes the HW image
    err = max_err_f32(kernels.fused_blur_sobel(x512), stencil.fused_blur_sobel_plain(m512, t15)[0], "blur_sobel 512")
    rows.append(row("fused_blur_sobel", f"{PALLAS}:377", bs_counts["fused_blur_sobel"], err,
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
    rows.append(row("harris_response_fused", f"{PALLAS}:591", hr_counts["harris_response_fused"], err,
                    time_ms(lambda: kernels.harris_response_fused(m32[..., None]), 20),
                    time_ms(lambda: stencil.harris_response_fused_plain(m32, t10, 0.04), 3),
                    hp * 8, hp * (sobel_ops - 4 + 3 + 3 * blur_ops + 7)))

    del m32

    # library_ms of the blur and of the conv stage are composites of stock calls
    # (shifted-slice sums; conv2d + relu + max_pool2d in full f32), not one kernel
    def blur_at(img, launches, what):
        m, restore = stencil._as_nhw(img)  # (N*C, H, W) maps for the twin
        err = max_err_f32(kernels.fused_gaussian_blur(img), restore(stencil.fused_gaussian_blur_plain(m, t15)), what)
        return row("fused_gaussian_blur", f"{PALLAS}:357", launches, err,
                   time_ms(lambda: kernels.fused_gaussian_blur(img), 20),
                   time_ms(lambda: stencil.fused_gaussian_blur_plain(m, t15), 3),
                   img.numel() * 8, img.numel() * blur_ops,
                   library_ms=time_ms(lambda: ops.gaussian_blur(img, 5, 1.5), 3), shape=list(img.shape))

    blur_row = blur_at(x3, p5_counts["fused_gaussian_blur"], "gaussian_blur 64x480x640x3")
    blur_row["other_shapes"] = [blur_at(x, 0, "gaussian_blur 1080p b8")]
    rows.append(blur_row)
    del x3

    conv_rows = []
    for hw in (28, 224):
        params, xc, launches = cnn[hw]
        for i in (0, 1):
            wgt, bias = params[f"conv{i}"]["w"], params[f"conv{i}"]["b"]
            out = kernels.fused_conv3x3_relu_pool(xc, wgt, bias)
            err = max_err_f32(out, conv_block.fused_conv3x3_relu_pool_plain(xc, wgt, bias),
                              f"conv{i} at {hw}", CONV_ATOL, CONV_RTOL)
            max_err_f32(out, kernels.conv3x3_relu_pool(xc, wgt, bias, "stock"), f"conv{i} at {hw} vs stock",
                        CONV_ATOL, CONV_RTOL)
            conv_px = xc.shape[0] * xc.shape[1] * xc.shape[2]
            conv_rows.append(row(
                "fused_conv3x3_relu_pool", f"{PALLAS_CONV}:36", launches // 2, err,
                time_ms(lambda: kernels.fused_conv3x3_relu_pool(xc, wgt, bias), 10),
                time_ms(lambda: conv_block.fused_conv3x3_relu_pool_plain(xc, wgt, bias), 3),
                4 * (xc.numel() + wgt.numel() + bias.numel() + out.numel()),
                conv_px * 2 * 9 * wgt.shape[2] * wgt.shape[3] + 3 * out.numel(),
                library_ms=time_ms(lambda: kernels.conv3x3_relu_pool(xc, wgt, bias, "stock"), 10),
                source=CONV_BLOCK, shape=[list(xc.shape), wgt.shape[3]]))
            xc = out
    # one entry for the kernel: its heaviest main-path shape, the other three beside it
    conv_row = dict(conv_rows[-1], launches=cnn[28][2] + cnn[224][2], other_shapes=conv_rows[:-1])
    rows.append(conv_row)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
