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
   of 64 RGB 640x480 images; ``models.get_model("vit_b_16")`` at full depth
   and width on 224x224x3 images, in bfloat16 at batch 256 (``attention_block``
   and ``mlp_block`` in each of the 12 layers) and in float32 at batch 64
   (``flash_mha`` and ``mlp_block``); and ResNet-50 in float32 through
   ``graft_entry.entry()`` (batch 4) and at batch 256, which runs stock
   operators only; and checks their outputs against the op-by-op paths and
   stock PyTorch operators;
2. holds every kernel against its plain PyTorch twin on the card at those
   shapes and times both with CUDA events;
3. prints one JSON line of per-kernel results, then, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
Without a CUDA card it exits 1 at once.
"""

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the
# tensor cores, dense bf16 in them (the card's bf16 rate, whatever a kernel
# uses).  A card below its 700 W limit runs slower than this bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# Kernel vs twin: class maps must be equal; f32 stencil maps must agree
# within F32_ATOL + F32_RTOL * |twin| (both run the same f32 operations in
# the same order without FMA, so the expected difference is 0).  The fused
# convolution sums over input channels in another order than its twin's
# matrix products, with FMAs: CONV_ATOL + CONV_RTOL * |twin|.  Logits of the
# CNN's three conv routes: LOGIT_TOL + LOGIT_TOL * |reference|.  The
# transformer kernels sum products of up to 3072 terms in other orders than
# their twins' matrix products, with FMAs: TOL * (1 + |twin|) with TOL[dtype],
# bf16 compared in bf16 (one step is 2^-8 of the value).  ViT logits against
# the stock-operator route: VIT_TOL[dtype] * (1 + |reference|).  In bf16 that
# route rounds at other places in each of 24 sub-blocks, so two right answers
# differ by several bf16 steps: on an H100 the least t with |a - b| <=
# t * (1 + |b|) reads 4.25e-2 between the two routes, and 3.31e-2 (kernels)
# and 3.48e-2 (stock) against the float32 logits of the same weights, so no
# bf16 route meets the kernels' own 2e-2 over 12 layers; four times that is
# allowed.  The tighter check is against those float32 logits: the kernel
# route may stand no further from them than BF16_SLACK times the stock bf16
# route does (it reads 0.92 times as far).  ResNet-50 logits against the same model run layer
# by layer: LOGIT_TOL * (1 + |reference|).
F32_ATOL, F32_RTOL = 1e-5, 1e-6
CONV_ATOL, CONV_RTOL = 1e-5, 1e-5
LOGIT_TOL = 1e-4
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
VIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 8e-2}
BF16_SLACK = 1.5
STENCIL = "cpu_vision_tpu_torch/csrc/stencil.cu"
CONV_BLOCK = "cpu_vision_tpu_torch/csrc/conv_block.cu"
ATTENTION = "cpu_vision_tpu_torch/csrc/attention.cu"
TRANSFORMER = "cpu_vision_tpu_torch/csrc/transformer_block.cu"
PALLAS = "cpu_vision_tpu/ops/pallas/stencil.py"
PALLAS_CONV = "cpu_vision_tpu/ops/pallas/conv_block.py"
PALLAS_FLASH = "cpu_vision_tpu/ops/pallas/flash_attention.py"
PALLAS_BLOCK = "cpu_vision_tpu/ops/pallas/transformer_block.py"


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


def spread_ms(fn, iters: int, warmup: int = 2):
    """(mean, least, most) device time of one call of ``fn`` in ms, each of
    ``iters`` calls between its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    marks[0].record()
    for mark in marks[1:]:
        fn()
        mark.record()
    marks[-1].synchronize()
    times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return sum(times) / iters, min(times), max(times)


def clock_under(fn, calls: int) -> str:
    """The card's SM clock and power draw as ``nvidia-smi`` reads them while
    ``calls`` queued calls of ``fn`` run (the wrappers return before the card
    is done, so the query lands inside the window)."""
    for _ in range(calls):
        fn()
    read = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    return read


def scaled_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (1 + |ref|): the least tolerance t for which
    ``out`` is within t * (1 + |ref|) of ``ref``."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (1 + ref.abs())).max())


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(least time in ms, what bounds it) for moving ``nbytes`` and doing
    ``ops`` operations at the card's peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err_f32(out: torch.Tensor, ref: torch.Tensor, what: str, atol: float = F32_ATOL,
                rtol: float = F32_RTOL) -> float:
    require(out.shape == ref.shape and out.dtype == ref.dtype, f"{what}: shape/dtype differ")
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    ref = ref.float()
    err = (out.float() - ref).abs_()
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


def resnet_layer_by_layer(model, images: torch.Tensor) -> torch.Tensor:
    """The logits of the port's ``ResNet`` from a copy of its modules called
    one by one on contiguous NCHW maps and weights (the model itself runs
    functional operators on channels-last maps and weights, so cuDNN sums in
    another order there)."""
    model = copy.deepcopy(model).to(memory_format=torch.contiguous_format)
    x = images.permute(0, 3, 1, 2).contiguous()
    x = F.max_pool2d(torch.relu(model.bn1(model.conv1(x))), 3, 2, 1)
    for stage in (model.layer1, model.layer2, model.layer3, model.layer4):
        for block in stage:
            out = x
            convs = [(block.conv1, block.bn1), (block.conv2, block.bn2)]
            if hasattr(block, "conv3"):
                convs.append((block.conv3, block.bn3))
            for i, (conv, bn) in enumerate(convs):
                out = bn(conv(out))
                if i < len(convs) - 1:
                    out = torch.relu(out)
            x = torch.relu(out + (x if block.downsample is None else block.downsample(x)))
    return model.fc(x.mean(dim=(2, 3)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from cpu_vision_tpu_torch import _dtype, graft_entry, models, ops
    from cpu_vision_tpu_torch.ops import kernels
    from cpu_vision_tpu_torch.ops.kernels import _build, conv_block, flash_attention, stencil, transformer_block

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


    # ------- main paths 6 and 7: ViT-B/16 serving, bf16 batch 256 and f32 batch 64
    vit_images = np.random.default_rng(0).random((256, 224, 224, 3), dtype=np.float32)
    vit_state = None
    vit = {}
    for dtype, batch, expected in ((torch.bfloat16, 256, {"attention_block": 12, "mlp_block": 12, "flash_mha": 0}),
                                   (torch.float32, 64, {"attention_block": 0, "mlp_block": 12, "flash_mha": 12})):
        name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
        model = models.get_model("vit_b_16", dtype=dtype, generator=torch.Generator().manual_seed(0))
        plain = models.get_model("vit_b_16", dtype=dtype, attention="plain", mlp="plain")
        if vit_state is None:
            vit_state = model.state_dict()
        model.load_state_dict(vit_state)  # one set of weights for both dtypes
        plain.load_state_dict(vit_state)
        kernels.reset_launch_counts()
        logits = model(vit_images[:batch])  # numpy in: runs on the card
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        print(f"vit_b_16 {name} b{batch} main path launches: {counts} (routes {model.routes()}, "
              f"{kernels.attention_block.kernel_launches} kernel launches in attention_block)")
        require({k: counts[k] for k in expected} == expected, f"vit_b_16 {name}: expected launches {expected}")
        require(logits.device.type == "cuda" and logits.shape == (batch, 1000) and logits.dtype == dtype,
                "vit logits shape/dtype/device")
        xv = torch.from_numpy(vit_images[:batch]).to(dev)
        ref = plain(xv)
        err = max_err_f32(logits, ref, f"vit_b_16 {name} vs the stock-operator route", VIT_TOL[dtype], VIT_TOL[dtype])
        top1 = float((logits.argmax(dim=1) == ref.argmax(dim=1)).float().mean())
        if dtype == torch.bfloat16:
            vit_block_kernel_launches = kernels.attention_block.kernel_launches
            exact32 = models.get_model("vit_b_16", attention="plain", mlp="plain")
            exact32.load_state_dict(vit_state)
            truth = exact32(xv)
            err_kernel, err_stock = (float((o.float() - truth).abs().max()) for o in (logits, ref))
            print(f"vit_b_16 bf16 b256 against the float32 logits: kernel route max |err| {err_kernel:.3e}, "
                  f"stock-operator route {err_stock:.3e}; top-1 agreement {float((logits.argmax(1) == truth.argmax(1)).float().mean()):.4f} "
                  f"and {float((ref.argmax(1) == truth.argmax(1)).float().mean()):.4f}")
            print(f"vit_b_16 bf16 b256, max |a - b| / (1 + |b|): kernel route vs stock bf16 route {scaled_err(logits, ref):.3e}, "
                  f"kernel route vs float32 {scaled_err(logits, truth):.3e}, stock bf16 route vs float32 {scaled_err(ref, truth):.3e}")
            require(err_kernel <= BF16_SLACK * err_stock, "the kernel route strays further from float32 than the stock route")
            del exact32, truth
        ms, ms_least, ms_most = spread_ms(lambda: model(xv), 10, warmup=2)
        plain_ms, plain_least, plain_most = spread_ms(lambda: plain(xv), 10, warmup=2)
        print(f"vit_b_16 {name} b{batch}: {ms:.4f} ms/batch ({ms_least:.4f} to {ms_most:.4f} over 10 calls), "
              f"{batch / ms * 1e3:.1f} img/s; stock-operator route {plain_ms:.4f} ms/batch ({plain_least:.4f} to "
              f"{plain_most:.4f}), {batch / plain_ms * 1e3:.1f} img/s; logits max |err| vs that route {err:.3e} "
              f"(max |logit| {float(ref.abs().max()):.3f}), top-1 agreement {top1:.4f} ({card}); "
              f"under this route's load: {clock_under(lambda: model(xv), 3 if dtype == torch.bfloat16 else 10)}")
        vit[dtype] = counts
        del model, plain, logits, ref, xv
    del vit_state, vit_images

    # ------------- main path 8: ResNet-50 f32, stock operators only (no kernel of the port)
    kernels.reset_launch_counts()
    forward, (r50, images4) = graft_entry.entry()
    logits4 = forward(r50, images4)
    torch.cuda.synchronize()
    require(all(v == 0 for v in kernels.launch_counts().values()), "ResNet-50 launched a kernel of the port")
    require(logits4.device.type == "cuda" and logits4.shape == (4, 1000) and logits4.dtype == torch.float32,
            "resnet50 logits shape/dtype/device")
    with _dtype.full_float32(), torch.no_grad():
        err4 = max_err_f32(logits4, resnet_layer_by_layer(r50, images4), "resnet50 b4 vs layer by layer",
                           LOGIT_TOL, LOGIT_TOL)
    r50_ms4, r50_least4, r50_most4 = spread_ms(lambda: forward(r50, images4), 50, warmup=5)
    # the initialiser zeroes each block's last batch-norm scale, so the residual
    # branches contribute nothing; switch them on for the batch-256 check
    with torch.no_grad():
        for stage in (r50.layer1, r50.layer2, r50.layer3, r50.layer4):
            for block in stage:
                block.last_bn.weight.fill_(0.25)
    images256 = torch.from_numpy(rng.random((256, 224, 224, 3), dtype=np.float32)).to(dev)
    logits256 = r50(images256)
    require(logits256.shape == (256, 1000), "resnet50 b256 logits shape")
    with _dtype.full_float32(), torch.no_grad():
        err256 = max_err_f32(logits256, resnet_layer_by_layer(r50, images256), "resnet50 b256 vs layer by layer",
                             LOGIT_TOL, LOGIT_TOL)
    r50_ms256, r50_least256, r50_most256 = spread_ms(lambda: r50(images256), 10)
    print(f"resnet50 f32 (stock operators in full f32, no kernel of the port runs here): b4 {r50_ms4:.4f} ms/batch "
          f"({r50_least4:.4f} to {r50_most4:.4f} over 50 calls), {4 / r50_ms4 * 1e3:.1f} img/s, logits max |err| vs layer "
          f"by layer {err4:.3e}; b256 {r50_ms256:.4f} ms/batch ({r50_least256:.4f} to {r50_most256:.4f} over 10 calls), "
          f"{256 / r50_ms256 * 1e3:.1f} img/s, max |err| {err256:.3e} (max |logit| "
          f"{float(logits256.abs().max()):.3f}) ({card})")
    del r50, images4, images256, logits4, logits256

    # ------------------------------------ each kernel against its plain twin
    rows = []

    def row(name, replaces, launches, err, ms, plain_ms, nbytes, nops, library_ms=None, source=STENCIL,
            ops_per_s=F32_OPS_PER_S, **extra):
        b_ms, b_by = bound(nbytes, nops, ops_per_s)
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


    # the transformer kernels at ViT-B/16's shapes; library_ms of the two blocks
    # are composites of stock calls (layer_norm, linear, gelu, SDPA), not one kernel
    gen = torch.Generator(device=dev).manual_seed(0)
    d_model, heads, d_hidden, seq = 768, 12, 3072, 197
    hd = d_model // heads
    rate = {torch.float32: F32_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S}

    def normal(shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    def attention_ops(n):  # QK^T and PV, plus scale, max, exp, sum and divide per score
        return n * heads * seq * seq * (4 * hd + 5)

    q, k, v = (normal((64, seq, heads, hd), torch.float32) for _ in range(3))
    scale = hd ** -0.5
    out = kernels.flash_mha(q, k, v, scale)
    err = max_err_f32(out, flash_attention.flash_mha_plain(q, k, v, scale), "flash_mha", TOL[torch.float32],
                      TOL[torch.float32])
    qh, kh, vh = (a.permute(0, 2, 1, 3) for a in (q, k, v))
    max_err_f32(out, F.scaled_dot_product_attention(qh, kh, vh, scale=scale), "flash_mha vs SDPA", 1e-3, 1e-3)
    rows.append(row("flash_mha", f"{PALLAS_FLASH}:56", vit[torch.float32]["flash_mha"], err,
                    time_ms(lambda: kernels.flash_mha(q, k, v, scale), 20),
                    time_ms(lambda: flash_attention.flash_mha_plain(q, k, v, scale), 5),
                    4 * q.numel() * q.element_size(), attention_ops(64),
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 20),
                    source=ATTENTION, shape=list(q.shape), dtype="float32"))
    del q, k, v, qh, kh, vh, out

    def ln_params():
        return normal((d_model,), torch.float32, 0.2, 1.0), normal((d_model,), torch.float32, 0.1)

    dtype = torch.bfloat16
    x = normal((256, seq, d_model), dtype)
    ln_g, ln_b = ln_params()
    w_qkv, b_qkv = normal((d_model, 3 * d_model), dtype, d_model ** -0.5), normal((3 * d_model,), torch.float32, 0.1)
    w_o, b_o = normal((d_model, d_model), dtype, d_model ** -0.5), normal((d_model,), torch.float32, 0.1)
    args = (x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads, scale, 1e-6)
    out = kernels.attention_block(*args)
    err = max_err_f32(out, transformer_block.attention_block_plain(*args), "attention_block", TOL[dtype], TOL[dtype])

    def attention_library():
        h = F.layer_norm(x, (d_model,), ln_g.to(dtype), ln_b.to(dtype), 1e-6)
        a, b, c = (t.reshape(256, seq, heads, hd).permute(0, 2, 1, 3)
                   for t in F.linear(h, w_qkv.t(), b_qkv.to(dtype)).split(d_model, dim=-1))
        o = F.scaled_dot_product_attention(a, b, c, scale=scale).permute(0, 2, 1, 3).reshape(256, seq, d_model)
        return x + F.linear(o, w_o.t(), b_o.to(dtype))

    max_err_f32(out, attention_library(), "attention_block vs the stock composite", 5e-2, 5e-2)
    tokens = 256 * seq
    # inputs and output once, and the (N*S, 3D) QKV product and the (N*S, D)
    # joined heads written and read once each: they pass through device memory
    # between the three launches of a call (the TPU kernel keeps them on chip)
    block_bytes = 2 * x.numel() * 2 + (w_qkv.numel() + w_o.numel()) * 2 + 4 * (6 * d_model) + 2 * 4 * x.numel() * 2
    rows.append(row("attention_block", f"{PALLAS_BLOCK}:237", vit[dtype]["attention_block"], err,
                    time_ms(lambda: kernels.attention_block(*args), 5),
                    time_ms(lambda: transformer_block.attention_block_plain(*args), 3),
                    block_bytes, tokens * (8 * d_model * d_model + 8 * d_model) + attention_ops(256),
                    library_ms=time_ms(attention_library, 5), source=TRANSFORMER, ops_per_s=rate[dtype],
                    shape=list(x.shape), dtype="bfloat16", kernel_launches=vit_block_kernel_launches))
    print(f"  under attention_block's load: {clock_under(lambda: kernels.attention_block(*args), 40)}")
    del x, out, args, w_qkv, w_o

    mlp_rows = []
    for dtype, batch in ((torch.float32, 64), (torch.bfloat16, 256)):
        tokens = batch * seq
        x = normal((tokens, d_model), dtype)
        ln_g, ln_b = ln_params()
        w1, b1 = normal((d_model, d_hidden), dtype, d_model ** -0.5), normal((d_hidden,), torch.float32, 0.1)
        w2, b2 = normal((d_hidden, d_model), dtype, d_hidden ** -0.5), normal((d_model,), torch.float32, 0.1)
        args = (x, ln_g, ln_b, w1, b1, w2, b2, 1e-6)
        out = kernels.mlp_block(*args)
        err = max_err_f32(out, transformer_block.mlp_block_plain(*args), f"mlp_block {dtype}", TOL[dtype], TOL[dtype])

        def mlp_library():
            h = F.layer_norm(x, (d_model,), ln_g.to(dtype), ln_b.to(dtype), 1e-6)
            return x + F.linear(F.gelu(F.linear(h, w1.t(), b1.to(dtype))), w2.t(), b2.to(dtype))

        max_err_f32(out, mlp_library(), f"mlp_block {dtype} vs the stock composite",
                    5e-2 if dtype == torch.bfloat16 else 1e-3, 5e-2 if dtype == torch.bfloat16 else 1e-3)
        size = x.element_size()
        mlp_rows.append(row("mlp_block", f"{PALLAS_BLOCK}:125", vit[dtype]["mlp_block"], err,
                            time_ms(lambda: kernels.mlp_block(*args), 5),
                            time_ms(lambda: transformer_block.mlp_block_plain(*args), 3),
                            2 * x.numel() * size + (w1.numel() + w2.numel()) * size + 4 * (4 * d_model + d_hidden),
                            tokens * (4 * d_model * d_hidden + 20 * d_hidden + 8 * d_model),
                            library_ms=time_ms(mlp_library, 5), source=TRANSFORMER, ops_per_s=rate[dtype],
                            shape=list(x.shape), dtype=str(dtype).replace("torch.", "")))
        print(f"  under mlp_block's load: {clock_under(lambda: kernels.mlp_block(*args), 20 if dtype == torch.bfloat16 else 100)}")
        del x, out, args, w1, w2
    rows.append(dict(mlp_rows[-1], launches=sum(r["launches"] for r in mlp_rows), other_shapes=mlp_rows[:-1]))

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
