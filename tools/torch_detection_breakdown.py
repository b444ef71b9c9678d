#!/usr/bin/env python3
"""Where a Faster R-CNN forward's time goes on the card.

Run from the repository root on a machine with an NVIDIA card:

    python3 tools/torch_detection_breakdown.py [--batch 8] [--iters 10]

It builds ``fasterrcnn_resnet50_fpn`` (bfloat16 and float32, TF32 off) and
``fasterrcnn_resnet50_fpn_v2`` (float32) at the settings of ``chip_smoke.py``
(91 classes, 1000 / 300 proposals, 100 detections, weights from seed 0) and,
on 8 images of unequal sizes on a 640x640 canvas, prints for each:

* the stages of one forward (transform, ResNet-50 body, FPN, RPN head, RPN
  proposal filter with its two NMS calls, RoIAlign, box head and predictor,
  postprocess with its NMS), each timed alone with CUDA events between
  synchronisations (least of ``--iters`` runs), and their sum;
* a whole ``detect`` call the same way;
* from ``torch.profiler`` over three whole ``detect`` calls: the card's busy
  time (the union of its kernels' intervals) against the wall time, hence its
  idle share, and the kernels that take the most device time, by name.

Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SETTINGS = dict(num_classes=91, rpn_pre_nms_top_n=1000, rpn_post_nms_top_n=300, max_detections=100)
CLS_SCALE = {"fasterrcnn_resnet50_fpn": 2.0, "fasterrcnn_resnet50_fpn_v2": 4.0}  # as chip_smoke.py
SIZES = [(480, 640), (640, 427), (512, 512), (427, 640), (640, 480), (375, 500), (500, 375), (640, 640)]


def least_ms(fn, iters: int) -> float:
    """Least time of ``fn`` over ``iters`` runs, each between synchronisations, from CUDA events."""
    best = float("inf")
    for _ in range(iters + 1):  # the first run warms up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def busy_ms(events) -> float:
    """Length of the union of the device intervals of the profiler's kernel events, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # the profiler's times are microseconds


def breakdown(name: str, dtype: torch.dtype, images, iters: int) -> None:
    from cpu_vision_tpu_torch import _dtype, models
    from cpu_vision_tpu_torch.models import detection
    from cpu_vision_tpu_torch.ops.poolers import multiscale_roi_align

    model = models.get_model(name, dtype=dtype, generator=torch.Generator().manual_seed(0), **SETTINGS)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(CLS_SCALE[name])
    transform = detection.GeneralizedRCNNTransform(min_size=320, max_size=640)
    batch, _, _ = transform(images)
    size = (batch.shape[1], batch.shape[2])
    heads = model.roi_heads
    state = {}

    def run(stage):
        with _dtype.full_float32(), torch.no_grad():
            if stage == "transform":
                transform(images)
            elif stage == "body":
                state["c"] = model.backbone.body(batch, features_only=True)
            elif stage == "fpn":
                fpn = model.backbone.fpn(state["c"])
                state["p"] = [fpn[k] for k in sorted(fpn)] + [model.backbone.extra_pool(fpn["layer4"])]
            elif stage == "rpn head":
                state["head"] = model.rpn.head(state["p"])
            elif stage == "rpn filter (2 NMS)":
                anchors = model.rpn.anchors(size, state["p"])
                state["props"], _ = model.rpn.filter_proposals(*state["head"], anchors, size)
            elif stage == "roi align":
                n, k = state["props"].shape[:2]
                idx = torch.arange(n, dtype=state["props"].dtype, device=batch.device).repeat_interleave(k)
                rois = torch.cat([idx[:, None], state["props"].reshape(-1, 4)], dim=1)
                scales = [2.0 ** round(np.log2(f.shape[1] / size[0])) for f in state["p"][:-1]]
                state["pooled"] = multiscale_roi_align(state["p"][:-1], rois, (7, 7), scales)
            elif stage == "box head + predictor":
                cl, bd = heads.box_predictor(heads.box_head(state["pooled"]))
                n, k = state["props"].shape[:2]
                state["out"] = cl.reshape(n, k, -1), bd.reshape(n, k, -1, 4)
            elif stage == "postprocess (1 NMS)":
                heads.postprocess(*state["out"], state["props"], size)

    stages = ["transform", "body", "fpn", "rpn head", "rpn filter (2 NMS)", "roi align", "box head + predictor",
              "postprocess (1 NMS)"]
    times = {}
    for stage in stages:
        times[stage] = least_ms(lambda: run(stage), iters)
    whole = least_ms(lambda: detection.detect(model, images), iters)
    total = sum(times.values())
    label = f"{name} {str(dtype).replace('torch.', '')} b{len(images)}"
    print(f"{label}: detect {whole:.4f} ms (least of {iters}); stages alone sum to {total:.4f} ms")
    for stage in stages:
        print(f"  {stage:22s} {times[stage]:9.4f} ms  {100 * times[stage] / total:5.1f}%")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            detection.detect(model, images)
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end)
    busy = busy_ms(prof.events())
    print(f"  profiler over 3 calls: wall {wall:.4f} ms, card busy {busy:.4f} ms, idle share {1 - busy / wall:.4f}")
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = sorted(((e.key, e.device_time_total / 1e3 / 3, e.count // 3) for e in kernels
                        if e.device_time_total > 0), key=lambda r: -r[1])
    for key, ms, count in by_kernel[:12]:
        print(f"    {ms:9.4f} ms a call  x{count:<5d} {key[:100]}")
    nms = [r for r in by_kernel if "nms_sorted" in r[0]]
    if nms:
        print(f"    nms_sorted_kernel: {nms[0][1]:.4f} ms a call over {nms[0][2]} launches")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_detection_breakdown: no CUDA card", file=sys.stderr)
        return 1
    import subprocess

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    rng = np.random.default_rng(2)  # chip_smoke.py's images
    images = [torch.from_numpy(rng.random((h, w, 3), dtype=np.float32)).cuda() for h, w in SIZES[: args.batch]]
    for name, dtype in (("fasterrcnn_resnet50_fpn", torch.bfloat16), ("fasterrcnn_resnet50_fpn", torch.float32),
                        ("fasterrcnn_resnet50_fpn_v2", torch.float32)):
        breakdown(name, dtype, images, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
