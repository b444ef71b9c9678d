#!/usr/bin/env python3
"""Where an int8 serving forward's time goes on the card.

Run from the repository root on a machine with an NVIDIA card:

    python3 tools/torch_int8_breakdown.py [--batch 256]

It builds the int8 engines of ``chip_smoke.py`` (``Int8ViT`` over
``vit_b_16`` in bfloat16, calibrated on the first 8 images; ``Int8ResNet``
over ``resnet50`` with its batch norms perturbed from seed 1, calibrated on
the first 32; weights from seed 0) and, on ``--batch`` random 224x224 images,
prints for each, from ``torch.profiler`` over three forwards: the wall time,
the card's busy time (the union of its kernels' intervals) and idle share, and
the kernels that take the most device time, by name, with the share of the
busy time that the port's own kernels take.

Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_detection_breakdown import busy_ms  # noqa: E402

OWN_KERNELS = ("i8_tc_gemm_kernel", "ln_quant_rows_kernel", "attention_tc_kernel", "attention_core_kernel")


def profile_forward(label: str, forward) -> None:
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            forward()
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end) / 3
    busy = busy_ms(prof.events()) / 3
    print(f"{label}: wall {wall:.4f} ms a forward, card busy {busy:.4f} ms, idle share {1 - busy / wall:.4f}")
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = sorted(((e.key, e.device_time_total / 1e3 / 3, e.count // 3) for e in kernels
                        if e.device_time_total > 0), key=lambda r: -r[1])
    own = sum(ms for key, ms, _ in by_kernel if any(k in key for k in OWN_KERNELS))
    print(f"  the port's kernels: {own:.4f} ms a forward, {100 * own / busy:.1f}% of the busy time")
    for key, ms, count in by_kernel[:14]:
        print(f"    {ms:9.4f} ms a forward  {100 * ms / busy:5.1f}%  x{count:<4d} {key[:110]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=256)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_breakdown: no CUDA card", file=sys.stderr)
        return 1
    from cpu_vision_tpu_torch import models

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    images = torch.from_numpy(np.random.default_rng(0).random((args.batch, 224, 224, 3), dtype=np.float32)).to(dev)

    vit = models.get_model("vit_b_16", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    veng = models.Int8ViT.from_model(vit).calibrate([images[:8]])
    del vit
    profile_forward(f"Int8ViT vit_b_16 bf16 b{args.batch}", lambda: veng(images))
    del veng

    r50 = models.get_model("resnet50", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():  # as chip_smoke.py: else each block's last batch-norm scale is 0
        for m in r50.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.1, 0.1, generator=gen)
                m.running_mean.uniform_(-0.3, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    reng = models.Int8ResNet.from_model(r50).calibrate([images[:32]])
    profile_forward(f"Int8ResNet resnet50 b{args.batch}", lambda: reng(images))
    stock = models.Int8ResNet.from_model(r50, conv1x1="stock").set_scales(reng.scales)
    profile_forward(f"Int8ResNet resnet50 b{args.batch}, conv1x1=\"stock\"", lambda: stock(images))
    return 0


if __name__ == "__main__":
    sys.exit(main())
