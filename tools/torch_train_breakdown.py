#!/usr/bin/env python3
"""Where a ViT-B/16 training step's time goes on the card.

Run from the repository root on a machine with an NVIDIA card:

    python3 tools/torch_train_breakdown.py [--batch 128] [--routes kernel,plain]

It builds ``vit_b_16`` in bfloat16 (weights from seed 0) on each route
(``kernel``: ``attention_block`` + ``mlp_block`` in every layer, the JAX
package's rule; ``plain``: the stock-operator sub-blocks) and takes SGD steps
(lr 0.1, momentum 0.9; cross entropy of float32 logits, as ``chip_smoke.py``)
on ``--batch`` random 224x224 images.  After two warm-up steps it prints for
each route:

* one step split on the card's clock by CUDA events recorded between its
  phases (forward, backward, optimizer update), with the backward's share;
* one steady step under ``torch.profiler``: the wall time, the card's busy
  time (the union of its kernels' intervals) and idle share, and the kernels
  that take the most device time, by name, with the share of the busy time
  that the port's own kernels take;
* the peak of device memory over those steps, and the launches each kernel
  wrapper of the port counted in the profiled step.

Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_detection_breakdown import busy_ms  # noqa: E402

# the port's own kernels, by a part of their mangled names
OWN_KERNELS = ("tc_gemm_kernel", "ln_rows_kernel", "attention_tc_kernel", "wgrad_bf16_kernel", "wgrad_reduce_kernel",
               "ln_backward_kernel", "attention_bwd_kernel")
ROUTES = {"kernel": {}, "plain": dict(attention="plain", mlp="plain")}


def phases(model, opt, batch):
    """One training step as ``parallel.make_train_step`` takes it, with CUDA events between its phases:
    {phase: device ms}."""
    from cpu_vision_tpu_torch import _dtype

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model.zero_grad(set_to_none=True)
    ev[0].record()
    with _dtype.full_float32():
        loss = F.cross_entropy(model(batch[0], train=True).float(), batch[1])
        ev[1].record()
        loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    ev[3].synchronize()
    return {"forward": ev[0].elapsed_time(ev[1]), "backward": ev[1].elapsed_time(ev[2]),
            "optimizer": ev[2].elapsed_time(ev[3])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--routes", default="kernel,plain")
    parser.add_argument("--top", type=int, default=16)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_breakdown: no CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from cpu_vision_tpu_torch import models, parallel
    from cpu_vision_tpu_torch.ops import kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    batch = (torch.from_numpy(rng.random((args.batch, 224, 224, 3), dtype=np.float32)).to(dev),
             torch.from_numpy(rng.integers(0, 1000, args.batch)).to(dev))
    state = models.get_model("vit_b_16", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).state_dict()
    for route in args.routes.split(","):
        model = models.get_model("vit_b_16", dtype=torch.bfloat16, **ROUTES[route])
        model.load_state_dict(state)
        label = f"vit_b_16 train bf16 b{args.batch}, {route} routes {model.routes(train=True)}"
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        step = parallel.make_train_step(
            lambda m, b: (F.cross_entropy(m(b[0], train=True).float(), b[1]), {}), opt)
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step(model, batch)
        split = phases(model, opt, batch)
        total = sum(split.values())
        print(f"{label}: one step on the card's clock {total:.4f} ms: "
              + ", ".join(f"{k} {v:.4f} ({100 * v / total:.1f}%)" for k, v in split.items()))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(model, batch)
            end.record()
            end.synchronize()
        wall = start.elapsed_time(end)
        busy = busy_ms(prof.events())
        print(f"  profiled step: wall {wall:.4f} ms, card busy {busy:.4f} ms, idle share {1 - busy / wall:.4f}; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        counts = {name: n for name, n in kernels.launch_counts().items() if n}
        print(f"  launches in that step: {counts}")
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kernel = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in rows if e.device_time_total > 0),
                           key=lambda r: -r[1])
        own = sum(ms for key, ms, _ in by_kernel if any(k in key for k in OWN_KERNELS))
        print(f"  the port's kernels: {own:.4f} ms, {100 * own / busy:.1f}% of the busy time; "
              f"{len(by_kernel)} kernels by name")
        for key, ms, count in by_kernel[:args.top]:
            print(f"    {ms:9.4f} ms  {100 * ms / busy:5.1f}%  x{count:<5d} {key[:110]}")
        del model, opt, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
