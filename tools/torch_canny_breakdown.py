#!/usr/bin/env python3
"""Where the time of the PyTorch port's Canny goes on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_canny_breakdown.py

For ``ops.canny`` on the headline scene (1080p, batch 8, thresholds
0.1/0.2) it prints the card's name and power limit, then:

* how many hysteresis sweeps the scene needs to reach its fixpoint;
* for several (sweeps per pass, passes per host check) settings of the
  fixpoint: passes launched, device time of one pass, and the time of the
  whole ``ops.canny`` call from CUDA events;
* the same Canny with ``canny_stage1``'s in-tile hysteresis off and on, on
  the scene and on uniform noise (thresholds 0.3/0.6, many sweeps to the
  fixpoint): time of stage 1, global passes launched, time of one pass and
  of the whole pipeline;
* a ``torch.profiler`` table of device time by kernel over 5 calls at the
  package's own settings.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import scene, time_ms  # noqa: E402
from cpu_vision_tpu_torch import ops  # noqa: E402
from cpu_vision_tpu_torch.ops import kernels  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import stencil  # noqa: E402

SETTINGS = [(8, 8), (8, 2), (8, 1), (4, 2), (4, 1), (2, 1), (16, 1)]


def canny_pipeline(x: torch.Tensor, low: float, high: float, in_tile: bool) -> torch.Tensor:
    """``kernels.fused_canny`` with stage 1's in-tile hysteresis off or on."""
    maps, restore = stencil._gray_maps(x)
    taps = ops.get_gaussian_kernel1d(5, 1.4, device="cpu").numpy()
    cls = stencil._canny_stage1(maps, taps, low, high, in_tile=in_tile)
    return restore((kernels.hysteresis_fixpoint(cls) == 2).to(torch.float32))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_canny_breakdown: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    x = torch.from_numpy(scene(1080, 1920, 8)).cuda()
    cls = kernels.canny_stage1(x[..., 0].contiguous(), 0.1, 0.2)

    cur, sweeps = cls, 0
    while True:
        nxt = kernels.hysteresis_sweeps(cur, 1)
        sweeps += 1
        if torch.equal(nxt, cur):
            break
        cur = nxt
    print(f"hysteresis sweeps to the fixpoint, the unchanged one included: {sweeps}")

    default = stencil.SWEEPS_PER_PASS, stencil.PASSES_PER_CHECK
    try:
        for spp, ppc in SETTINGS:
            stencil.SWEEPS_PER_PASS, stencil.PASSES_PER_CHECK = spp, ppc
            kernels.reset_launch_counts()
            ops.canny(x, 0.1, 0.2)
            passes = kernels.launch_counts()["hysteresis_sweeps"]
            pass_ms = time_ms(lambda: kernels.hysteresis_sweeps(cls, spp), 20)
            canny_ms = time_ms(lambda: ops.canny(x, 0.1, 0.2), 20)
            print(f"sweeps/pass {spp:2d}, passes/check {ppc}: {passes} passes, one pass {pass_ms:.4f} ms, "
                  f"ops.canny {canny_ms:.4f} ms")
    finally:
        stencil.SWEEPS_PER_PASS, stencil.PASSES_PER_CHECK = default

    noise = torch.from_numpy(np.random.default_rng(0).random((8, 1080, 1920, 1), dtype=np.float32)).cuda()
    pass_ms = time_ms(lambda: kernels.hysteresis_sweeps(cls, default[0]), 20)
    for name, img, low, high in (("scene", x, 0.1, 0.2), ("noise", noise, 0.3, 0.6)):
        maps = img[..., 0].contiguous()
        edges = {}
        for in_tile in (False, True):
            kernels.reset_launch_counts()
            edges[in_tile] = canny_pipeline(img, low, high, in_tile)
            passes = kernels.launch_counts()["hysteresis_sweeps"]
            stage1_ms = time_ms(lambda: kernels.canny_stage1(maps, low, high, in_tile_hysteresis=in_tile), 20)
            total_ms = time_ms(lambda: canny_pipeline(img, low, high, in_tile), 20)
            print(f"{name}, in-tile hysteresis {'on ' if in_tile else 'off'}: stage 1 {stage1_ms:.4f} ms, "
                  f"{passes} passes of {pass_ms:.4f} ms, whole Canny {total_ms:.4f} ms")
        if not torch.equal(edges[False], edges[True]):
            raise AssertionError(f"{name}: the in-tile option changed the edges")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ops.canny(x, 0.1, 0.2)
        torch.cuda.synchronize()
    print(f"settings: sweeps/pass {default[0]}, passes/check {default[1]}")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
