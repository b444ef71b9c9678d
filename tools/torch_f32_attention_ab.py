#!/usr/bin/env python3
"""Time the float32 ``attention_block`` and ``window_attention_block`` of one or
more trees of this repository in turns on one card, each in its own process.

    python3 tools/torch_f32_attention_ab.py [--rounds N] TREE [TREE ...]

A TREE is the root of a checkout (``.`` for this one; an older commit unpacked
with ``git archive`` under ``build/``).  For each TREE in the order given, then
in reverse, a process imports that tree's ``cpu_vision_tpu_torch`` (its kernels
built from its own ``csrc/``) and, on inputs made from seed 0, times on the
device clock (CUDA events, the least of ``--rounds`` rounds of 20 calls after
one) ``attention_block`` at ViT-B/16 b64's (64, 197, 768) and
``window_attention_block`` v1 (shifted, masked) at Swin-T's four stages at
batch 256 and batch 32 (C 96-768, 49 tokens a window), and apart the device
time of the attention core's own launch a call (``torch.profiler``'s kernel
intervals over 5 calls: the launch whose name holds ``core``, ``_x3_kernel``
or ``_tc_kernel``, one a call, or null).  Each block is held to its plain
twin (``max|a - twin|``, the float32 rule ``2e-4·(1 + |twin|)``) and the
window blocks to the block in float64 (``max|a - f64| / max|f64|`` no more
than twice the twin's, TF32 off); it prints one JSON line a run, with the
card's name and power limit.  Exits 1 if a run fails or a check does not hold.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = "--child"


def child(tree: str, rounds: int) -> int:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpu_vision_tpu_torch.models import swin
    from cpu_vision_tpu_torch.ops import kernels
    from cpu_vision_tpu_torch.ops.kernels import swin_attention

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=gen, device=dev) * std + mean

    def device_ms(fn, calls=20):
        fn()
        best = float("inf")
        for _ in range(rounds):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / calls)
        return best

    def core_ms(fn, calls=5):
        """The core's device ms a call and its kernel's name, from the profiler (None where it saw no core a call)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100000)  # the profiler may miss the first kernels of a window
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        cores = [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(k in e.name for k in ("core", "_x3_kernel", "_tc_kernel"))]
        if len(cores) != calls:
            return None, [n for n, _ in cores][:2]
        return sum(ms for _, ms in cores) / calls, cores[0][0][:80]

    def held(out, twin):
        return bool(((out - twin).abs() <= 2e-4 + 2e-4 * twin.abs()).all()), float((out - twin).abs().max())

    def far(a, ref64):
        return float((a.double() - ref64).abs().max() / ref64.abs().max())

    rows = []
    d, heads = 768, 12
    args = (normal((64, 197, d)), normal((d,), 0.2, 1.0), normal((d,), 0.1), normal((d, 3 * d), d ** -0.5),
            normal((3 * d,), 0.1), normal((d, d), d ** -0.5), normal((d,), 0.1), heads, 64 ** -0.5, 1e-6)
    ok, err = held(kernels.attention_block(*args), kernels.attention_block_plain(*args))
    ms, core = device_ms(lambda: kernels.attention_block(*args)), core_ms(lambda: kernels.attention_block(*args))
    rows.append(dict(case="attention_block (64, 197, 768)", ms=ms, core_ms=core[0], core_kernel=core[1], held=ok,
                     max_abs_err=err))
    del args
    for batch in (256, 32):
        for c, side in ((96, 56), (192, 28), (384, 14), (768, 7)):
            nw_img, n_heads = (side // 7) ** 2, c // 32
            mask = swin._shift_mask(side, side, 7, 3 if nw_img > 1 else 0, 3 if nw_img > 1 else 0).to(dev)
            args = (normal((batch * nw_img, 49, c)), normal((c,), 0.2, 1.0), normal((c,), 0.1),
                    normal((c, 3 * c), c ** -0.5), normal((3 * c,), 0.1), normal((c, c), c ** -0.5), normal((c,), 0.1),
                    normal((n_heads, 49, 49), 0.3), mask, None, n_heads, 32 ** -0.5, 1e-5, False, nw_img, 0)
            out, twin = kernels.window_attention_block(*args), kernels.window_attention_block_plain(*args)
            ok, err = held(out, twin)
            ref64 = swin_attention._window_attention_block_f64(*args)
            f64_err, twin_f64_err = far(out, ref64), far(twin, ref64)
            del out, twin, ref64
            ms = device_ms(lambda: kernels.window_attention_block(*args))
            core = core_ms(lambda: kernels.window_attention_block(*args))
            rows.append(dict(case=f"window_attention_block b{batch} {side}x{side}x{c}", ms=ms, core_ms=core[0],
                             core_kernel=core[1], held=ok and f64_err <= 2 * twin_f64_err, max_abs_err=err,
                             f64_err=f64_err, twin_f64_err=twin_f64_err))
            del args
    print(json.dumps({"tree": tree, "rows": rows}))
    return 0 if all(r["held"] for r in rows) else 1


def main() -> int:
    if sys.argv[1:2] == [CHILD]:
        return child(sys.argv[2], int(sys.argv[3]))
    args = sys.argv[1:]
    rounds = 3
    if args[:1] == ["--rounds"]:
        rounds, args = int(args[1]), args[2:]
    trees = args or ["."]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    failed = False
    for tree in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        done = subprocess.run([sys.executable, __file__, CHILD, tree, str(rounds)], capture_output=True, text=True,
                              env=env)
        print(done.stdout.strip() or done.stderr[-2000:])
        failed |= done.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
