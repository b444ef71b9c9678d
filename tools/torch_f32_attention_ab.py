#!/usr/bin/env python3
"""Time the float32 ``attention_block`` and ``window_attention_block`` of one or
more trees of this repository in turns on one card, each in its own process.

    python3 tools/torch_f32_attention_ab.py TREE [TREE ...]

A TREE is the root of a checkout (``.`` for this one; an older commit unpacked
with ``git archive`` under ``build/``).  For each TREE in the order given, then
in reverse, a process imports that tree's ``cpu_vision_tpu_torch`` (its kernels
built from its own ``csrc/``) and, on inputs made from seed 0, times on the
device clock (CUDA events, 5 calls after one) ``attention_block`` at ViT-B/16
b64's (64, 197, 768) and ``window_attention_block`` v1 (shifted, masked) at
Swin-T's four stages at batch 256 and batch 32 (C 96-768, 49 tokens a window),
each beside its plain twin's error (``max|a - twin|``, the float32 rule
``2e-4·(1 + |twin|)`` checked); it prints one JSON line a run, with the card's
name and power limit.  Exits 1 if a run fails or a check does not hold.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = "--child"


def child(tree: str) -> int:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from cpu_vision_tpu_torch.models import swin
    from cpu_vision_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=gen, device=dev) * std + mean

    def device_ms(fn, calls=5):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    def held(out, twin):
        return bool(((out - twin).abs() <= 2e-4 + 2e-4 * twin.abs()).all()), float((out - twin).abs().max())

    rows = []
    d, heads = 768, 12
    args = (normal((64, 197, d)), normal((d,), 0.2, 1.0), normal((d,), 0.1), normal((d, 3 * d), d ** -0.5),
            normal((3 * d,), 0.1), normal((d, d), d ** -0.5), normal((d,), 0.1), heads, 64 ** -0.5, 1e-6)
    ok, err = held(kernels.attention_block(*args), kernels.attention_block_plain(*args))
    rows.append(dict(case="attention_block (64, 197, 768)", ms=device_ms(lambda: kernels.attention_block(*args)),
                     held=ok, max_abs_err=err))
    del args
    for batch in (256, 32):
        for c, side in ((96, 56), (192, 28), (384, 14), (768, 7)):
            nw_img, n_heads = (side // 7) ** 2, c // 32
            mask = swin._shift_mask(side, side, 7, 3 if nw_img > 1 else 0, 3 if nw_img > 1 else 0).to(dev)
            args = (normal((batch * nw_img, 49, c)), normal((c,), 0.2, 1.0), normal((c,), 0.1),
                    normal((c, 3 * c), c ** -0.5), normal((3 * c,), 0.1), normal((c, c), c ** -0.5), normal((c,), 0.1),
                    normal((n_heads, 49, 49), 0.3), mask, None, n_heads, 32 ** -0.5, 1e-5, False, nw_img, 0)
            ok, err = held(kernels.window_attention_block(*args), kernels.window_attention_block_plain(*args))
            rows.append(dict(case=f"window_attention_block b{batch} {side}x{side}x{c}", held=ok, max_abs_err=err,
                             ms=device_ms(lambda: kernels.window_attention_block(*args))))
            del args
    print(json.dumps({"tree": tree, "rows": rows}))
    return 0 if all(r["held"] for r in rows) else 1


def main() -> int:
    if sys.argv[1:2] == [CHILD]:
        return child(sys.argv[2])
    trees = sys.argv[1:] or ["."]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    failed = False
    for tree in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        done = subprocess.run([sys.executable, __file__, CHILD, tree], capture_output=True, text=True, env=env)
        print(done.stdout.strip() or done.stderr[-2000:])
        failed |= done.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
