#!/usr/bin/env python3
"""Time the bfloat16 v2 ``window_attention_block`` of one or more trees of this repository in turns on one card,
each in its own process.

    python3 tools/torch_window_v2_ab.py [--rounds N] TREE [TREE ...]

A TREE is the root of a checkout (``.`` for this one; an older commit unpacked with ``git archive`` under
``build/``).  For each TREE in the order given, then in reverse, a process imports that tree's
``cpu_vision_tpu_torch`` (its kernels built from its own ``csrc/``) and, on inputs made from seed 0, times on the
device clock (CUDA events, the least of ``--rounds`` rounds of 20 calls after one) the bf16 v2 block at
``tests/test_torch_cuda.py``'s held shape (4096, 49, 128) with ``ln_count`` 96 and at Swin-V2-T's four stages at
256² batch 64 (windows of 8 x 8 tokens, C 96-768), and apart the device time of the QKV product's launch a call
(``torch.profiler``: a call's launches up to its ``qkv_f64_kernel``, or its first ``tc_gemm_kernel`` where it has
none), each block held to
its own tree's twin by the bf16 rule ``2e-2·(1 + |twin|)``; then a whole Swin-V2-T bf16 forward at 256² batch 64
(weights from seed 0, images from numpy seed 1, the least of ``--rounds`` rounds of 10 calls after one).  It prints
one JSON line a run, with the card's name and power limit first.  Exits 1 if a run fails or a block breaks the rule.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = "--child"


def child(tree: str, rounds: int) -> int:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpu_vision_tpu_torch.models import swin
    from cpu_vision_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def normal(shape, std=1.0, mean=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

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

    def qkv_ms(fn, calls=5):
        """The QKV launch's device ms a call and its kernel's name (None where the profiler missed one)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100000)  # the profiler may miss the first kernels of a window
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        found = [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and ("qkv_f64" in e.name or "tc_gemm" in e.name)]
        if not found or len(found) % calls:
            return None, [n[:60] for n, _ in found[:3]]
        per = len(found) // calls  # the QKV launches of a call: up to its qkv_f64_kernel, else its first product
        chains = [found[i * per:(i + 1) * per] for i in range(calls)]
        qkv = [ch[:next((i for i, (n, _) in enumerate(ch) if "qkv_f64" in n), 0) + 1] for ch in chains]
        return sum(ms for ch in qkv for _, ms in ch) / calls, " + ".join(n[:40] for n, _ in qkv[0])

    def block_args(nw, s, c, nw_img, mask, ln_count=0):
        heads = c // 32
        args = [normal((nw, s, c), dtype=bf16), normal((c,), 0.2, 1.0), normal((c,), 0.1),
                normal((c, 3 * c), c ** -0.5, dtype=bf16), normal((3 * c,), 0.1), normal((c, c), c ** -0.5, dtype=bf16),
                normal((c,), 0.1), normal((heads, s, s), 0.3), mask, normal((heads,), 0.5, 2.3), heads, 32 ** -0.5,
                1e-5, True, nw_img, ln_count]
        args[4][c:2 * c] = 0
        if ln_count:
            for i in (0, 1, 2, 6):
                args[i][..., ln_count:] = 0
            args[3][ln_count:] = 0
            args[5][:, ln_count:] = 0
        return args

    cases = [("held (4096, 49, 128) ln_count 96", block_args(4096, 49, 128, 64, swin._shift_mask(56, 56, 7, 3, 3)
                                                               .to(dev), 96))]
    for c, side in ((96, 64), (192, 32), (384, 16), (768, 8)):
        nw_img = (side // 8) ** 2
        mask = swin._shift_mask(side, side, 8, 4, 4).to(dev) if nw_img > 1 else None
        cases.append((f"swin_v2_t b64 {side}x{side}x{c}", block_args(64 * nw_img, 64, c, nw_img, mask)))
    rows = []
    for name, args in cases:
        out, twin = kernels.window_attention_block(*args), kernels.window_attention_block_plain(*args)
        err = (out.float() - twin.float()).abs()
        ok = bool((err <= 2e-2 * (1 + twin.float().abs())).all())
        del out, twin
        ms = device_ms(lambda: kernels.window_attention_block(*args))
        q_ms, q_kernel = qkv_ms(lambda: kernels.window_attention_block(*args))
        rows.append(dict(case=name, ms=ms, qkv_ms=q_ms, qkv_kernel=q_kernel, held=ok, max_abs_err=float(err.max())))
    del cases, args
    model = swin.swin_v2_t(dtype=bf16, generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(1).random((64, 256, 256, 3), dtype=np.float32)).to(dev)
    with torch.no_grad():
        forward_ms = device_ms(lambda: model(images), 10)
    print(json.dumps({"tree": tree, "rows": rows, "swin_v2_t_b64_forward_ms": forward_ms}))
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
