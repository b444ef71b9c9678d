#!/usr/bin/env python3
"""Time ``kernels.mlp_block`` at ViT-B/16's shape in several checkouts, one after another on one card.

    python3 tools/torch_mlp_block_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (``.`` for the one the
script lies in; an older commit unpacked with ``git archive`` under ``build/``).
For each, in the order given, a fresh process builds that tree's kernels,
prints the registers and spills ``ptxas`` reports for the ``mlp_block_kernel``
instantiations at D 768, holds the kernel against its twin, and reads the
kernel's time on (50,432, 768) bfloat16 tokens with a hidden dim of 3072 and on
(12,608, 768) float32 tokens: READINGS readings of CALLS calls each, from CUDA
events.  Name a tree more than once (parent, change, change, parent) to see
the spread between readings of one build beside the difference between builds.
Only positional arguments that every version of ``mlp_block`` takes are passed.
"""

import json
import os
import re
import subprocess
import sys

READINGS, CALLS = 5, 5


def worker() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    from cpu_vision_tpu_torch.ops import kernels
    from cpu_vision_tpu_torch.ops.kernels import _build, transformer_block

    logs = _build.build(ptxas_verbose=True)
    name, found = "", []
    for line in logs.get("transformer_block", "").splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
        # D is a template argument (Li768E), or the number of 256-column groups in the first version (Li3E)
        if "mlp_block_kernel" in name and re.search(r"Li768E|mlp_block_kernelI\w+?Li3EE", name):
            if "spill" in line or "Used" in line:
                found.append(f"{name[name.index('mlp_block_kernel'):]}: {line.strip()}")
    print("\n".join(found) or "(kernels were built before: no compiler output)")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    d, dh = 768, 3072
    out = {}
    for dtype, tokens in ((torch.bfloat16, 256 * 197), (torch.float32, 64 * 197)):
        def normal(shape, dt, std=1.0, mean=0.0):
            return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dt)

        args = (normal((tokens, d), dtype), normal((d,), torch.float32, 0.2, 1.0), normal((d,), torch.float32, 0.1),
                normal((d, dh), dtype, d ** -0.5), normal((dh,), torch.float32, 0.1),
                normal((dh, d), dtype, dh ** -0.5), normal((d,), torch.float32, 0.1), 1e-6)
        got, twin = kernels.mlp_block(*args), transformer_block.mlp_block_plain(*args)
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
        err = (got.float() - twin.float()).abs()
        if not bool((err <= tol * (1 + twin.float().abs())).all()):
            raise AssertionError(f"mlp_block {dtype} disagrees with its twin: max |err| {float(err.max())}")
        readings = []
        for _ in range(READINGS):
            kernels.mlp_block(*args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                kernels.mlp_block(*args)
            end.record()
            end.synchronize()
            readings.append(start.elapsed_time(end) / CALLS)
        out[str(dtype).replace("torch.", "")] = readings
    print(json.dumps({"tree": os.getcwd(), "mlp_block_ms": out}))
    return 0


def main() -> int:
    if sys.argv[1:] == ["--worker"]:
        return worker()
    if not sys.argv[1:]:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    for tree in sys.argv[1:]:
        print(f"--- {tree}", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"], cwd=tree, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
