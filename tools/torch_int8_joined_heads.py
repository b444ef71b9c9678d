#!/usr/bin/env python3
"""How far ``attention_block_int8``'s joined heads (its attention core's int8
output, which the output product reads) stand from the twin's
``quantize_i8(o)`` on the card.

Run from the repository root on a machine with an NVIDIA card:

    python3 tools/torch_int8_joined_heads.py

For bfloat16 and float32, at the card tests' shapes (``tests/test_torch_cuda.py``:
ViT-B/16, ViT-H/14, D 1024, small and ragged S, head dims 16, 64 and 80) and at
ViT-B/16 b256's, with per-channel and with scalar activation scales drawn as
those tests draw them (numpy, seed 0), it prints the most int8 steps between the
kernels' joined heads and the twin's and how many values stand a step apart.
These numbers set ``JOINED_FLIPS`` of ``chip_smoke.py`` and the card tests.  It
also prints the card's name and power limit and the registers, shared memory and
blocks an SM of every attention core instantiation
(``flash_attention.kernel_info``).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from cpu_vision_tpu_torch.ops.kernels import flash_attention, int8_transformer  # noqa: E402

SHAPES = ((4, 197, 768, 12), (2, 257, 1280, 16), (3, 50, 1024, 16), (2, 33, 256, 4), (1, 5, 64, 4), (2, 257, 32, 2),
          (2, 70, 32, 2), (2, 257, 160, 2), (2, 70, 160, 2), (256, 197, 768, 12), (1, 5, 32, 2), (1, 9, 160, 2),
          (8, 17, 64, 4))


def block_args(rng, n, s, d, heads, dtype, per_channel):
    """attention_block_int8's arguments, drawn as tests/test_torch_cuda.py's _int8_attn_args draws them."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda")

    x = t(rng.standard_normal((n, s, d))).to(dtype)
    g, b = t(rng.uniform(0.5, 1.5, d)), t(rng.standard_normal(d) * 0.1)
    a1 = t(rng.uniform(0.02, 0.05, d) if per_channel else 0.04)
    ao = t(rng.uniform(0.01, 0.03, d) if per_channel else 0.02)
    qwqkv, sqkv = int8_transformer.quantize_weight(t(rng.standard_normal((d, 3 * d)) * d ** -0.5) * a1.reshape(-1, 1))
    qwo, so = int8_transformer.quantize_weight(t(rng.standard_normal((d, d)) * d ** -0.5) * ao.reshape(-1, 1))
    return (x, g, b, qwqkv, sqkv, t(rng.standard_normal(3 * d) * 0.1), qwo, so, t(rng.standard_normal(d) * 0.1), a1,
            ao, heads, (d // heads) ** -0.5)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for name in flash_attention.KERNEL_INFO:
        print(name, flash_attention.kernel_info(name))
    rng = np.random.default_rng(0)
    for dtype in (torch.bfloat16, torch.float32):
        for n, s, d, heads in SHAPES:
            for per_channel in (True, False):
                args = block_args(rng, n, s, d, heads, dtype, per_channel)
                steps = (int8_transformer.attention_block_int8_joined(*args).int()
                         - int8_transformer.attention_block_int8_joined_plain(*args).int()).abs()
                apart = int((steps > 0).sum())
                print(f"{str(dtype)[6:]} ({n}, {s}, {d}, {heads}) per_channel={per_channel}: most {int(steps.max())} "
                      f"step, {apart} of {steps.numel()} apart = {apart / steps.numel():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
