#!/usr/bin/env python3
"""Run the port's transformer kernels on the CPU, with no card and no ``nvcc``.

The sources ``cpu_vision_tpu_torch/csrc/attention.cu`` and
``transformer_block.cu`` (with ``attention.cuh``) are rewritten a little,
compiled with ``g++ -std=c++20`` against the stand-in headers beside this file,
and loaded in place of the libraries ``nvcc`` would build.  The kernels then
run one ``std::thread`` per CUDA thread, block after block, so the wrappers in
``cpu_vision_tpu_torch.ops.kernels`` can be driven end to end on CPU tensors:
argument order, strides, tiling, masking of ragged edges, barriers (a missing
one usually shows as a NaN out of the poisoned shared memory, or as a wrong
number) and the arithmetic itself.  It is thousands of times slower than the
card and says nothing of speed, registers or what ``nvcc`` accepts.

    with emulate.kernels_on_cpu(build_dir):  # emulate: this file, imported by its path
        out = kernels.mlp_block(x, ...)      # CPU tensors, through the CUDA source

or, from the repository root, ``python3 tools/cuda_emu/emulate.py`` for a
self-check of the three kernels against their plain twins.

Covered: ``__global__`` templates, ``threadIdx``/``blockIdx``, ``__syncthreads``,
``__shfl_xor_sync`` on floats, dynamic shared memory declared as
``extern __shared__ __align__(16) float smem[];``, static ``__shared__`` arrays,
``float4``, ``__nv_bfloat16`` with its two conversions, ``cudaFuncSetAttribute``
and the ``<<<...>>>`` launch.  Not covered: everything else (``stencil.cu`` and
``conv_block.cu`` use typed shared arrays and ``__syncthreads_or``); extend the
headers as a source needs.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Iterator

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
CSRC = REPO / "cpu_vision_tpu_torch" / "csrc"
STEMS = ("attention", "transformer_block")

_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;(]*>)?)<<<([^;]*?)>>>\(([^;]*?)\);", re.S)


def translate(text: str) -> str:
    """CUDA C++ of the covered subset as C++ for the stand-in headers."""
    text = text.replace("extern __shared__ __align__(16) float smem[];", "float* smem = emu_shared;")
    text = text.replace("__shared__", "static")
    return _LAUNCH.sub(r"emu_launch(\2, [=] { \1(\3); });", text)


def compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the emulation needs a C++20 compiler")
    return found


def build(build_dir) -> Path:
    """Translate and compile ``STEMS`` into ``build_dir``; returns it."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (build_dir / header.name).write_text(translate(header.read_text()))
    jobs = []
    for stem in STEMS:
        source = build_dir / f"{stem}.cpp"
        source.write_text(translate((CSRC / f"{stem}.cu").read_text()))
        cmd = [compiler(), "-std=c++20", "-O1", "-shared", "-fPIC", "-I", str(build_dir), "-I", str(HERE),
               "-o", str(build_dir / f"lib{stem}.so"), str(source), "-lpthread"]
        jobs.append((stem, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for stem, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {stem}:\n{log}")
    return build_dir


@contextlib.contextmanager
def kernels_on_cpu(build_dir) -> Iterator[None]:
    """Inside, the wrappers of ``flash_attention`` and ``transformer_block``
    take CPU tensors through the emulated CUDA sources instead of the twins.
    Builds into ``build_dir`` unless the libraries are there already."""
    sys.path.insert(0, str(REPO))
    from cpu_vision_tpu_torch.ops.kernels import _build, flash_attention, transformer_block

    build_dir = Path(build_dir)
    if not all((build_dir / f"lib{stem}.so").exists() for stem in STEMS):
        build(build_dir)

    def launch(lib, name, x, *args):
        err = getattr(lib, name)(*args, None)
        if err != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")

    saved = (_build.load, _build.on_card, _build.launch)
    _build.load = lambda stem: ctypes.CDLL(str(build_dir / f"lib{stem}.so"))
    _build.on_card = lambda x: True
    _build.launch = launch
    flash_attention._c_lib = transformer_block._c_lib = None
    try:
        yield
    finally:
        _build.load, _build.on_card, _build.launch = saved
        flash_attention._c_lib = transformer_block._c_lib = None


def main() -> int:
    import tempfile

    import torch

    sys.path.insert(0, str(REPO))
    from cpu_vision_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(0)

    def normal(shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen) * std + mean).to(dtype)

    worst = 0.0
    with tempfile.TemporaryDirectory() as tmp, kernels_on_cpu(tmp):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q, k, v = (normal((1, 70, 2, 16), dtype) for _ in range(3))
            pairs = [("flash_mha", kernels.flash_mha(q, k, v, 0.25), kernels.flash_mha_plain(q, k, v, 0.25))]
            d, dh = 256, 512  # four heads of 64
            ln = (normal((d,), torch.float32, 0.2, 1.0), normal((d,), torch.float32, 0.1))
            attn = (normal((2, 37, d), dtype), *ln, normal((d, 3 * d), dtype, d ** -0.5), normal((3 * d,), torch.float32, 0.1),
                    normal((d, d), dtype, d ** -0.5), normal((d,), torch.float32, 0.1), 4, 0.125)
            pairs.append(("attention_block", kernels.attention_block(*attn), kernels.attention_block_plain(*attn)))
            mlp = (normal((37, d), dtype), *ln, normal((d, dh), dtype, d ** -0.5), normal((dh,), torch.float32, 0.1),
                   normal((dh, d), dtype, dh ** -0.5), normal((d,), torch.float32, 0.1))
            pairs.append(("mlp_block", kernels.mlp_block(*mlp), kernels.mlp_block_plain(*mlp)))
            for name, out, ref in pairs:
                err = (out.float() - ref.float()).abs()
                ok = bool((err <= tol + tol * ref.float().abs()).all())
                print(f"{name} {dtype}: max |err| {float(err.max()):.3e} {'ok' if ok else 'FAILED'}")
                worst = max(worst, 0.0 if ok else 1.0)
    return int(worst)


if __name__ == "__main__":
    sys.exit(main())
