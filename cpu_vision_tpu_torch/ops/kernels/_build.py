"""Build and load the port's CUDA kernels.

Every source ``cpu_vision_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc``
into its own shared library ``lib<name>.so`` with a plain C interface, which
is loaded with ``ctypes``.  Libraries land in
``build/cvt_torch_kernels/<hash>/`` beside the package, where the hash covers
every source, header and flag: an edited source rebuilds, an unchanged one
loads at once.  All sources that need building compile in parallel, one
``nvcc`` each.  Nothing is built at import; the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

__all__ = ["NVCC_FLAGS", "SOURCE_FLAGS", "build", "load", "sass_counts", "on_card", "launch", "count_launch",
           "count_plain_route", "reset_count"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler", "-fPIC",
]

# Flags of single sources, by stem.  The stencil, NMS and int8 kernels must
# equal their twins bit for bit, or round their int8 values where the twins
# do, so no a*b+c is contracted there; the convolution is held to a tolerance
# and keeps the fused multiply-add.
SOURCE_FLAGS = {"stencil": ["--fmad=false"], "nms": ["--fmad=false"], "int8_matmul": ["--fmad=false"],
                "int8_transformer": ["--fmad=false"]}

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "cvt_torch_kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")
    return found


def _build_dir() -> Path:
    digest = hashlib.sha256(repr((NVCC_FLAGS, sorted(SOURCE_FLAGS.items()))).encode())
    for f in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build(ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source stem: compiler output}`` for the sources compiled now
    (with ``ptxas_verbose``, each kernel's registers, shared memory and
    spills).  Raises ``RuntimeError`` if any compile fails, after every
    compiler process has ended.
    """
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.stem, []), *extra, "-I", str(CSRC_DIR),
               "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    logs, failures = {}, []
    for src, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[src.stem] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(stem: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<stem>.cu``, building it first if needed."""
    path = _build_dir() / f"lib{stem}.so"
    if not path.exists():
        build()
    return ctypes.CDLL(str(path))


def sass_counts(stem: str, opcode: str, suffix: str = "") -> Dict[str, int]:
    """``{mangled kernel name: instructions of ``opcode``}`` in the machine code
    (SASS) of ``lib<stem>.so``, from ``cuobjdump --dump-sass`` (built first if
    needed); ``opcode`` ``"HGMMA"`` counts the tensor-core products of wgmma,
    and a ``suffix`` keeps those whose modifiers hold it (``".TF32"``,
    ``".BF16"``: ``HGMMA.64x128x8.F32.TF32``)."""
    path = _build_dir() / f"lib{stem}.so"
    if not path.exists():
        build()
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and re.search(rf"\b{re.escape(opcode)}(\.\S*)?{re.escape(suffix)}\b", line):
            counts[name] += 1
    return counts


def on_card(x: torch.Tensor) -> bool:
    """Whether a wrapper given ``x`` launches its kernel (a CUDA tensor) or
    runs its plain twin (a CPU tensor); any other device is refused."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"expected a CPU or CUDA tensor, got one on {x.device}")


def launch(lib: ctypes.CDLL, name: str, x: torch.Tensor, *args) -> None:
    """Call the launcher ``name`` of ``lib`` with ``args`` and ``x``'s current
    stream, on ``x``'s card; raise if the launch is refused."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def reset_count(fn) -> None:
    """Set the wrapper ``fn``'s launch counts to 0."""
    fn.launches = 0
    fn.launches_by_shape = {}
    fn.plain_routes = 0


def count_plain_route(fn) -> None:
    """Add one to ``fn.plain_routes``: a ``None`` route sent an input that the
    kernel of the wrapper ``fn`` does not take to its plain twin (a decision by
    shape, made on either device)."""
    fn.plain_routes += 1


def count_launch(fn, x: torch.Tensor) -> None:
    """Add one launch to the wrapper ``fn``'s count, overall (``fn.launches``)
    and under the shape and dtype of the kernel's input ``x``
    (``fn.launches_by_shape[(shape, dtype)]``).  Called where a wrapper has
    launched its kernel, and nowhere else."""
    fn.launches += 1
    key = (tuple(x.shape), x.dtype)
    fn.launches_by_shape[key] = fn.launches_by_shape.get(key, 0) + 1
