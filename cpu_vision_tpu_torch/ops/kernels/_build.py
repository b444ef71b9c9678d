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
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["NVCC_FLAGS", "build", "load"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3",
    "--fmad=false",  # no a*b+c contraction: sums round as the plain twins' do
    "-std=c++17",
    "-shared",
    "-Xcompiler", "-fPIC",
]

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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC_DIR), "-o", str(tmp), str(src)]
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
