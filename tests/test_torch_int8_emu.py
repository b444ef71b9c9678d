"""``mlp_block_int8``'s CUDA source (``csrc/int8_transformer.cu``: the LayerNorm
rows quantised to int8, then the up- and the down-projection on ``wgmma`` s8
with int32 sums) run on the CPU through ``tools/cuda_emu``, against the plain
twin ``mlp_block_int8_plain``.

The emulator compiles the source with ``g++`` against stand-in headers, one
thread per CUDA thread (see ``tests/test_torch_attention_cores_emu.py``); its
s8 products read the int8 tiles through the descriptors and the 128-byte
swizzle and sum in int32.  The shapes are small and ragged: 37 and 70 tokens
(one row tile of 128, most of it past m), D 256 (two k tiles of the
up-projection), Dh 256 and 512 (two and four column tiles; two and four k
tiles of the down-projection), in bfloat16 and float32.  Tolerance: the card
test's rule, ``max |a - b| / (1 + |b|) <= 2e-2``.  Without ``g++`` the tests
skip.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import int8_transformer

_EMULATE = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"


@pytest.fixture(autouse=True)
def _launch_counts_at_zero_after():
    """The emulated kernels count their launches; later tests in this process expect CPU tensors to have launched
    nothing."""
    yield
    kernels.reset_launch_counts()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulator module with the int8 sub-blocks' library built into a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the CUDA emulation needs a C++20 compiler")
    spec = importlib.util.spec_from_file_location("cuda_emulate", _EMULATE)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    build_dir = tmp_path_factory.mktemp("cuda_emu_int8")
    emulate.build(build_dir, ("int8_transformer",))
    return emulate, build_dir


def _mlp_args(rng, m, d, dh, dtype):
    """The inputs of ``tests/test_torch_cuda.py::test_mlp_block_int8_matches_twin``, on the CPU."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    x = t(rng.standard_normal((m, d))).to(dtype)
    g, b = t(rng.uniform(0.5, 1.5, d)), t(rng.standard_normal(d) * 0.1)
    a1, a2 = t(rng.uniform(0.02, 0.05, d)), t(rng.uniform(0.005, 0.02, dh))
    qw1, s1 = int8_transformer.quantize_weight(t(rng.standard_normal((d, dh)) * d ** -0.5) * a1.reshape(-1, 1))
    qw2, s2 = int8_transformer.quantize_weight(t(rng.standard_normal((dh, d)) * dh ** -0.5) * a2.reshape(-1, 1))
    return x, g, b, qw1, s1, t(rng.standard_normal(dh) * 0.1), qw2, s2, t(rng.standard_normal(d) * 0.1), a1, a2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,dh", [(37, 256), (37, 512), (70, 256), (70, 512)])
def test_mlp_block_int8_on_s8_products(emulated, m, dh, dtype):
    emulate, build_dir = emulated
    args = _mlp_args(np.random.default_rng(m + dh), m, 256, dh, dtype)
    with emulate.kernels_on_cpu(build_dir, ("int8_transformer",)):
        got = kernels.mlp_block_int8(*args)
        # one wrapper launch, three kernels: LN rows to int8, the up- and the down-projection
        assert kernels.mlp_block_int8.launches == 1 and kernels.mlp_block_int8.kernel_launches == 3
        again = kernels.mlp_block_int8(*args)
    want = int8_transformer.mlp_block_int8_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert float(((got.float() - want.float()).abs() / (1 + want.float().abs())).max()) <= 2e-2
    assert torch.equal(got, again)  # exact int32 sums and a fixed order of the f32 steps: the same bits twice
