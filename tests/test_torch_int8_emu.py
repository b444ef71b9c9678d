"""The int8 kernels' CUDA sources run on the CPU through ``tools/cuda_emu``
against their plain twins: ``csrc/int8_transformer.cu`` (``mlp_block_int8``:
the LayerNorm rows quantised to int8, then the up- and the down-projection;
``attention_block_int8``: the LayerNorm rows, the QKV product, the attention
core, the output product) and ``csrc/int8_matmul.cu``
(``int8_matmul_requant``), every product the ``wgmma`` s8 product of
``csrc/int8_gemm.cuh`` with int32 sums.

The emulator compiles the source with ``g++`` against stand-in headers, one
thread per CUDA thread (see ``tests/test_torch_attention_cores_emu.py``); its
s8 products read the int8 tiles through the descriptors and the 128-byte
swizzle and sum in int32.  The shapes are small and ragged: 37 and 70 tokens
(one row tile of 128, most of it past m), D 256 (two k tiles of the
up-projection), Dh 256 and 512 (two and four column tiles; two and four k
tiles of the down-projection), in bfloat16 and float32.  The attention block
at (2, 33, 256, 4) (head dim 64, two k tiles) and (1, 5, 64, 4) (head dim 16,
k 64: half a k tile zero-filled).  Tolerance: the card test's rule, ``max |a
- b| / (1 + |b|) <= 2e-2``.  The requantising product must equal its twin bit
for bit (exact int32 sums, the twin's float32 epilogue), at K 16 (seven of a
tile's eight chunks zero-filled), 96 and 64, N 7 and 200 (ragged: byte and
single stores) and 256, int8 and float32 out.  Without ``g++`` the tests skip.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import int8_matmul, int8_transformer

_EMULATE = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"
_STEMS = ("int8_matmul", "int8_transformer")


@pytest.fixture(autouse=True)
def _launch_counts_at_zero_after():
    """The emulated kernels count their launches; later tests in this process expect CPU tensors to have launched
    nothing."""
    yield
    kernels.reset_launch_counts()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulator module with the int8 libraries built into a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the CUDA emulation needs a C++20 compiler")
    spec = importlib.util.spec_from_file_location("cuda_emulate", _EMULATE)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    build_dir = tmp_path_factory.mktemp("cuda_emu_int8")
    emulate.build(build_dir, _STEMS)
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
    with emulate.kernels_on_cpu(build_dir, _STEMS):
        got = kernels.mlp_block_int8(*args)
        # one wrapper launch, three kernels: LN rows to int8, the up- and the down-projection
        assert kernels.mlp_block_int8.launches == 1 and kernels.mlp_block_int8.kernel_launches == 3
        again = kernels.mlp_block_int8(*args)
    want = int8_transformer.mlp_block_int8_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert float(((got.float() - want.float()).abs() / (1 + want.float().abs())).max()) <= 2e-2
    assert torch.equal(got, again)  # exact int32 sums and a fixed order of the f32 steps: the same bits twice


def _attn_args(rng, n, s, d, heads, dtype):
    """The inputs of ``tests/test_torch_cuda.py::test_attention_block_int8_matches_twin``, on the CPU."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    x = t(rng.standard_normal((n, s, d))).to(dtype)
    g, b = t(rng.uniform(0.5, 1.5, d)), t(rng.standard_normal(d) * 0.1)
    a1, ao = t(rng.uniform(0.02, 0.05, d)), t(rng.uniform(0.01, 0.03, d))
    qwqkv, sqkv = int8_transformer.quantize_weight(t(rng.standard_normal((d, 3 * d)) * d ** -0.5) * a1.reshape(-1, 1))
    qwo, so = int8_transformer.quantize_weight(t(rng.standard_normal((d, d)) * d ** -0.5) * ao.reshape(-1, 1))
    return (x, g, b, qwqkv, sqkv, t(rng.standard_normal(3 * d) * 0.1), qwo, so, t(rng.standard_normal(d) * 0.1), a1,
            ao, heads, (d // heads) ** -0.5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,s,d,heads", [(2, 33, 256, 4), (1, 5, 64, 4)])
def test_attention_block_int8_on_s8_products(emulated, n, s, d, heads, dtype):
    emulate, build_dir = emulated
    args = _attn_args(np.random.default_rng(n * s + d), n, s, d, heads, dtype)
    with emulate.kernels_on_cpu(build_dir, _STEMS):
        got = kernels.attention_block_int8(*args)
        # one wrapper launch, four kernels: LN rows to int8, the QKV product, the core, the output product
        assert kernels.attention_block_int8.launches == 1 and kernels.attention_block_int8.kernel_launches == 4
        again = kernels.attention_block_int8(*args)
    want = int8_transformer.attention_block_int8_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert float(((got.float() - want.float()).abs() / (1 + want.float().abs())).max()) <= 2e-2
    assert torch.equal(got, again)


@pytest.mark.parametrize("quantised", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("m,k,n", [(17, 16, 7), (300, 96, 200), (130, 64, 256)])
def test_int8_matmul_requant_on_s8_product(emulated, m, k, n, relu, quantised):
    emulate, build_dir = emulated
    rng = np.random.default_rng(m + k + n)
    qx = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    out_scale = torch.tensor(0.02 * (k / 96) ** 0.5) if quantised else None
    with emulate.kernels_on_cpu(build_dir, _STEMS):
        got = kernels.int8_matmul_requant(qx, qw, scale, bias, out_scale, relu)
        assert kernels.int8_matmul_requant.launches == 1
    want = int8_matmul.int8_matmul_requant_plain(qx, qw, scale, bias, out_scale, relu)
    assert got.dtype == (torch.int8 if quantised else torch.float32) and torch.equal(got, want)
