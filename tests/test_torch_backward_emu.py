"""The bfloat16 blocks' backward kernels' CUDA sources run on the CPU through
``tools/cuda_emu``, against their plain versions: the attention core's
backward (Kernel B, ``csrc/tc_attention_bwd.cuh``, wgmma with A from
registers and MN-major B tiles), the gelu's elementwise backward (Kernel A,
``csrc/transformer_block.cu:gelu_backward_kernel``) and the LayerNorm
backward rows (``csrc/ln_gemm.cuh``: ``ln_backward_vec_kernel``, rows held
in registers on a persistent grid, and the scalar ``ln_backward_kernel`` for
other widths and misaligned rows, each with the pass that adds the blocks'
sums), each alone and in the whole backward of ``mlp_block``,
``cn_mlp_block`` and ``attention_block``.

The emulator compiles the sources with ``g++`` against stand-in headers and
runs one thread per CUDA thread (see ``tests/test_torch_attention_cores_emu.py``).
The shapes are small and ragged: S 7 (one tile, 57 padded keys), 70 (a full
key tile and one of 6), 130 (three tiles) and, past the first design's cap of
256, 257 (a last tile of one row) and 300 (five tiles: the three-stage rings
wrap);
rows that fill no whole block of the row passes.  Tolerances: Kernel B and the
blocks' gradients ``2e-2·(1 + |plain|)``, the bf16 kernels' rule on the card
(the kernel multiplies ds rounded to TF32 where the plain version's products
on the CPU keep it float32); Kernel A's activations are the plain version's
bits and its ``du`` within one TF32 step (the emulated ``expf`` is the host
library's, not the card's and torch's), or 2^-12 of the largest where gelu'
is a difference of nearly equal terms; the LayerNorm rows ``1e-5·(1 + |plain|)``
in float32 (sums in other orders), their bfloat16 ``dx`` within one bfloat16
step.  Without ``g++`` the tests skip.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import flash_attention, transformer_block

TOL = 2e-2
_EMULATE = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"


@pytest.fixture(autouse=True)
def _launch_counts_at_zero_after():
    """The emulated kernels count their launches; later tests in this process expect CPU tensors to have launched
    nothing."""
    yield
    kernels.reset_launch_counts()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulator module with its libraries built into a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the CUDA emulation needs a C++20 compiler")
    spec = importlib.util.spec_from_file_location("cuda_emulate", _EMULATE)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    build_dir = tmp_path_factory.mktemp("cuda_emu")
    emulate.build(build_dir)
    return emulate, build_dir


def _normal(rng, shape, dtype=torch.float32, std=1.0, mean=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32)).to(dtype)


def _assert_close(out, ref, tol=TOL):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.float() - ref.float()).abs()
    assert bool((err <= tol + tol * ref.float().abs()).all()), f"max |err| {float(err.max())}"


@pytest.mark.parametrize("n,s,heads", [(2, 7, 2), (1, 70, 2), (1, 130, 1), (1, 257, 2), (1, 300, 2)])
def test_attention_core_backward(emulated, n, s, heads):
    emulate, build_dir = emulated
    rng = np.random.default_rng(s)
    q, k, v = (_normal(rng, (n, s, heads, 64), torch.bfloat16) for _ in range(3))
    do = _normal(rng, (n, heads, s, 64), torch.bfloat16)
    o = torch.full((n, s, heads, 64), float("nan"), dtype=torch.bfloat16)
    with emulate.kernels_on_cpu(build_dir):
        before = kernels.attention_core_backward.launches
        got = kernels.attention_core_backward(q, k, v, do, 0.125, o=o)
        assert kernels.attention_core_backward.launches == before + 1  # the emulated kernel ran, not the plain version
        again = kernels.attention_core_backward(q, k, v, do, 0.125)
    for a, b in zip(got, kernels.attention_core_backward_plain(q, k, v, do, 0.125)):
        _assert_close(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # the same bits without o, and twice
    joined = flash_attention.flash_mha_plain(q, k, v, 0.125).transpose(1, 2)
    if s <= 130:  # the twin's joined heads bit for bit; past two key tiles its CPU product sums in another order
        assert torch.equal(o, joined)
    _assert_close(o, joined)


@pytest.mark.parametrize("m,dh", [(37, 96), (130, 448)])
def test_mlp_gelu_backward(emulated, m, dh):
    emulate, build_dir = emulated
    rng = np.random.default_rng(m)
    da32, hw, b1 = _normal(rng, (m, dh)), _normal(rng, (m, dh), std=2.0), _normal(rng, (dh,), std=0.3)
    with emulate.kernels_on_cpu(build_dir):
        du2, a, db1 = kernels.mlp_gelu_backward(da32, hw, b1)
        assert kernels.mlp_gelu_backward.launches >= 1
    ref_du2, ref_a, ref_db1 = kernels.mlp_gelu_backward_plain(da32, hw, b1)
    assert torch.equal(a, ref_a)  # the twin's activations, bit for bit
    t, ref_t = (x[:, :dh].float() + x[:, dh:].float() for x in (du2, ref_du2))
    assert bool(((t - ref_t).abs() <= 2 ** -10 * (ref_t.abs() + 2 ** -12 * ref_t.abs().max())).all())
    assert torch.equal(du2[:, :dh], t.to(torch.bfloat16))  # hi = bf16(du), lo = du - hi exactly
    assert bool(((db1 - ref_db1).abs() <= 1e-5 * (1 + ref_db1.abs())).all())


@pytest.mark.parametrize("m,d,resid", [(37, 96, True), (9, 2048, False), (42, 128, True), (11, 768, True),
                                       (7, 300, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_backward_rows(emulated, m, d, resid, dtype):
    emulate, build_dir = emulated
    rng = np.random.default_rng(d)
    x, ln_g, dh, r = (_normal(rng, (m, d), dtype), _normal(rng, (d,), std=0.2, mean=1.0), _normal(rng, (m, d), dtype),
                      _normal(rng, (m, d), dtype))
    with emulate.kernels_on_cpu(build_dir):
        got = kernels.ln_backward_rows(x, ln_g, dh, r if resid else None)
        again = kernels.ln_backward_rows(x, ln_g, dh, r if resid else None)
    ref = kernels.ln_backward_plain(x, ln_g, dh, r if resid else None)
    _assert_close(got[0], ref[0], 1e-5 if dtype == torch.float32 else 2 ** -8)
    for a, b in zip(got[1:], ref[1:]):
        _assert_close(a, b, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # block partials added in a fixed order


# the vector kernel with several rows a warp (a persistent grid of one or two blocks on one or two emulated SMs,
# eight warps each), ragged against the warps; a misaligned view of a vector width, which takes the scalar kernel
@pytest.mark.parametrize("m,d,dtype,sms,offset,chunks", [(75, 768, torch.bfloat16, 1, 0, 3),
                                                        (41, 96, torch.float32, 2, 0, 1),
                                                        (23, 256, torch.bfloat16, 1, 1, 0)])
def test_ln_backward_rows_paths(emulated, monkeypatch, m, d, dtype, sms, offset, chunks):
    emulate, build_dir = emulated
    rng = np.random.default_rng(m)

    def rows():  # (m, d) of dtype, its storage shifted by `offset` values (2 bytes in bf16: off 16-byte alignment)
        return _normal(rng, (m * d + offset,), dtype)[offset:].view(m, d)

    x, dh, r = rows(), rows(), rows()
    ln_g = _normal(rng, (d,), std=0.2, mean=1.0)
    monkeypatch.setattr(transformer_block._build, "sm_count", lambda t: sms)
    with emulate.kernels_on_cpu(build_dir):
        info = transformer_block.ln_backward_info(x, ln_g, dh, r)
        got = kernels.ln_backward_rows(x, ln_g, dh, r)
        again = kernels.ln_backward_rows(x, ln_g, dh, r)
    assert info["chunks_a_lane"] == chunks  # 0: the scalar kernel
    assert info["grid"] == sms and m > info["grid"] * info["threads"] // 32  # some warp takes several rows
    ref = kernels.ln_backward_plain(x, ln_g, dh, r)
    _assert_close(got[0], ref[0], 1e-5 if dtype == torch.float32 else 2 ** -8)
    for a, b in zip(got[1:], ref[1:]):
        _assert_close(a, b, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _mlp_args(rng, m, d, dh):
    return [_normal(rng, (m, d), torch.bfloat16), _normal(rng, (d,), std=0.2, mean=1.0), _normal(rng, (d,), std=0.1),
            _normal(rng, (d, dh), torch.bfloat16, d ** -0.5), _normal(rng, (dh,), std=0.1),
            _normal(rng, (dh, d), torch.bfloat16, dh ** -0.5), _normal(rng, (d,), std=0.1)]


def _grads(fn, args, g):
    args = [a.detach().requires_grad_() for a in args]
    fn(*args).backward(g)
    return [a.grad for a in args]


def test_mlp_block_backward(emulated):
    """The whole bf16 backward of mlp_block and cn_mlp_block on the emulated kernels (Kernel A, bf16_product,
    wgrad_matmul, ln_backward_rows), against the plain backward."""
    emulate, build_dir = emulated
    rng = np.random.default_rng(5)
    args = _mlp_args(rng, 37, 128, 256)
    g = _normal(rng, (37, 128), torch.bfloat16)
    res, ls = _normal(rng, (37, 128), torch.bfloat16), _normal(rng, (128,), std=0.5)
    with emulate.kernels_on_cpu(build_dir):
        kernels.reset_launch_counts()
        got = _grads(kernels.mlp_block, args, g)
        got_cn = _grads(kernels.cn_mlp_block, [args[0], res, *args[1:], ls], g)
        counts = kernels.launch_counts()
    assert counts["mlp_gelu_backward"] == 2 and counts["ln_backward_rows"] == 2 and counts["wgrad_matmul"] == 4
    for a, b in zip(got, kernels.mlp_block_backward_plain(*args, g)):
        _assert_close(a, b)
    ref_cn = kernels.mlp_block_backward_plain(*args, g, layer_scale=ls)
    assert torch.equal(got_cn[1], g)
    for a, b in zip([got_cn[0], *got_cn[2:]], ref_cn):
        _assert_close(a, b)


def test_attention_block_backward(emulated):
    """The whole bf16 backward of attention_block on the emulated kernels (Kernel B with the joined heads,
    bf16_product, wgrad_matmul, ln_backward_rows), against the plain backward."""
    emulate, build_dir = emulated
    rng = np.random.default_rng(6)
    n, s, d, heads = 1, 70, 128, 2
    args = [_normal(rng, (n, s, d), torch.bfloat16), _normal(rng, (d,), std=0.2, mean=1.0), _normal(rng, (d,), std=0.1),
            _normal(rng, (d, 3 * d), torch.bfloat16, d ** -0.5), _normal(rng, (3 * d,), std=0.1),
            _normal(rng, (d, d), torch.bfloat16, d ** -0.5), _normal(rng, (d,), std=0.1)]
    g = _normal(rng, (n, s, d), torch.bfloat16)
    with emulate.kernels_on_cpu(build_dir):
        kernels.reset_launch_counts()
        got = _grads(lambda *a: kernels.attention_block(*a, heads, 0.125), args, g)
        counts = kernels.launch_counts()
    assert counts["attention_core_backward"] == 1 and counts["ln_backward_rows"] == 1 and counts["bf16_product"] == 2
    for a, b in zip(got, transformer_block.attention_block_backward_plain(*args, g, heads, 0.125)):
        _assert_close(a, b)
