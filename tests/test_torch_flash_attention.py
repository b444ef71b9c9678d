"""The port's ``flash_mha`` (``cpu_vision_tpu_torch.ops.kernels.flash_attention``)
against the JAX package's Pallas kernel run in interpret mode, on the same
numpy inputs.

On CPU tensors the wrapper runs its plain twin.  Tolerances: float32
``1e-5·(1 + |ref|)`` (order of the sums); bfloat16 ``2e-2·(1 + |ref|)``.  The
CUDA kernel is held against the twin on the card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops.pallas import flash_attention as jfa
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import flash_attention as tfa


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s", [17, 50, 197])
@pytest.mark.parametrize("hd", [16, 64, 80])  # 80: ViT-H/14's
def test_twin_matches_pallas_interpret(rng, s, hd):
    n, h = 2, 3
    qkv = _qkv(rng, (n, s, h, hd))
    scale = hd ** -0.5
    ref = np.asarray(jfa.flash_mha(*map(jnp.asarray, qkv), scale, True))
    out = kernels.flash_mha(*map(torch.from_numpy, qkv), scale)
    assert out.shape == (n, h, s, hd) and out.dtype == torch.float32  # (N, H, S, hd), as the JAX function
    assert np.all(np.abs(out.numpy() - ref) <= 1e-5 + 1e-5 * np.abs(ref))
    assert torch.equal(out, tfa.flash_mha_plain(*map(torch.from_numpy, qkv), scale))
    assert kernels.launch_counts()["flash_mha"] == 0  # CPU tensors launch nothing


# (197, 64): ViT-B/16's; (257, 80): ViT-H/14's
@pytest.mark.parametrize("s,hd", [(17, 16), (50, 64), (197, 64), (17, 80), (257, 80)])
def test_twin_matches_pallas_interpret_bfloat16(rng, s, hd):
    qkv = _qkv(rng, (1, s, 2, hd))
    ref = jfa.flash_mha(*(jnp.asarray(a).astype(jnp.bfloat16) for a in qkv), 0.3, True)
    out = kernels.flash_mha(*(torch.from_numpy(a).bfloat16() for a in qkv), 0.3)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.all(np.abs(out.float().numpy() - ref) <= 2e-2 + 2e-2 * np.abs(ref))


def test_twin_matches_stock_attention(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, (2, 23, 4, 32)))
    ref = torch.nn.functional.scaled_dot_product_attention(*(a.permute(0, 2, 1, 3) for a in (q, k, v)), scale=0.2)
    np.testing.assert_allclose(tfa.flash_mha_plain(q, k, v, 0.2).numpy(), ref.numpy(), atol=1e-5)


def test_bad_arguments_raise(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 5, 2, 16)))
    with pytest.raises(ValueError):  # not 4-D
        kernels.flash_mha(q[0], k[0], v[0], 0.25)
    with pytest.raises(ValueError):  # shapes differ
        kernels.flash_mha(q, k[:, :4], v, 0.25)
    with pytest.raises(ValueError):  # dtypes differ
        kernels.flash_mha(q, k.bfloat16(), v, 0.25)
    with pytest.raises(TypeError):
        kernels.flash_mha(q.double(), k.double(), v.double(), 0.25)
    with pytest.raises(ValueError):
        kernels.flash_mha(q.to("meta"), k.to("meta"), v.to("meta"), 0.25)


@pytest.mark.parametrize("dtype,s,hd,takes", [
    (torch.bfloat16, 577, 64, True), (torch.bfloat16, 257, 64, True), (torch.bfloat16, 197, 64, True),
    (torch.bfloat16, 1, 64, True), (torch.float32, 577, 64, False), (torch.float32, 197, 64, False),
    (torch.bfloat16, 197, 80, False), (torch.bfloat16, 577, 16, False)])
def test_core_backward_takes_any_sequence_length(dtype, s, hd, takes):
    """Kernel B streams its tiles, so it takes every S (384² inputs: 577 tokens); bfloat16 at head dim 64 only."""
    assert tfa.core_backward_takes(dtype, s, hd) is takes


@pytest.mark.parametrize("s,d,heads,dtype,takes", [(577, 768, 12, torch.bfloat16, True),
                                                   (577, 1024, 16, torch.bfloat16, True),
                                                   (257, 1280, 16, torch.bfloat16, False),
                                                   (577, 768, 12, torch.float32, False)])
def test_attention_block_backward_route_follows(s, d, heads, dtype, takes):
    """attention_block takes the card's backward wherever its core does: ViT-B/16 and ViT-L/16 at 384² (S 577, head
    dim 64) now, ViT-H/14 (head dim 80) and float32 still the recomputed twin."""
    from cpu_vision_tpu_torch.ops.kernels import transformer_block

    x, w_qkv = torch.empty((1, s, d), dtype=dtype), torch.empty((d, 3 * d), dtype=dtype)
    assert transformer_block.attention_backward_takes(x, w_qkv, heads) is takes
