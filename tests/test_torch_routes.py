"""The ``None`` routes of the port decide by shape whether a kernel takes its
input, and send what it does not take to the plain route; explicit routes keep
raising off their kernel's domain (on the card, ``tests/test_torch_cuda.py``).

The decisions read shapes and dtypes only, so they are the same on the CPU as
on the card: each case below would have sent the card a shape its kernel
refuses.
"""

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch import ops
from cpu_vision_tpu_torch.models import swin as tswin
from cpu_vision_tpu_torch.models import vision_transformer as tvit
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import nms as tnms
from cpu_vision_tpu_torch.ops.kernels import swin_attention, transformer_block


@pytest.mark.parametrize("d,heads,mlp_dim,dtype,expected", [
    (640, 10, 2560, torch.float32, ("block", "plain")),     # D outside MLP_DIMS
    (896, 14, 3584, torch.bfloat16, ("block", "plain")),
    (896, 14, 3584, torch.float32, ("flash", "plain")),     # the JAX rule picks flash, which takes head dim 64
    (384, 12, 1536, torch.bfloat16, ("plain", "block")),    # head dim 32: neither attention kernel takes it
    (768, 12, 3072, torch.bfloat16, ("block", "block")),    # ViT-B/16 keeps both kernels
    (1280, 16, 5120, torch.bfloat16, ("flash", "block")),   # ViT-H/14: head dim 80
])
def test_vit_none_routes_stay_in_the_kernels_domains(d, heads, mlp_dim, dtype, expected):
    block = tvit.EncoderBlock(heads, 8 * heads, 8, dtype)  # the rule reads the widths it is asked about
    block.mlp_dim = mlp_dim
    assert block.routes(d, 197) == expected
    attention, mlp = expected
    if attention == "block":
        assert transformer_block.attention_kernel_takes(d, heads)
    if mlp == "plain":
        assert not transformer_block.mlp_kernel_takes(d, mlp_dim)


def test_vit_explicit_routes_are_kept():
    block = tvit.EncoderBlock(12, 384, 1536, torch.bfloat16, attention="block", mlp="block")
    assert block.routes(384, 197) == ("block", "block")
    assert tvit.EncoderBlock(10, 640, 2560, attention="flash", mlp="block").routes(640, 197) == ("flash", "block")


@pytest.mark.parametrize("dim,heads,window,side,expected", [
    (80, 2, 7, 56, ("plain", "plain")),    # C 80: head dim 40, and C outside MLP_DIMS
    (96, 3, 9, 36, ("plain", "block")),    # windows of 81 tokens
    (96, 3, 7, 56, ("block", "block")),    # Swin-T's first stage keeps both kernels
])
def test_swin_none_routes_stay_in_the_kernels_domains(dim, heads, window, side, expected):
    block = tswin.SwinBlock(dim, heads, window, 0, dtype=torch.bfloat16)
    assert block.routes(2, side, side) == expected
    assert swin_attention.kernel_takes(dim, heads, window * window) == (expected[0] == "block")


def test_swin_explicit_routes_are_kept():
    block = tswin.SwinBlock(80, 2, 9, 0, attention="block", mlp="block")
    assert block.routes(2, 36, 36) == ("block", "block")


def test_nms_domain():
    assert tnms.kernel_takes(torch.zeros((1, tnms.MAX_BOXES, 4)))
    assert not tnms.kernel_takes(torch.zeros((1, tnms.MAX_BOXES + 1, 4)))
    assert not tnms.kernel_takes(torch.zeros((tnms.MAX_PROBLEMS + 1, 2, 4)))
    assert tnms.kernel_takes(torch.zeros((tnms.MAX_PROBLEMS, 2, 4)))


@pytest.mark.parametrize("fn", ["nms", "batched_nms", "nms_padded"])
def test_nms_none_route_takes_the_twin_past_the_kernels_problems(rng, fn):
    """65,536 problems of two boxes: past MAX_PROBLEMS, the None route runs the
    twin and counts it; the keep masks equal the plain route's."""
    p = tnms.MAX_PROBLEMS + 1
    xy = rng.random((p, 2, 2), dtype=np.float32) * 10
    boxes = torch.from_numpy(np.concatenate([xy, xy + 1 + rng.random((p, 2, 2), dtype=np.float32)], axis=-1))
    scores = torch.from_numpy(rng.random((p, 2), dtype=np.float32))
    call = {"nms": lambda b: ops.nms(boxes, scores, 0.3, backend=b),
            "batched_nms": lambda b: ops.batched_nms(boxes, scores, torch.zeros((p, 2), dtype=torch.int64), 0.3,
                                                     backend=b),
            "nms_padded": lambda b: ops.nms_padded(boxes, scores, 0.3, backend=b)[0]}[fn]
    kernels.reset_launch_counts()
    got = call(None)
    assert kernels.nms_sorted.plain_routes == 1 and kernels.nms_sorted.launches == 0
    assert torch.equal(got, call("plain"))
    with pytest.raises(ValueError, match=str(tnms.MAX_PROBLEMS)):
        call("kernel")
    kernels.reset_launch_counts()
    assert kernels.nms_sorted.plain_routes == 0


# Past the kernels' launch grids (65,535 row tiles, images or frames on a grid dimension): the launchers walk such
# inputs in pieces, so no rule holds a batch limit, and each None route at these batches is the JAX rule's.
SWIN_T_STAGE1_PAST_THE_GRID = 2675  # 2,675 x 3,136 tokens: past 65,535 x 128 rows of the products


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swin_none_routes_past_the_grid_follow_the_jax_rule(dtype):
    from cpu_vision_tpu.ops.pallas.swin_attention import pick_group

    n, dim, heads, ws, side = SWIN_T_STAGE1_PAST_THE_GRID, 96, 3, 7, 56
    assert n * side * side > 65535 * 128
    block = tswin.SwinBlock(dim, heads, ws, ws // 2, dtype=dtype)
    it = torch.empty((), dtype=dtype).element_size()
    nsq, nw_img = ws * ws, (side // ws) ** 2
    group = pick_group(n * nw_img, nw_img, heads, True)  # the JAX package's block, as written in its __call__
    jax_fused = dim % 8 == 0 and (4 * dim * dim * it + heads * nsq * nsq * 4 + 2 * group * nsq * dim * (4 + it)
                                  + nsq * 3 * dim * 4) <= 12_500_000
    assert block.routes(n, side, side) == ("block" if jax_fused else "plain", "block")


def test_int8_none_routes_past_the_grid_take_the_kernels():
    """The JAX engines send every 1x1 convolution (``_pallas_eligible``) and every ViT sub-block to their Pallas
    kernels at any batch; so do the port's None routes, at ResNet-50's first stage past 65,535 row tiles and at
    ViT-B/16's width."""
    import types

    from cpu_vision_tpu_torch.models.quantization_resnet import Int8ResNet
    from cpu_vision_tpu_torch.models.quantization_vit import Int8ViT

    q = torch.zeros((), dtype=torch.int8).expand(SWIN_T_STAGE1_PAST_THE_GRID, 56, 56, 64)  # no storage
    assert q.shape[0] * 56 * 56 > 65535 * 128
    engine = types.SimpleNamespace(conv1x1=None)
    assert Int8ResNet._takes_kernel(engine, types.SimpleNamespace(is_1x1=True), q)
    vit = types.SimpleNamespace(route=None, d=768, heads=12, mlp_dim=3072)
    assert Int8ViT.routes(vit) == ("kernel", "kernel")
    assert transformer_block.attention_kernel_takes(768, 12) and transformer_block.mlp_kernel_takes(768, 3072)


def test_the_wrappers_hold_no_grid_limit():
    """What the wrappers once refused past the grid (65,535 images, row tiles of 128 rows, 89 input channels) is
    no longer part of their modules: only NMS keeps a limit, and its None route decides by it."""
    from cpu_vision_tpu_torch.ops.kernels import conv_block, int8_matmul, int8_transformer

    assert not hasattr(int8_matmul, "MAX_ROWS") and not hasattr(int8_transformer, "MAX_TOKENS")
    assert not hasattr(conv_block, "MAX_CIN")
    assert tnms.MAX_PROBLEMS == 65535
