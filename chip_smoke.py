#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cpu_vision_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``cpu_vision_tpu_torch/csrc/`` (printing
each kernel's registers and spills, and the ``HGMMA`` instructions that the
SASS of the bf16 tensor-core product and of the bf16 attention cores holds,
from ``cuobjdump``; it fails if a product or a core has none or a bf16
instantiation of the scalar kernels they replaced is left: a bf16
``attention_core_kernel`` at head dim 64, a bf16 ``window_core_kernel``; and
if a split-TF32 product (``csrc/tf32x3.cuh:x3_gemm_kernel``,
behind the float32 ``mlp_block`` / ``cn_mlp_block``, ``attention_block``,
``window_attention_block`` and ``wgrad_matmul``) lacks ``HGMMA ... .TF32``, a
bf16 ``wgrad_bf16_kernel`` lacks ``HGMMA ... .BF16``, either or the depthwise
kernel spills, or the scalar ``mlp_block_kernel``, ``wgrad_partial_kernel`` or
``ln_gemm_kernel`` is left in any library; and if an instantiation of the
int8 product, ``csrc/int8_gemm.cuh:i8_tc_gemm_kernel``, in
``libint8_transformer`` or ``libint8_matmul`` lacks ``IGMMA`` (``wgmma`` s8)
or holds ``IDP4A``, spills or is serialised, or a dp4a kernel it replaced
(``mlp_int8_kernel``, ``i8_gemm_kernel``) is left, or the LayerNorm
backward's ``ln_backward_vec_kernel`` spills; and if the fused conv stage,
``csrc/conv_block.cu:conv3x3_x3_kernel`` (an implicit GEMM by split TF32),
lacks ``HGMMA ... .TF32`` in either instantiation or holds as many ``FFMA`` as
``HGMMA`` (a scalar main loop), its scalar predecessor
``conv3x3_relu_pool_kernel`` is left; its spills and the Harris kernels' are
printed; and if the float32 window core, ``csrc/swin_attention.cu:window_x3_kernel``
(split TF32), lacks ``HGMMA ... .TF32`` or spills, or the scalar
``window_core_kernel`` it replaced is left in ``libswin_attention``; the
window cores' registers, shared memory and blocks an SM are printed), then:

1. drives the main paths through the public entry points, each with the
   kernels' launch counts set to 0 just before it and read just after:
   ``ops.canny`` on the synthetic 1080p scene at batch 8 (the headline
   benchmark's workload; the hysteresis passes it launched and the host's
   reads of their device flags are printed beside the call's time), and the
   same with ``canny_stage1``'s in-tile hysteresis; ``ops.kernels.fused_blur_sobel`` on one 512x512 image
   (held bit for bit against its twin there, at 1080p b8 and at K 3, 7 and 9, beside the composite
   ``ops.sobel(ops.gaussian_blur(...))``);
   ``ops.kernels.harris_response_fused`` on 2 MP images at batch 32;
   ``ops.cnn_forward`` at batch 256 on 28x28x1 and 224x224x3 images with
   channels (32, 64) and 128 hidden units; and the 4-level Laplacian
   pyramid, antialiased bilinear resize, rotation and fused Gaussian blur
   of 64 RGB 640x480 images; ``models.get_model("vit_b_16")`` at full depth
   and width on 224x224x3 images, in bfloat16 at batch 256 (``attention_block``
   and ``mlp_block`` in each of the 12 layers) and in float32 at batch 64
   (``flash_mha`` and ``mlp_block``); ``models.get_model("vit_h_14")`` at full depth and
   width (32 layers, D 1280, 16 heads of 80, S 257) in bfloat16 at batch 64 and in
   float32 at batch 16 (``flash_mha``, on the tensor-core cores at head dim 80, and
   ``mlp_block`` in each layer), against the plain routes on the same weights, the
   core's own time beside its bound and SDPA; and ResNet-50 in float32 through
   ``graft_entry.entry()`` (batch 4) and at batch 256, which runs stock
   operators only; ``models.get_model`` of ``swin_t`` (bfloat16 batch 256 and
   float32 batch 32 at 224x224), ``swin_v2_t`` (bfloat16 batch 64 at 256x256),
   ``swin_t_padded`` (bfloat16 batch 64, its weights ``swin_t``'s through
   ``pad_swin_state_dict``) and ``convnext_tiny`` (bfloat16 batch 256, with the
   depthwise kernel and with the stock depthwise convolution), all at full
   depth and width (``window_attention_block`` + ``mlp_block`` in each Swin
   block, ``depthwise_conv2d`` + ``cn_mlp_block`` in each ConvNeXt block); and
   ``models.detection.detect`` with ``fasterrcnn_resnet50_fpn`` (bfloat16 and
   float32) and ``fasterrcnn_resnet50_fpn_v2`` (float32) at full depth and
   width on 8 images of unequal sizes on a 640x640 canvas (``nms_sorted`` in
   the RPN's two NMS calls and the postprocess's one); and the int8 engines
   ``models.Int8ViT`` over ``vit_b_16`` (bfloat16, ``attention_block_int8`` and
   ``mlp_block_int8`` in each of the 12 layers, four and three kernel launches) and ``models.Int8ResNet`` over
   ``resnet50`` (``int8_matmul_requant`` in its 36 1x1 convolutions), both at
   batch 256 on 224x224 images; and training: ``vit_b_16`` bfloat16 at batch
   128 through ``parallel.make_train_step`` (3 SGD steps on the kernel routes,
   ``attention_block`` + ``mlp_block`` forward and their backward on the
   card's kernels: ``attention_core_backward``, ``mlp_gelu_backward``,
   ``ln_backward_rows``, ``bf16_product`` and ``wgrad_matmul``, counted, with
   no twin called; then one more step split into forward, backward and
   optimizer on the card's clock and profiled: busy share and kernels by
   name; and 3 on the plain routes, from the same weights), ``swin_t``
   (stochastic depth 0.2, and 0: every block on the kernels) and
   ``convnext_tiny`` (0.1, the depthwise kernel) bfloat16 at batch 128 (3 SGD
   steps with momentum on the kernel routes and 3 on the plain routes, from one
   seed: step times, one more step split and profiled, the recomputed
   backward's time, peak memory, the losses and first gradients held to the
   plain routes'; the backward kernels at every shape these paths gave them,
   held on drawn inputs), ``resnet50`` bfloat16 at
   batch 128 with batch statistics (3 steps, and a float32 run of the same
   weights), ``cnn_forward`` at 28x28x1 batch 256 (3 steps on the conv kernel
   and 3 on the plain route) and ``ops.PointwiseConv`` at the twelve 1x1
   shapes of ResNet-50 at batch 128 with at least 16,384 rows, float32 and
   bfloat16 (``wgrad_matmul`` in each backward); and checks their outputs
   against the op-by-op paths, stock PyTorch operators, the engines on their
   twins, the plain routes' gradients, a float32 run, flax's running
   statistics and ``F.conv2d`` autograd;
2. holds every kernel against its plain PyTorch twin on the card at every
   shape and dtype those paths handed it (the wrappers count their launches
   by input shape, and the script fails if a Swin, ConvNeXt or ViT-H/14 path
   ran a shape that was not held) and times both with CUDA events at the heaviest
   (``canny_stage1`` and ``hysteresis_sweeps`` also on the class map of
   uniform noise, with the sweeps' two device flags against the twin's);
3. prints one JSON line of per-kernel results (``launches`` of an entry and
   of each of its ``other_shapes`` are counts read after a main path, named
   in ``launches_on`` or listed by path in ``launches_by_path`` (an entry's
   own shape under ``launches_at_shape``); ``bound_ms``
   counts the function's own inputs and output, and ``split_bytes_ms`` is the
   time at the memory rate of the intermediates that a kernel split into
   several launches passes through device memory; ``kernel_launches`` counts
   those launches and ``launch_ms`` times each of them apart on the bf16 rows
   of the transformer blocks, on every window attention row and on the blur's
   and the NMS's rows (the NMS's mask pass and scan), from
   ``torch.profiler``'s kernel intervals (null where five profiler windows saw
   no kernel); the rows of ``attention_block``, ``attention_block_int8`` and
   ``window_attention_block`` carry their attention core's own launch apart:
   ``core_ms`` from those intervals, ``core_bound_ms`` over the core's own
   inputs and output (the float32 window core's operations at split TF32's
   rate, on every float32 window case), and ``core_library_ms``, one call of
   ``F.scaled_dot_product_attention`` on q, k and v of the same shapes (the
   window rows' bias and mask as its additive mask); ``flash_mha`` is also
   held and timed in bfloat16 at ViT-B/16 b256's (256, 197, 12, 64), beside
   SDPA; its float32 row (the split-TF32 core, ``csrc/tf32x3_attention.cuh``)
   carries its float64 error beside the scalar float32 core's that it
   replaced (``f64_err``, ``scalar_f64_err``, held to twice it;
   ``scalar_core_ms``), its ``HGMMA ... .TF32`` count and its occupancy
   (registers, shared memory, blocks an SM); the float32 MLP blocks are three launches too (LN, two
   split-TF32 products), timed apart and bounded at three tf32 products a
   product (``TF32X3_OPS_PER_S``), with ``split_bytes_ms`` for their f32
   hidden, their float64 error at ViT-B/16 b64 beside the twin's
   (``f64_err``, ``twin_f64_err``: ``max|out - f64| / max|f64|``, held to twice
   the twin's), and the same bits twice; every ``wgrad_matmul`` row carries its
   float64 error beside ``torch.mm``'s (``library_f64_err``, held to twice it);
   ``attention_block`` is also held and timed in float32 at (64, 197, 768),
   on no main path, beside its composite; the float32 ``attention_block`` and
   every float32 ``window_attention_block`` case are four launches (LN rows, two
   split-TF32 products, the core; v2: no LN rows, LN + residual last), each
   timed apart and none of them ``ln_gemm_kernel``, held to float64 as the MLP
   (``f64_err`` no more than twice ``twin_f64_err``), the same bits twice; every
   ``depthwise_conv2d`` case twice, the same bits, with its tile, registers,
   shared memory and blocks an SM (``kernel_info``), its bound at the rate of
   its dtype and, apart, the f32 FMA pipe's floor (``fma_floor_ms``) of the
   kernel, which sums in f32 on the CUDA cores; ``mlp_block_int8`` twice, the
   same bits, its three launches (LN rows to int8, two s8 products) timed apart
   on the device clock, with ``split_bytes_ms`` for its int8 LN rows and
   hidden and its ``IGMMA`` count; ``attention_block_int8`` the same way, its
   four launches (LN rows to int8, the QKV product, the core, the output
   product) apart, ``split_bytes_ms`` for its int8 LN rows, QKV buffer and
   joined heads, and the joined heads themselves (the core's int8 output)
   within one int8 step of the twin's, at most ``JOINED_FLIPS`` of them apart
   (``joined_steps``, ``joined_share``), as in every int8-out core case;
   ``mlp_block`` at ViT-H/14's two shapes is held as at ViT-B/16's (float64,
   the same bits twice); ``int8_matmul_requant`` at every one of the 15 distinct shapes
   of the int8 ResNet-50 path, on its own inputs, with the sum over the 36
   launches of a forward (``forward_ms``) beside the composite's and the
   bound's; the bf16 blocks' backward kernels
   and ``bf16_product`` and ``wgrad_matmul`` at the ViT training path's
   shapes, each beside its bound and one PyTorch call (``ln_backward_rows``
   with its kernel's path, grid and occupancy, ``kernel_info``, and its two
   launches apart; SDPA's backward, its
   graph kept between calls,
   ``aten.gelu_backward``, ``aten.native_layer_norm_backward``, ``torch.mm``;
   Kernel B also at S 257 and 577, its launches counted and timed apart on
   the device clock, SDPA's backward beside it on the same clock with the
   range of each over fifteen calls, and each kernel's occupancy);  ``depthwise_conv2d``'s backward dx at ConvNeXt-T's
   four stage shapes beside ``aten.convolution_backward`` (``backward_dx``);
   and the gradients of ``cn_mlp_block``, ``window_attention_block`` and
   ``depthwise_conv2d`` (rows 12-14) against their twins' on the card;
   ``held_untimed`` lists the checks that were not timed); the bf16 v2 window
   block on the 24 draws of fault 1 (fixed) and the float32 block on the draw of
   fault 2 (fixed, held to its float64 rule); the attention cores at head dims 16,
   64 and 80 in bfloat16, float32 and into int8 (ViT-H/14's shapes as rows, S 257 and
   every key-tile tail held to the twins, the same bits twice, the float32 cores to
   float64 within twice the scalar yardstick); then, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
Without a CUDA card it exits 1 at once.
"""

import contextlib
import copy
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the
# tensor cores, dense bf16 in them (the card's bf16 rate, whatever a kernel
# uses).  A card below its 700 W limit runs slower than this bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12  # dense int8 in the tensor cores
# float32 products by split TF32 (csrc/tf32x3.cuh): three tf32 products each at 495 TFLOP/s dense, so the bound of
# such a kernel is max(bytes / 3.35 TB/s, 3 ops / 495 TFLOP/s); on F32_OPS_PER_S a fast one would beat its bound
TF32X3_OPS_PER_S = 495e12 / 3

# Kernel vs twin: class maps must be equal; f32 stencil maps must agree
# within F32_ATOL + F32_RTOL * |twin| (both run the same f32 operations in
# the same order without FMA, so the expected difference is 0).  The fused
# convolution sums over input channels in another order than its twin's
# matrix products, with FMAs: CONV_ATOL + CONV_RTOL * |twin|.  Logits of the
# CNN's three conv routes: LOGIT_TOL + LOGIT_TOL * |reference|.  The
# transformer kernels sum products of up to 3072 terms in other orders than
# their twins' matrix products, with FMAs: TOL * (1 + |twin|) with TOL[dtype],
# bf16 compared in bf16 (one step is 2^-8 of the value).  ViT logits against
# the stock-operator route: VIT_TOL[dtype] * (1 + |reference|).  In bf16 that
# route rounds at other places in each of 24 sub-blocks, so two right answers
# differ by several bf16 steps: on an H100 the least t with |a - b| <=
# t * (1 + |b|) reads 4.25e-2 between the two routes, and 3.31e-2 (kernels)
# and 3.48e-2 (stock) against the float32 logits of the same weights, so no
# bf16 route meets the kernels' own 2e-2 over 12 layers; four times that is
# allowed.  The tighter check is against those float32 logits: the kernel
# route may stand no further from them than BF16_SLACK times the stock bf16
# route does (it reads 0.92 times as far).  ResNet-50 logits against the same model run layer
# by layer: LOGIT_TOL * (1 + |reference|).  Swin and ConvNeXt logits are held as
# the ViT's: float32 within VIT_TOL of the plain routes, bfloat16 no further
# from the float32 logits than BF16_SLACK times the plain bfloat16 route and
# within VIT_TOL[bfloat16] of it.  The depthwise convolution sums its taps in
# its twin's order with FMAs: CONV_ATOL + CONV_RTOL * |twin| in float32,
# TOL[bfloat16] * (1 + |twin|) in bfloat16.  NMS keep masks equal the twin's bit for bit, and so do the
# float32 and bfloat16 detections on the kernel route and on the plain one (cuDNN deterministic): the logits'
# rule below with no difference at all.  The bfloat16 detector is held to the float32 one by the logits' rule
# restated for what its heads emit on the float32 run's proposals (class logits and box deltas of every class of
# every proposal, before any threshold, top-k or NMS decision): within VIT_TOL[bfloat16] * (1 + |float32|); the
# softmax scores (a function of those logits) and the decoded boxes' differences are printed.  The int8 product
# (int8_matmul_requant) must equal its twin bit for bit at every launch of the int8 ResNet-50 path (exact int32
# sums, the same float32 epilogue without FMA); the ResNet's logits on its two 1x1 routes are compared and their
# difference printed (expected 0).  The int8 sub-blocks take their LayerNorm statistics and exponentials in other
# orders than their twins, so a quantised activation near a rounding half may land one step apart: TOL[dtype] *
# (1 + |twin|) as the bf16 transformer kernels, and the int8 ViT's logits within VIT_TOL[bfloat16] * (1 + |ref|) of
# the same engine on its twins.  The int8 engines' distance to their float models is printed only: the weights are
# random, so it is no accuracy figure.  Training: the weight gradient wgrad_matmul sums float32 products (exact for
# bfloat16 inputs) in another order than its twin's product: WGRAD_TOL * max|twin|, and two calls equal bit for bit.
# conv1x1's output, dx and dW against F.conv2d autograd in float32 (TF32 off) on the same values: WGRAD_TOL *
# max|ref| in float32, C1_BF16_TOL * max|ref| in bfloat16 (its output, dx and dW are rounded to bfloat16, 2^-9 of
# the value).  The ViT's first-step gradients on the kernel routes against the plain routes', a parameter at a time:
# max|a - b| <= GRAD_TOL * max|b| (2.5 bfloat16 steps of its largest entry; the two routes round at other places),
# and no further from the float32 route's than BF16_SLACK times the plain bfloat16 route.  The ResNet's bfloat16
# gradients against its float32 run's: ||a - b|| < R50_GRAD_L2 * ||b|| over all parameters together, nearer than a
# zero gradient would be, and ||a|| within R50_GRAD_NORM of ||b|| (a gradient of half or twice its size reads 0.5 or
# 1).  The distance is not held tighter: at random weights the batch norms' backward cancels most of each gradient,
# so bfloat16 gradients stand far from float32 ones in either package (tests/test_torch_train.py holds the port's
# distance to at most 1.25 times the JAX package's on a small ResNet on the CPU); their norm does not move.
# Each batch norm's running statistics after the first step against flax's rule computed in float64 from the input
# and the running statistics that ResNet.recording() shows (biased variance, 0.9 / 0.1): the mean within STAT_TOL *
# (1 + |ref|), the variance within STAT_TOL * |ref|.  The unbiased variance's rule stands (n - 1)^-1 of the batch
# term off, 1.6e-5 of 1 at layer 4 (n = 6,272); the phase fails unless it would stand further than STAT_TOL.  The CNN's first-step gradients on
# the kernel route against the plain route's: CONV_ATOL + CONV_RTOL * |plain|, the conv stage's own rule.
# Swin-T and ConvNeXt-T training on the kernel routes against the plain routes, the same weights, images and
# stochastic-depth draws: the first loss within VIT_TOL[bfloat16] * (1 + |plain|), the losses after one and two
# updates within SC_LOSS_TOL * (1 + |plain|), and the first gradients within SC_GRAD_L2 * ||plain|| over all
# parameters together and over those of the stem and of the blocks on the kernels together.  The two routes round at
# other places (the recomputed twin's probabilities' gradient stays float32 where the plain attention's is bf16), so
# single entries stray (Swin-T's last position-bias tables 0.11 of their largest entry); the sums do not.  On an H100
# (tools/torch_train_grad_control.py) sound runs read 3.1-4.5e-3 and the losses 1.4e-4 at most; one fault at a time in
# the kernel routes' backward (dx halved, the weight gradients over half the rows, the first bias's gradient zeroed,
# LN's residual gradient dropped, the taps unflipped in the depthwise dx, stochastic depth one draw ahead) read
# 1.6e-2 to 1.09 over the stem's and the kernel blocks' parameters.
F32_ATOL, F32_RTOL = 1e-5, 1e-6
CONV_ATOL, CONV_RTOL = 1e-5, 1e-5
LOGIT_TOL = 1e-4
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
VIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 8e-2}
# attention_block_int8's joined heads (its core's int8 output) against the twin's quantize_i8(o): every value within
# one int8 step, and at most this share of them, and one more, a step apart (bf16's core rounds the probabilities
# before the division by their sum, the twin after it: 0.9-5.9% on an H100, the most at S 5; float32's split-TF32
# sums differ from the twin's in order only: at most 1.9e-4)
JOINED_FLIPS = {torch.bfloat16: 0.125, torch.float32: 1e-3}
BF16_SLACK = 1.5
WGRAD_TOL = 1e-5
C1_BF16_TOL = 1e-2
GRAD_TOL = 5e-2
R50_GRAD_L2 = 1.0
R50_GRAD_NORM = 0.2
SC_GRAD_L2 = 1e-2
SC_LOSS_TOL = 5e-4
STAT_TOL = 1e-6
STENCIL = "cpu_vision_tpu_torch/csrc/stencil.cu"
CONV_BLOCK = "cpu_vision_tpu_torch/csrc/conv_block.cu"
ATTENTION = "cpu_vision_tpu_torch/csrc/attention.cu"
TRANSFORMER = "cpu_vision_tpu_torch/csrc/transformer_block.cu"
SWIN_ATTENTION = "cpu_vision_tpu_torch/csrc/swin_attention.cu"
DEPTHWISE = "cpu_vision_tpu_torch/csrc/depthwise.cu"
NMS = "cpu_vision_tpu_torch/csrc/nms.cu"
INT8_MATMUL = "cpu_vision_tpu_torch/csrc/int8_matmul.cu"
INT8_TRANSFORMER = "cpu_vision_tpu_torch/csrc/int8_transformer.cu"
WGRAD = "cpu_vision_tpu_torch/csrc/wgrad_matmul.cu"
PALLAS = "cpu_vision_tpu/ops/pallas/stencil.py"
PALLAS_CONV = "cpu_vision_tpu/ops/pallas/conv_block.py"
PALLAS_FLASH = "cpu_vision_tpu/ops/pallas/flash_attention.py"
PALLAS_BLOCK = "cpu_vision_tpu/ops/pallas/transformer_block.py"
PALLAS_SWIN = "cpu_vision_tpu/ops/pallas/swin_attention.py"
PALLAS_DEPTHWISE = "cpu_vision_tpu/ops/pallas/depthwise.py"
PALLAS_NMS = "cpu_vision_tpu/ops/pallas/nms.py"
PALLAS_INT8_MM = "cpu_vision_tpu/ops/pallas/int8_matmul.py"
PALLAS_INT8_TB = "cpu_vision_tpu/ops/pallas/int8_transformer.py"
PALLAS_WGRAD = "cpu_vision_tpu/ops/pallas/wgrad_matmul.py"
# Faster R-CNN at the JAX package's benchmarked settings (bench_all.py:342-344).  At random weights the 91
# class scores of a proposal are all near 1/91, under the 0.05 score threshold; the class scores' weights are
# scaled up from their draw (seed 0) so that some, not all, of the 100 detection slots fill
DET_SETTINGS = dict(num_classes=91, rpn_pre_nms_top_n=1000, rpn_post_nms_top_n=300, max_detections=100)
DET_CLS_SCALE = {"fasterrcnn_resnet50_fpn": 2.0, "fasterrcnn_resnet50_fpn_v2": 4.0}
# float32 operations of the greedy NMS: a box's area (2 subtractions, 1 product) once; a pair's clipped sides
# (4 each) and their product, which decides a pair whose product is 0; the union (2), its floor, the division and
# the comparison with the threshold where it is not (csrc/nms.cu)
NMS_AREA_OPS, NMS_DISJOINT_OPS, NMS_PAIR_OPS = 3, 9, 14


def scene(h: int, w: int, batch: int) -> np.ndarray:
    """Synthetic scene with realistic edge density: blocks, a disc, a smooth
    gradient, mild noise (the headline benchmark's input, ``bench.py``)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.3 + 0.2 * (xx / w)
    img[200:700, 300:900] = 0.8
    img[400:900, 1100:1700] = 0.15
    disc = (yy - 540) ** 2 + (xx - 960) ** 2 < 200**2
    img[disc] = 0.95
    img = img + rng.normal(0, 0.01, (h, w)).astype(np.float32)
    return np.broadcast_to(img, (batch, h, w)).reshape(batch, h, w, 1).copy()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def spread_ms(fn, iters: int, warmup: int = 2):
    """(mean, least, most) device time of one call of ``fn`` in ms, each of
    ``iters`` calls between its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    marks[0].record()
    for mark in marks[1:]:
        fn()
        mark.record()
    marks[-1].synchronize()
    times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return sum(times) / iters, min(times), max(times)


def clock_under(fn, calls: int) -> str:
    """The card's SM clock and power draw as ``nvidia-smi`` reads them while
    ``calls`` queued calls of ``fn`` run (the wrappers return before the card
    is done, so the query lands inside the window)."""
    for _ in range(calls):
        fn()
    read = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    return read


def scaled_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (1 + |ref|): the least tolerance t for which
    ``out`` is within t * (1 + |ref|) of ``ref``."""
    ref = ref.float()
    return float(((out.float() - ref).abs() / (1 + ref.abs())).max())


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(least time in ms, what bounds it) for moving ``nbytes`` and doing
    ``ops`` operations at the card's peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err_f32(out: torch.Tensor, ref: torch.Tensor, what: str, atol: float = F32_ATOL,
                rtol: float = F32_RTOL) -> float:
    require(out.shape == ref.shape and out.dtype == ref.dtype, f"{what}: shape/dtype differ")
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    ref = ref.float()
    err = (out.float() - ref).abs_()
    worst = float(err.max())
    require(bool((err <= ref.abs().mul_(rtol).add_(atol)).all()), f"{what}: max |err| {worst}")
    return worst


def exact(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    require(out.shape == ref.shape and out.dtype == ref.dtype, f"{what}: shape/dtype differ")
    diff = int((out != ref).sum())
    require(diff == 0, f"{what}: {diff} elements differ")
    return 0.0


def tie_confined(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The rule the repo's tests hold the fused Canny to against the op-by-op
    one on an image with tied magnitudes: under 2% of pixels differ, each
    next to a reference edge; returns the mismatch fraction."""
    mismatch = out != ref
    ref_dil = F.max_pool2d(ref[None].float(), 3, 1, 1)[0] > 0
    require(bool((mismatch <= ref_dil).all()), "canny mismatch away from reference edges")
    frac = float(mismatch.float().mean())
    require(frac < 0.02, f"canny tie mismatch fraction {frac}")
    return frac


def resnet_layer_by_layer(model, images: torch.Tensor) -> torch.Tensor:
    """The logits of the port's ``ResNet`` from a copy of its modules called
    one by one on contiguous NCHW maps and weights (the model itself runs
    functional operators on channels-last maps and weights, so cuDNN sums in
    another order there)."""
    model = copy.deepcopy(model).to(memory_format=torch.contiguous_format)
    x = images.permute(0, 3, 1, 2).contiguous()
    x = F.max_pool2d(torch.relu(model.bn1(model.conv1(x))), 3, 2, 1)
    for stage in (model.layer1, model.layer2, model.layer3, model.layer4):
        for block in stage:
            out = x
            convs = [(block.conv1, block.bn1), (block.conv2, block.bn2)]
            if hasattr(block, "conv3"):
                convs.append((block.conv3, block.bn3))
            for i, (conv, bn) in enumerate(convs):
                out = bn(conv(out))
                if i < len(convs) - 1:
                    out = torch.relu(out)
            x = torch.relu(out + (x if block.downsample is None else block.downsample(x)))
    return model.fc(x.mean(dim=(2, 3)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from cpu_vision_tpu_torch import _dtype, graft_entry, models, ops
    from cpu_vision_tpu_torch.ops import kernels
    from cpu_vision_tpu_torch.ops.kernels import (_build, conv_block, depthwise, flash_attention, int8_matmul,
                                                  int8_transformer, stencil, swin_attention, transformer_block)
    from cpu_vision_tpu_torch.ops.kernels import nms as nms_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for stem, log in logs.items():
        fn = ""
        for line in log.splitlines():
            named = re.search(r"Compiling entry function '(\S+)'", line)
            fn = named.group(1) if named else fn
            if "Used" in line or "spill" in line or ("wgmma" in line.lower() and ("warning" in line.lower()
                                                                               or "serialized" in line)):
                print(f"  {stem}: {line.strip()}")
            # the split-TF32 products, the bf16 weight gradient, the depthwise convolution (49 sums and 49 taps
            # a thread), the int8 MLP's s8 products, the LayerNorm backward's rows held in registers and the float32
            # window core: no spill, and no wgmma that ptxas serialises
            if any(k in fn for k in ("x3_gemm_kernel", "wgrad_bf16_kernel", "depthwise_kernel", "i8_tc_gemm_kernel",
                                     "ln_backward_vec_kernel", "window_x3_kernel", "attention_x3_kernel",
                                     "attention_tc_kernel")) and "spill" in line:
                require(" 0 bytes spill stores, 0 bytes spill loads" in line, f"{stem}: {fn} spills: {line.strip()}")
            if "serialized" in line and any(k in line for k in ("x3_gemm_kernel", "wgrad_bf16_kernel",
                                                                 "i8_tc_gemm_kernel", "conv3x3_x3_kernel")):
                raise AssertionError(f"{stem}: {line.strip()}")
    # the bf16 products of rows 10-13 and the bf16 attention cores of rows 9, 11, 13 and 16 run on the tensor cores:
    # HGMMA (wgmma) in every instantiation of the product and of the cores (the attention core at head dims 16,
    # 64 and 80), and no bf16 instantiation of the scalar kernels they replaced is left in the libraries
    # (the scalar attention core stays only as the float32 yardstick, below)
    hgmma, core_hgmma = {}, {}
    for stem in ("attention", "transformer_block", "int8_transformer", "swin_attention"):
        counts_by_fn = _build.sass_counts(stem, "HGMMA")
        products = {fn: c for fn, c in counts_by_fn.items() if "tc_gemm_kernel" in fn}
        cores = {fn: c for fn, c in counts_by_fn.items() if "attention_tc_kernel" in fn or "window_tc_kernel" in fn}
        print(f"  {stem}: HGMMA instructions in SASS (cuobjdump): {products} {cores}")
        if stem in ("transformer_block", "swin_attention"):
            require(len(products) >= 2 and all(c > 0 for c in products.values()), f"{stem}: a product without HGMMA")
        require(len(cores) >= 1 and all(c > 0 for c in cores.values()), f"{stem}: an attention core without HGMMA")
        require(not any("mlp_block_kernel" in fn and "bfloat16" in fn for fn in counts_by_fn),
                f"{stem}: a bf16 instantiation of a scalar kernel is left")
        require(not any("bfloat16" in fn and (("attention_core_kernel" in fn and "Li64E" in fn)
                                              or "window_core_kernel" in fn) for fn in counts_by_fn),
                f"{stem}: a bf16 head-dim-64 attention_core_kernel or a bf16 window_core_kernel is left")
        # no route reaches the scalar attention core: its only instantiations are the float32 yardstick's
        # (cvt_attention_core_scalar in the attention library, float32 in and out at head dims 16, 64 and 80)
        scalar_cores = [fn for fn in counts_by_fn if "attention_core_kernel" in fn]
        yardsticks = [f"attention_core_kernelIfLi{hd}EfE" for hd in (16, 64, 80)] if stem == "attention" else []
        require(len(scalar_cores) == len(yardsticks) and all(any(y in fn for fn in scalar_cores) for y in yardsticks),
                f"{stem}: an attention_core_kernel other than the float32 yardstick's: {scalar_cores}")
        require(sum(1 for fn in cores if "attention_tc_kernel" in fn) == {"attention": 3, "transformer_block": 3,
                                                                          "int8_transformer": 3}.get(stem, 0),
                f"{stem}: the bf16 attention core is not at head dims 16, 64 and 80: {sorted(cores)}")
        hgmma[stem] = sum(products.values())
        core_hgmma[stem] = sum(cores.values())
    # every int8 product runs on the int8 tensor cores: IGMMA (wgmma s8) and no IDP4A in every instantiation of
    # i8_tc_gemm_kernel (int8_transformer: the MLP's two epilogues and the attention block's two, in both dtypes;
    # int8_matmul: requantised or f32 out, with and without relu), and the dp4a kernels they replaced are gone
    i8_sass = {}
    for stem, instances in (("int8_transformer", 8), ("int8_matmul", 4)):
        i8_igmma, i8_dp4a = _build.sass_counts(stem, "IGMMA"), _build.sass_counts(stem, "IDP4A")
        i8_sass[stem] = {fn: (c, i8_dp4a.get(fn, 0)) for fn, c in i8_igmma.items() if "i8_tc_gemm_kernel" in fn}
        print(f"  {stem}: (IGMMA, IDP4A) in the int8 products {i8_sass[stem]}")
        require(len(i8_sass[stem]) == instances and all(ig > 0 and dp == 0 for ig, dp in i8_sass[stem].values()),
                f"{stem}: an int8 product without IGMMA, or with IDP4A")
        require(not any(dp for dp in i8_dp4a.values()), f"{stem}: a kernel holds IDP4A")
        require(not any("mlp_int8_kernel" in fn or "i8_gemm_kernel" in fn for fn in i8_igmma),
                f"{stem}: a dp4a kernel (mlp_int8_kernel, i8_gemm_kernel) is left")
    i8_products = i8_sass["int8_transformer"]
    # the attention core's backward (Kernel B: query-tile blocks with and without O, key-tile blocks) runs on the
    # tensor cores in all three instantiations; the float32 core at head dims 16, 64 and 80 on split TF32 (HGMMA ...
    # .TF32), into float32 and, in the int8 block's library, into int8
    bwd_hgmma = {fn: c for fn, c in _build.sass_counts("attention", "HGMMA").items() if "attention_bwd_" in fn}
    print(f"  attention: HGMMA in the core's backward {bwd_hgmma}")
    require(len(bwd_hgmma) == 3 and all(bwd_hgmma.values()), "attention: a core backward without HGMMA")
    x3_core_hgmma = {fn: c for fn, c in _build.sass_counts("attention", "HGMMA", ".TF32").items()
                     if "attention_x3_kernel" in fn}
    print(f"  attention: HGMMA .TF32 in the float32 core {x3_core_hgmma}")
    require(len(x3_core_hgmma) == 3 and all(x3_core_hgmma.values()), "attention: a float32 core without HGMMA .TF32")
    x3_int8_hgmma = {fn: c for fn, c in _build.sass_counts("int8_transformer", "HGMMA", ".TF32").items()
                     if "attention_x3_kernel" in fn}
    print(f"  int8_transformer: HGMMA .TF32 in the float32 core into int8 {x3_int8_hgmma}")
    require(len(x3_int8_hgmma) == 3 and all(x3_int8_hgmma.values()),
            "int8_transformer: a float32 core into int8 without HGMMA .TF32")
    for name in flash_attention.KERNEL_INFO:
        print(f"  {name}: {flash_attention.kernel_info(name)} (registers a thread, dynamic shared memory a block, "
              f"blocks an SM)")
    # the float32 products of mlp_block / cn_mlp_block / attention_block / window_attention_block and both dtypes of
    # wgrad_matmul run on the tensor cores: HGMMA ... .TF32 in every split-TF32 instantiation (x3_gemm_kernel),
    # HGMMA ... .BF16 in every bf16 weight gradient one, and none of the scalar f32 mlp_block_kernel, the scalar
    # wgrad_partial_kernel or the scalar f32 product ln_gemm_kernel (deleted: no library may hold it) is left
    for stem in ("attention", "transformer_block", "swin_attention", "int8_transformer", "wgrad_matmul"):
        require(not any("ln_gemm_kernel" in fn for fn in _build.sass_counts(stem, "HGMMA")),
                f"{stem}: the scalar ln_gemm_kernel is left")
    tf32_hgmma = {}
    for stem, scalar in (("transformer_block", "mlp_block_kernel"), ("swin_attention", "ln_gemm_kernel"),
                         ("wgrad_matmul", "wgrad_partial_kernel")):
        tf32 = {fn: c for fn, c in _build.sass_counts(stem, "HGMMA", ".TF32").items() if "x3_gemm_kernel" in fn}
        bf16 = {fn: c for fn, c in _build.sass_counts(stem, "HGMMA", ".BF16").items() if "wgrad_bf16_kernel" in fn}
        print(f"  {stem}: HGMMA .TF32 in SASS {tf32}, .BF16 {bf16}")
        require(len(tf32) >= {"transformer_block": 3, "swin_attention": 2, "wgrad_matmul": 4}[stem]
                and all(tf32.values()), f"{stem}: a split-TF32 product without HGMMA .TF32")
        require(stem != "wgrad_matmul" or (len(bf16) == 4 and all(bf16.values())),
                f"{stem}: a bf16 weight-gradient instantiation without HGMMA .BF16")
        require(not any(scalar in fn for fn in _build.sass_counts(stem, "HGMMA")), f"{stem}: {scalar} is left")
        tf32_hgmma[stem] = sum(tf32.values()) + sum(bf16.values())
    # the float32 window core (row 13) runs on split TF32: HGMMA ... .TF32 in window_x3_kernel, and the scalar
    # window_core_kernel it replaced is gone from the library in both dtypes
    swin_tf32 = _build.sass_counts("swin_attention", "HGMMA", ".TF32")
    window_x3_hgmma = {fn: c for fn, c in swin_tf32.items() if "window_x3_kernel" in fn}
    window_core_info = {name: swin_attention.kernel_info(name) for name in swin_attention.KERNEL_INFO}
    print(f"  swin_attention: HGMMA .TF32 in the float32 window core {window_x3_hgmma}; occupancy {window_core_info} "
          f"(registers a thread, dynamic shared memory a block, blocks an SM)")
    require(len(window_x3_hgmma) == 1 and all(window_x3_hgmma.values()),
            "swin_attention: the float32 window core without HGMMA .TF32")
    require(not any("window_core_kernel" in fn for fn in swin_tf32), "swin_attention: the scalar window_core_kernel is left")
    # the fused convolution stage (row 7) is an implicit GEMM on split TF32: HGMMA ... .TF32 in both instantiations
    # (32 and 64 output channels a block), no FFMA main loop (fewer FFMA than HGMMA), and the scalar
    # conv3x3_relu_pool_kernel it replaced is gone
    conv_tf32 = {fn: c for fn, c in _build.sass_counts("conv_block", "HGMMA", ".TF32").items() if "conv3x3" in fn}
    conv_ffma = _build.sass_counts("conv_block", "FFMA")
    conv_sass = {fn: (c, conv_ffma.get(fn, 0)) for fn, c in conv_tf32.items()}
    print(f"  conv_block: (HGMMA .TF32, FFMA) in SASS {conv_sass}")
    require(len(conv_sass) == 2 and all(0 < hg and ffma < hg for hg, ffma in conv_sass.values()),
            "conv_block: an instantiation without HGMMA .TF32, or with an FFMA loop")
    require(not any("conv3x3_relu_pool_kernel" in fn for fn in conv_ffma), "conv_block: the scalar kernel is left")

    # Every main path is driven with the counts at 0 and read just after: the wrappers' counts, and their counts
    # by input shape and dtype, from which each per-shape row of the kernels' line takes its launches.
    path_shapes = {}  # {main path: {wrapper: {(shape, dtype): launches}}}

    def read_counts(path):
        torch.cuda.synchronize()
        path_shapes[path] = kernels.launch_counts_by_shape()
        return kernels.launch_counts()

    def launches_at(name, shape, dtype):
        """{main path: launches} of the wrapper ``name`` on inputs of ``shape`` and ``dtype``, as counted."""
        key = (tuple(shape), dtype)
        return {path: by[name][key] for path, by in path_shapes.items() if key in by[name]}

    def launches_of(name):
        """{main path: launches} of the wrapper ``name`` on any input, as counted."""
        return {path: sum(by[name].values()) for path, by in path_shapes.items() if by[name]}

    # ---------------------------------------------- main path 1: Canny 1080p b8
    b, h, w = 8, 1080, 1920
    frames = scene(h, w, b)
    kernels.reset_launch_counts()
    edges = ops.canny(frames, low_threshold=0.1, high_threshold=0.2)  # numpy in: runs on the card
    canny_counts = read_counts("canny 1080p b8")
    canny_reads = stencil.hysteresis_fixpoint.host_reads  # the fixpoint's reads of its device flags
    print(f"canny main path launches: {canny_counts}")
    require(canny_counts["canny_stage1"] >= 1 and canny_counts["hysteresis_sweeps"] >= 1,
            "ops.canny did not go through canny_stage1 and hysteresis_sweeps")
    require(edges.device.type == "cuda" and edges.shape == (b, h, w, 1) and edges.dtype == torch.float32,
            "canny output shape/dtype/device")
    require(bool(((edges == 0) | (edges == 1)).all()), "canny output not 0/1")

    x = torch.from_numpy(frames).to(dev)
    maps = x[..., 0].contiguous()
    cls_twin = stencil.canny_stage1_plain(maps, ops.get_gaussian_kernel1d(5, 1.4, device="cpu").numpy(),
                                          0.1, 0.2)
    edges_twin = ops.hysteresis(cls_twin == 2, cls_twin >= 1).to(torch.float32)[..., None]
    exact(edges, edges_twin, "canny vs the plain twin path")
    edges_op = ops.canny(x, 0.1, 0.2, backend="plain")
    op_frac = float((edges != edges_op).float().mean())
    print(f"canny 1080p b8: edge pixels {int(edges.sum())}, equal to twin path; "
          f"mismatch vs op-by-op path {op_frac:.3e}")

    # small inputs held to the repo's test rules against the op-by-op path
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(rng.random((56, 72), dtype=np.float32)).to(dev)
    exact(ops.canny(noise, 0.3, 0.6), ops.canny(noise, 0.3, 0.6, backend="plain"), "canny on noise")
    step = torch.full((64, 80), 0.1, device=dev)
    step[20:44, 24:60] = 0.9
    step_frac = tie_confined(ops.canny(step, 0.1, 0.3), ops.canny(step, 0.1, 0.3, backend="plain"))
    print(f"canny small inputs: noise exact, step mismatch {step_frac:.4f}")

    canny_ms = time_ms(lambda: ops.canny(x, 0.1, 0.2), iters=20)
    print(f"canny 1080p b8: {canny_ms:.4f} ms/batch, {b * h * w / canny_ms / 1e6:.3f} GPix/s, "
          f"{canny_counts['hysteresis_sweeps']} hysteresis passes of {stencil.SWEEPS_PER_PASS} sweeps, "
          f"{canny_reads} host flag reads ({card})")

    # -------------------- main path 1b: Canny with the in-tile hysteresis, 1080p b8
    def passes_to_fixpoint(cls_map):
        kernels.reset_launch_counts()
        fixed = kernels.hysteresis_fixpoint(cls_map)
        return fixed, kernels.launch_counts()["hysteresis_sweeps"]

    kernels.reset_launch_counts()
    cls_tile = kernels.canny_stage1(maps, 0.1, 0.2, in_tile_hysteresis=True)
    fixed_tile = kernels.hysteresis_fixpoint(cls_tile)
    tile_counts = read_counts("canny in-tile 1080p b8")
    print(f"canny with in-tile hysteresis main path launches: {tile_counts}")
    require(tile_counts["canny_stage1_in_tile"] >= 1 and tile_counts["canny_stage1"] == 0,
            "the option did not go through the in-tile kernel")
    fixed_base, base_passes = passes_to_fixpoint(kernels.canny_stage1(maps, 0.1, 0.2))
    exact(fixed_tile, fixed_base, "in-tile hysteresis: global fixpoint on the scene")
    noise8 = torch.from_numpy(rng.random((b, h, w), dtype=np.float32)).to(dev)
    noise_tile, noise_tile_passes = passes_to_fixpoint(kernels.canny_stage1(noise8, 0.3, 0.6, in_tile_hysteresis=True))
    noise_base, noise_base_passes = passes_to_fixpoint(kernels.canny_stage1(noise8, 0.3, 0.6))
    exact(noise_tile, noise_base, "in-tile hysteresis: global fixpoint on noise")
    tile_passes = {"scene": (tile_counts["hysteresis_sweeps"], base_passes), "noise": (noise_tile_passes, noise_base_passes)}
    print("global hysteresis passes with / without the in-tile option: "
          + ", ".join(f"{k} {v[0]} / {v[1]}" for k, v in tile_passes.items()))
    del noise_tile, noise_base, fixed_tile, fixed_base

    # ------------------------------------ main path 2: blur + Sobel, 512x512
    img512 = rng.random((512, 512), dtype=np.float32)
    kernels.reset_launch_counts()
    mag512 = kernels.fused_blur_sobel(img512, 5, 1.5)
    bs_counts = read_counts("blur+sobel 512x512")
    print(f"blur+sobel main path launches: {bs_counts}")
    require(bs_counts["fused_blur_sobel"] >= 1, "fused_blur_sobel did not launch")
    x512 = torch.from_numpy(img512).to(dev)
    op512 = ops.sobel(ops.gaussian_blur(x512, 5, 1.5))
    print(f"blur+sobel 512x512 vs op-by-op: max |err| {float((mag512 - op512).abs().max()):.3e}")
    require(bool(torch.allclose(mag512, op512, rtol=0, atol=1e-5)), "blur+sobel vs op-by-op")

    # ------------------------------------- main path 3: Harris 2 MP batch 32
    hb = 32
    imgs32 = rng.random((hb, h, w, 1), dtype=np.float32)
    kernels.reset_launch_counts()
    resp = kernels.harris_response_fused(imgs32)
    hr_counts = read_counts("harris 2 MP b32")
    print(f"harris main path launches: {hr_counts}")
    require(hr_counts["harris_response_fused"] >= 1, "harris_response_fused did not launch")
    require(resp.shape == (hb, h, w, 1) and bool(torch.isfinite(resp).all()), "harris output")
    small = torch.from_numpy(imgs32[0, :64, :96]).to(dev)
    err_small = float((kernels.harris_response_fused(small) - ops.harris_response(small)).abs().max())
    print(f"harris 64x96 vs op-by-op: max |err| {err_small:.3e}")
    require(err_small <= 1e-5, "harris vs op-by-op")

    del resp

    # -------------------- main path 4: the small CNN at full width, batch 256
    require(not torch.backends.cuda.matmul.allow_tf32, "float32 matrix products must not run in TF32")
    cnn = {}
    for hw, cin in ((28, 1), (224, 3)):
        params = ops.cnn_init(torch.Generator().manual_seed(0), (hw, hw), cin, (32, 64), 128, 10)
        images = rng.random((256, hw, hw, cin), dtype=np.float32)
        kernels.reset_launch_counts()
        logits = ops.cnn_forward(params, images)  # numpy in: runs on the card
        counts = read_counts(f"cnn {hw}x{hw}x{cin} b256")
        print(f"cnn {hw}x{hw}x{cin} main path launches: {counts}")
        require(counts["fused_conv3x3_relu_pool"] == 2, "cnn_forward did not launch the fused stage twice")
        require(logits.device.type == "cuda" and logits.shape == (256, 10) and logits.dtype == torch.float32,
                "cnn logits shape/dtype/device")
        xc = torch.from_numpy(images).to(dev)
        errs = {backend: max_err_f32(logits, ops.cnn_forward(params, xc, backend=backend), f"cnn {hw} vs {backend}",
                                     LOGIT_TOL, LOGIT_TOL) for backend in ("plain", "stock")}
        ms = time_ms(lambda: ops.cnn_forward(params, xc), 20)
        stock_ms = time_ms(lambda: ops.cnn_forward(params, xc, backend="stock"), 20)
        print(f"cnn {hw}x{hw}x{cin} b256: {ms:.4f} ms/batch, {256 / ms * 1e3:.1f} img/s; stock route "
              f"{stock_ms:.4f} ms/batch, {256 / stock_ms * 1e3:.1f} img/s; logits max |err| vs plain "
              f"{errs['plain']:.3e}, vs stock {errs['stock']:.3e} ({card})")
        cnn[hw] = (params, xc, f"cnn {hw}x{hw}x{cin} b256")
    del logits, images

    # ----------- main path 5: pyramid + resize + rotate + blur, 64 RGB 640x480
    batch3 = rng.random((64, 480, 640, 3), dtype=np.float32)
    kernels.reset_launch_counts()
    levels = ops.laplacian_pyramid(batch3, 4)  # numpy in: runs on the card
    small = ops.resize(levels[0], (240, 320), "bilinear", True)
    rec = ops.reconstruct_from_laplacian(levels)
    x3 = torch.from_numpy(batch3).to(dev)
    rot = ops.rotate(x3, 30.0, "bilinear", fill=0)
    blurred = kernels.fused_gaussian_blur(x3, 5, 1.5)
    p5_counts = read_counts("pyramid/resize/rotate/blur 64x480x640x3")
    print(f"pyramid/resize/rotate/blur main path launches: {p5_counts}")
    require(p5_counts["fused_gaussian_blur"] >= 1, "fused_gaussian_blur did not launch")
    require([tuple(lv.shape[1:3]) for lv in levels] == [(480, 640), (240, 320), (120, 160), (60, 80)]
            and all(lv.device.type == "cuda" and bool(torch.isfinite(lv).all()) for lv in levels), "pyramid levels")
    rec_err = float((rec - x3).abs().max())
    require(rec.shape == x3.shape and rec_err <= 1e-5, f"Laplacian reconstruction: max |err| {rec_err}")
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    small_ref = nhwc(F.interpolate(nchw(levels[0]), (240, 320), mode="bilinear", antialias=True))
    small_err = float((small - small_ref).abs().max())
    require(small.shape == (64, 240, 320, 3) and small_err <= 1e-4, f"resize vs F.interpolate: max |err| {small_err}")
    grid = ops.affine_grid(ops.get_rotation_matrix(-30.0), 640, 480, 640, 480).expand(4, -1, -1, -1)
    masked = torch.cat([x3[:4], torch.ones_like(x3[:4, :, :, :1])], dim=-1)  # fill=0 goes through a warped mask
    rot_ref = nhwc(F.grid_sample(nchw(masked), grid, mode="bilinear", padding_mode="zeros", align_corners=False))
    rot_ref = rot_ref[..., :3] * rot_ref[..., 3:]
    rot_err = float((rot[:4] - rot_ref).abs().max())
    require(rot.shape == x3.shape and bool(torch.isfinite(rot).all()) and rot_err <= 1e-4,
            f"rotate vs F.grid_sample: max |err| {rot_err}")
    blur_err = float((blurred - ops.gaussian_blur(x3, 5, 1.5)).abs().max())
    require(blurred.shape == x3.shape and blurred.is_contiguous() and blur_err <= 1e-5,
            f"fused blur vs ops.gaussian_blur: max |err| {blur_err}, contiguous {blurred.is_contiguous()}")
    print(f"config 3: reconstruction max |err| {rec_err:.3e}, resize vs F.interpolate {small_err:.3e}, "
          f"rotate vs F.grid_sample {rot_err:.3e}, fused blur vs op-by-op {blur_err:.3e}")
    del levels, small, small_ref, rec, rot, rot_ref, masked, blurred, grid
    pyr_ms = time_ms(lambda: ops.resize(ops.laplacian_pyramid(x3, 4)[0], (240, 320), "bilinear", True), 5)
    rot_ms = time_ms(lambda: ops.rotate(x3, 30.0, "bilinear", fill=0), 5)
    print(f"config 3, 64x480x640x3: pyramid + resize {pyr_ms:.4f} ms/batch, {64 / pyr_ms * 1e3:.1f} img/s; "
          f"rotate {rot_ms:.4f} ms/batch ({card})")


    # ------- main paths 6 and 7: ViT-B/16 serving, bf16 batch 256 and f32 batch 64
    vit_images = np.random.default_rng(0).random((256, 224, 224, 3), dtype=np.float32)
    vit_state = None
    vit = {}
    for dtype, batch, expected in ((torch.bfloat16, 256, {"attention_block": 12, "mlp_block": 12, "flash_mha": 0}),
                                   (torch.float32, 64, {"attention_block": 0, "mlp_block": 12, "flash_mha": 12})):
        name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
        model = models.get_model("vit_b_16", dtype=dtype, generator=torch.Generator().manual_seed(0))
        plain = models.get_model("vit_b_16", dtype=dtype, attention="plain", mlp="plain")
        if vit_state is None:
            vit_state = model.state_dict()
        model.load_state_dict(vit_state)  # one set of weights for both dtypes
        plain.load_state_dict(vit_state)
        kernels.reset_launch_counts()
        logits = model(vit_images[:batch])  # numpy in: runs on the card
        counts = read_counts(f"vit_b_16 {name} b{batch}")
        print(f"vit_b_16 {name} b{batch} main path launches: {counts} (routes {model.routes()}, "
              f"{kernels.attention_block.kernel_launches} kernel launches in attention_block, "
              f"{kernels.mlp_block.kernel_launches} in mlp_block)")
        require({k: counts[k] for k in expected} == expected, f"vit_b_16 {name}: expected launches {expected}")
        require(logits.device.type == "cuda" and logits.shape == (batch, 1000) and logits.dtype == dtype,
                "vit logits shape/dtype/device")
        xv = torch.from_numpy(vit_images[:batch]).to(dev)
        ref = plain(xv)
        err = max_err_f32(logits, ref, f"vit_b_16 {name} vs the stock-operator route", VIT_TOL[dtype], VIT_TOL[dtype])
        top1 = float((logits.argmax(dim=1) == ref.argmax(dim=1)).float().mean())
        if dtype == torch.float32:
            vit_f32_mlp_kernel_launches = kernels.mlp_block.kernel_launches
            require(vit_f32_mlp_kernel_launches == 36, "vit_b_16 f32: three launches an mlp_block (LN, two products)")
        if dtype == torch.bfloat16:
            vit_block_kernel_launches = kernels.attention_block.kernel_launches
            vit_mlp_kernel_launches = kernels.mlp_block.kernel_launches
            require(vit_block_kernel_launches == 48 and vit_mlp_kernel_launches == 36,
                    "vit_b_16 bf16: four launches an attention_block, three an mlp_block")
            exact32 = models.get_model("vit_b_16", attention="plain", mlp="plain")
            exact32.load_state_dict(vit_state)
            truth = exact32(xv)
            err_kernel, err_stock = (float((o.float() - truth).abs().max()) for o in (logits, ref))
            print(f"vit_b_16 bf16 b256 against the float32 logits: kernel route max |err| {err_kernel:.3e}, "
                  f"stock-operator route {err_stock:.3e}; top-1 agreement {float((logits.argmax(1) == truth.argmax(1)).float().mean()):.4f} "
                  f"and {float((ref.argmax(1) == truth.argmax(1)).float().mean()):.4f}")
            print(f"vit_b_16 bf16 b256, max |a - b| / (1 + |b|): kernel route vs stock bf16 route {scaled_err(logits, ref):.3e}, "
                  f"kernel route vs float32 {scaled_err(logits, truth):.3e}, stock bf16 route vs float32 {scaled_err(ref, truth):.3e}")
            require(err_kernel <= BF16_SLACK * err_stock, "the kernel route strays further from float32 than the stock route")
            del exact32, truth
        ms, ms_least, ms_most = spread_ms(lambda: model(xv), 10, warmup=2)
        plain_ms, plain_least, plain_most = spread_ms(lambda: plain(xv), 10, warmup=2)
        print(f"vit_b_16 {name} b{batch}: {ms:.4f} ms/batch ({ms_least:.4f} to {ms_most:.4f} over 10 calls), "
              f"{batch / ms * 1e3:.1f} img/s; stock-operator route {plain_ms:.4f} ms/batch ({plain_least:.4f} to "
              f"{plain_most:.4f}), {batch / plain_ms * 1e3:.1f} img/s; logits max |err| vs that route {err:.3e} "
              f"(max |logit| {float(ref.abs().max()):.3f}), top-1 agreement {top1:.4f} ({card}); "
              f"under this route's load: {clock_under(lambda: model(xv), 3 if dtype == torch.bfloat16 else 10)}")
        vit[dtype] = counts
        del model, plain, logits, ref, xv
    del vit_state, vit_images

    # ------- main paths 29 and 30: ViT-H/14 serving, bf16 batch 64 and f32 batch 16, at full width and depth
    # (32 layers, D 1280, 16 heads of 80, MLP 5120, 224x224 at patch 14: S 257), weights from seed 0.  The None routes
    # take flash_mha (the tensor-core cores at head dim 80) and mlp_block in every layer; held to the same weights on
    # the plain routes (bf16 within 8e-2 (1 + |ref|) and no further from the float32 logits than BF16_SLACK times the
    # plain bf16 route; f32 within 1e-3 (1 + |ref|), TF32 off), and the core's own launch timed beside its bound and
    # SDPA at the path's shape
    vith_images = np.random.default_rng(1).random((64, 224, 224, 3), dtype=np.float32)
    vith_state = None
    vith_expected = {"flash_mha": 32, "mlp_block": 32, "attention_block": 0}
    for dtype, batch in ((torch.bfloat16, 64), (torch.float32, 16)):
        name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
        path = f"vit_h_14 {name} b{batch}"
        model = models.get_model("vit_h_14", dtype=dtype, generator=torch.Generator().manual_seed(0))
        plain = models.get_model("vit_h_14", dtype=dtype, attention="plain", mlp="plain")
        if vith_state is None:
            vith_state = {k: v.float() for k, v in model.state_dict().items()}
        model.load_state_dict(vith_state)  # one set of weights for both dtypes
        plain.load_state_dict(vith_state)
        kernels.reset_launch_counts()
        logits = model(vith_images[:batch])  # numpy in: runs on the card
        counts = read_counts(path)
        print(f"{path} main path launches: {counts} (routes {model.routes()}, "
              f"{kernels.mlp_block.kernel_launches} kernel launches in mlp_block)")
        require(model.routes() == ("flash", "block"), f"{path}: routes {model.routes()}, not flash_mha and mlp_block")
        require({k: counts[k] for k in vith_expected} == vith_expected, f"{path}: expected launches {vith_expected}")
        require(logits.device.type == "cuda" and logits.shape == (batch, 1000) and logits.dtype == dtype
                and bool(torch.isfinite(logits.float()).all()), f"{path}: logits shape/dtype/device or not finite")
        xv = torch.from_numpy(vith_images[:batch]).to(dev)
        ref = plain(xv)
        err = max_err_f32(logits, ref, f"{path} vs the plain routes", VIT_TOL[dtype], VIT_TOL[dtype])
        top1 = float((logits.argmax(dim=1) == ref.argmax(dim=1)).float().mean())
        if dtype == torch.bfloat16:
            exact32 = models.get_model("vit_h_14", attention="plain", mlp="plain")
            exact32.load_state_dict(vith_state)
            truth = exact32(xv)
            err_kernel, err_plain = (float((o.float() - truth).abs().max()) for o in (logits, ref))
            print(f"{path} against the float32 logits: kernel routes max |err| {err_kernel:.3e} (scaled "
                  f"{scaled_err(logits, truth):.3e}), plain bf16 routes {err_plain:.3e} (scaled "
                  f"{scaled_err(ref, truth):.3e})")
            require(err_kernel <= BF16_SLACK * err_plain, f"{path}: the kernel routes stray further from float32 "
                    f"than {BF16_SLACK} times the plain bf16 routes")
            del exact32, truth
        ms, ms_least, ms_most = spread_ms(lambda: model(xv), 10, warmup=2)
        plain_ms, plain_least, plain_most = spread_ms(lambda: plain(xv), 10, warmup=2)
        # the core's own launch at the path's shape: q, k, v and o once at the memory rate, 4 S^2 hd + 5 S^2
        # operations a head at the rate of its dtype's products (bf16, or split TF32 at 165 TFLOP/s)
        qc, kc, vc = (torch.randn((batch, 257, 16, 80), device=dev).to(dtype) for _ in range(3))
        core_ms = time_ms(lambda: kernels.flash_mha(qc, kc, vc, 80 ** -0.5), 20)
        core_bound = bound(4 * qc.numel() * qc.element_size(), batch * 16 * 257 * 257 * (4 * 80 + 5),
                           BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32X3_OPS_PER_S)
        qh, kh, vh = (a.permute(0, 2, 1, 3) for a in (qc, kc, vc))
        core_library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=80 ** -0.5), 20)
        print(f"{path}: {ms:.4f} ms/batch ({ms_least:.4f} to {ms_most:.4f} over 10 calls), {batch / ms * 1e3:.1f} "
              f"img/s; plain routes {plain_ms:.4f} ms/batch ({plain_least:.4f} to {plain_most:.4f}); logits max |err| "
              f"vs the plain routes {err:.3e} (max |logit| {float(ref.abs().max()):.3f}), top-1 agreement {top1:.4f}; "
              f"core_ms {core_ms:.4f}, core_bound_ms {core_bound[0]:.4f} ({core_bound[1]}), core_library_ms "
              f"{core_library_ms:.4f} (SDPA), 32 cores a forward ({card})")
        del model, plain, logits, ref, xv, qc, kc, vc, qh, kh, vh
    del vith_state, vith_images

    # ------------- main path 8: ResNet-50 f32, stock operators only (no kernel of the port)
    kernels.reset_launch_counts()
    forward, (r50, images4) = graft_entry.entry()
    logits4 = forward(r50, images4)
    torch.cuda.synchronize()
    require(all(v == 0 for v in kernels.launch_counts().values()), "ResNet-50 launched a kernel of the port")
    require(logits4.device.type == "cuda" and logits4.shape == (4, 1000) and logits4.dtype == torch.float32,
            "resnet50 logits shape/dtype/device")
    with _dtype.full_float32(), torch.no_grad():
        err4 = max_err_f32(logits4, resnet_layer_by_layer(r50, images4), "resnet50 b4 vs layer by layer",
                           LOGIT_TOL, LOGIT_TOL)
    r50_ms4, r50_least4, r50_most4 = spread_ms(lambda: forward(r50, images4), 50, warmup=5)
    # the initialiser zeroes each block's last batch-norm scale, so the residual
    # branches contribute nothing; switch them on for the batch-256 check
    with torch.no_grad():
        for stage in (r50.layer1, r50.layer2, r50.layer3, r50.layer4):
            for block in stage:
                block.last_bn.weight.fill_(0.25)
    images256 = torch.from_numpy(rng.random((256, 224, 224, 3), dtype=np.float32)).to(dev)
    logits256 = r50(images256)
    require(logits256.shape == (256, 1000), "resnet50 b256 logits shape")
    with _dtype.full_float32(), torch.no_grad():
        err256 = max_err_f32(logits256, resnet_layer_by_layer(r50, images256), "resnet50 b256 vs layer by layer",
                             LOGIT_TOL, LOGIT_TOL)
    r50_ms256, r50_least256, r50_most256 = spread_ms(lambda: r50(images256), 10)
    print(f"resnet50 f32 (stock operators in full f32, no kernel of the port runs here): b4 {r50_ms4:.4f} ms/batch "
          f"({r50_least4:.4f} to {r50_most4:.4f} over 50 calls), {4 / r50_ms4 * 1e3:.1f} img/s, logits max |err| vs layer "
          f"by layer {err4:.3e}; b256 {r50_ms256:.4f} ms/batch ({r50_least256:.4f} to {r50_most256:.4f} over 10 calls), "
          f"{256 / r50_ms256 * 1e3:.1f} img/s, max |err| {err256:.3e} (max |logit| "
          f"{float(logits256.abs().max()):.3f}) ({card})")
    del r50, images4, images256, logits4, logits256

    # ------ main paths 9 to 14: Swin (v1, v2, padded) and ConvNeXt serving at full depth and width
    serve_images = np.random.default_rng(1).random((256, 256, 256, 3), dtype=np.float32)
    served = {}

    def serve(label, name, dtype, batch, size, kernel_kw, plain_kw, expected, state=None, prepare=None):
        """One serving path: ``name`` built on the kernel routes (``kernel_kw``)
        and on the plain routes, one set of weights (``state`` or seed 0), the
        kernels' counts read around one forward, the logits held against the
        plain routes, both timed over 10 single calls."""
        model = models.get_model(name, dtype=dtype, generator=torch.Generator().manual_seed(0), **kernel_kw)
        plain_name = "swin_t" if name == "swin_t_padded" else name  # the padded model is held against the native one
        plain = models.get_model(plain_name, dtype=dtype, **plain_kw)
        if prepare is not None:
            prepare(model)
        native_state = model.state_dict() if state is None else state
        if state is not None:
            model.load_state_dict(models.pad_swin_state_dict(state) if name == "swin_t_padded" else state)
        plain.load_state_dict(native_state)
        images = serve_images[:batch, :size, :size]
        kernels.reset_launch_counts()
        logits = model(images)  # numpy in: runs on the card
        counts = read_counts(label)
        window_launches = kernels.window_attention_block.kernel_launches
        mlp_launches = kernels.mlp_block.kernel_launches + kernels.cn_mlp_block.kernel_launches
        print(f"{label} main path launches: {counts} ({window_launches} kernel launches in window_attention_block, "
              f"{mlp_launches} in mlp_block and cn_mlp_block)")
        require({k: counts[k] for k in expected} == expected, f"{label}: expected launches {expected}")
        require(logits.device.type == "cuda" and logits.shape == (batch, 1000) and logits.dtype == dtype,
                f"{label}: logits shape/dtype/device")
        xv = torch.from_numpy(images).to(dev)
        ref = plain(xv)
        err = max_err_f32(logits, ref, f"{label} vs the plain routes", VIT_TOL[dtype], VIT_TOL[dtype])
        top1 = float((logits.argmax(dim=1) == ref.argmax(dim=1)).float().mean())
        against_f32 = ""
        if dtype == torch.bfloat16:
            exact32 = models.get_model(plain_name, **plain_kw)
            exact32.load_state_dict(native_state)
            truth = exact32(xv)
            err_kernel, err_plain = (float((o.float() - truth).abs().max()) for o in (logits, ref))
            require(err_kernel <= BF16_SLACK * err_plain, f"{label}: the kernel routes stray further from float32 "
                    f"({err_kernel:.3e}) than {BF16_SLACK} times the plain routes ({err_plain:.3e})")
            against_f32 = (f"; against the float32 logits: kernel routes max |err| {err_kernel:.3e} (scaled "
                           f"{scaled_err(logits, truth):.3e}), plain bf16 routes {err_plain:.3e} (scaled "
                           f"{scaled_err(ref, truth):.3e}), kernel vs plain scaled {scaled_err(logits, ref):.3e}")
            del exact32, truth
        ms, ms_least, ms_most = spread_ms(lambda: model(xv), 10, warmup=2)
        plain_ms, plain_least, plain_most = spread_ms(lambda: plain(xv), 10, warmup=2)
        print(f"{label}: {ms:.4f} ms/batch ({ms_least:.4f} to {ms_most:.4f} over 10 calls), {batch / ms * 1e3:.1f} img/s; "
              f"plain routes {plain_ms:.4f} ms/batch ({plain_least:.4f} to {plain_most:.4f}), "
              f"{batch / plain_ms * 1e3:.1f} img/s; logits max |err| vs the plain routes {err:.3e} (max |logit| "
              f"{float(ref.abs().max()):.3f}), top-1 agreement {top1:.4f}{against_f32} ({card}); under this path's "
              f"load: {clock_under(lambda: model(xv), 3)}")
        served[label] = dict(counts=counts, window_launches=window_launches, mlp_launches=mlp_launches, ms=ms,
                             logits=logits, state=native_state)
        del model, plain, ref, xv

    SWIN, SWIN_V2, SWIN_PADDED, SWIN_F32 = ("swin_t bf16 b256", "swin_v2_t 256x256 bf16 b64", "swin_t_padded bf16 b64",
                                            "swin_t f32 b32")
    CN, CN_STOCK = "convnext_tiny bf16 b256, depthwise kernel", "convnext_tiny bf16 b256, stock depthwise"
    both = {"window_attention_block": 12, "mlp_block": 12, "cn_mlp_block": 0, "depthwise_conv2d": 0}
    plain_swin = dict(attention="plain", mlp="plain")
    serve(SWIN, "swin_t", torch.bfloat16, 256, 224, {}, plain_swin, both)
    swin_state = served[SWIN]["state"]
    serve(SWIN_V2, "swin_v2_t", torch.bfloat16, 64, 256, {}, plain_swin, both)
    require(served[SWIN_V2]["window_launches"] == 60, "bf16 v2 is five kernel launches a block (v, then q and k in "
                                                      "float64, the core, the output projection, LN + residual)")
    serve(SWIN_PADDED, "swin_t_padded", torch.bfloat16, 64, 224, {}, plain_swin, both, state=swin_state)
    # the same weights and images through the native model's kernels: the padded lanes change nothing but rounding
    native64 = served[SWIN]["logits"][:64]
    padded_err = max_err_f32(served[SWIN_PADDED]["logits"], native64, "swin_t_padded vs swin_t on the kernels",
                             VIT_TOL[torch.bfloat16], VIT_TOL[torch.bfloat16])
    print(f"swin_t_padded vs swin_t, both on the kernel routes, same weights and images: logits max |err| {padded_err:.3e}")
    # float32 at batch 32: the JAX package's memory rule sends the last stage's attention (C 768) to the plain route
    f32_routes = models.get_model("swin_t", device="cpu").routes(32, 224, 224)
    f32_expected = dict(both, window_attention_block=sum(a == "block" for a, _ in f32_routes),
                        mlp_block=sum(m == "block" for _, m in f32_routes))
    require(f32_expected["window_attention_block"] == 10 and f32_expected["mlp_block"] == 12, "swin_t f32 routes")
    serve(SWIN_F32, "swin_t", torch.float32, 32, 224, {}, plain_swin, f32_expected, state=swin_state)

    def visible_layer_scale(model):
        # the initial layer scale of 1e-6 would hide every block's branch from the check
        with torch.no_grad():
            for block in model.blocks():
                block.layer_scale.fill_(0.25)

    plain_cn = dict(mlp="plain", depthwise="stock")
    cn_expected = {"window_attention_block": 0, "mlp_block": 0, "cn_mlp_block": 18, "depthwise_conv2d": 18}
    serve(CN, "convnext_tiny", torch.bfloat16, 256, 224, dict(depthwise="kernel"), plain_cn, cn_expected,
          prepare=visible_layer_scale)
    serve(CN_STOCK, "convnext_tiny", torch.bfloat16, 256, 224, {}, plain_cn, dict(cn_expected, depthwise_conv2d=0),
          prepare=visible_layer_scale)
    window_kernel_launches = {label: path["window_launches"] for label, path in served.items() if path["window_launches"]}
    mlp_kernel_launches = {label: path["mlp_launches"] for label, path in served.items() if path["mlp_launches"]}
    require(mlp_kernel_launches[SWIN] == 36 and mlp_kernel_launches[CN] == 54 and window_kernel_launches[SWIN] == 48,
            "bf16 Swin-T and ConvNeXt-T: three launches an MLP block, four a v1 window block")
    require(mlp_kernel_launches[SWIN_F32] == 36, "f32 Swin-T: three launches an MLP block (LN, two products)")
    del serve_images, swin_state, native64
    served.clear()

    # ------ main paths 15 to 17: Faster R-CNN ResNet-50 FPN serving through detection.detect, b8 on a 640x640 canvas
    from cpu_vision_tpu_torch.models import detection
    from cpu_vision_tpu_torch.ops.boxes import box_iou, clip_boxes_to_image

    det_rng = np.random.default_rng(2)
    det_sizes = [(480, 640), (640, 427), (512, 512), (427, 640), (640, 480), (375, 500), (500, 375), (640, 640)]
    det_images = [torch.from_numpy(det_rng.random((hh, ww, 3), dtype=np.float32)).to(dev) for hh, ww in det_sizes]
    DET_BF16, DET_F32, DET_V2 = ("fasterrcnn_resnet50_fpn bf16 b8 640x640", "fasterrcnn_resnet50_fpn f32 b8 640x640",
                                 "fasterrcnn_resnet50_fpn_v2 f32 b8 640x640")
    det_nms_shapes = {((32, 1000, 4), torch.float32): 1, ((8, 300, 4), torch.float32): 1,
                      ((8, 4096, 4), torch.float32): 1}  # the RPN's 4 levels of 1000 and 1 of 300, the postprocess

    def detector(name, dtype, state=None):
        model = models.get_model(name, dtype=dtype, generator=torch.Generator().manual_seed(0), **DET_SETTINGS)
        if state is None:
            with torch.no_grad():
                model.roi_heads.box_predictor.cls_score.weight.mul_(DET_CLS_SCALE[name])
        else:
            model.load_state_dict(state)
        return model

    def deterministic(fn):
        torch.backends.cudnn.deterministic = True
        try:
            return fn()
        finally:
            torch.backends.cudnn.deterministic = False

    def serve_detector(label, model):
        """One detection path: counts read around one ``detect`` of the 8 images, its output checked, the route
        on the kernel held equal to the plain route's, ``detect`` timed over 10 single calls."""
        kernels.reset_launch_counts()
        dets = detection.detect(model, det_images)
        counts = read_counts(label)
        by_shape = path_shapes[label]["nms_sorted"]
        print(f"{label} main path launches: {counts}; nms_sorted by shape {by_shape}")
        require(counts["nms_sorted"] == 3 and by_shape == det_nms_shapes, f"{label}: nms_sorted launches {by_shape}")
        require(len(dets) == 8 and all(d["boxes"].shape == (100, 4) and d["boxes"].device.type == "cuda"
                                       and bool(torch.isfinite(d["boxes"]).all()) for d in dets), f"{label}: detections")
        valid = [int(d["valid"].sum()) for d in dets]
        require(sum(valid) > 0, f"{label}: no valid detection")
        require(all(bool((d["labels"][d["valid"]] >= 1).all()) and bool((d["scores"][d["valid"]] > 0.05).all())
                    for d in dets), f"{label}: labels and scores of the valid detections")
        kernel_dets = deterministic(lambda: detection.detect(model, det_images))
        model.set_nms("plain")
        plain_dets = deterministic(lambda: detection.detect(model, det_images))
        plain_ms, plain_least, plain_most = spread_ms(lambda: detection.detect(model, det_images), 3, warmup=1)
        model.set_nms(None)
        for a, b in zip(kernel_dets, plain_dets):
            for key in a:
                exact(a[key], b[key], f"{label}: {key} on the kernel route vs the plain route")
        ms, ms_least, ms_most = spread_ms(lambda: detection.detect(model, det_images), 10, warmup=2)
        print(f"{label}: {ms:.4f} ms/batch ({ms_least:.4f} to {ms_most:.4f} over 10 calls of detect), "
              f"{8 / ms * 1e3:.1f} img/s; nms_sorted launches a forward {counts['nms_sorted']} ({by_shape}); valid "
              f"detections by image {valid}; equal to the plain NMS route, which takes {plain_ms:.4f} ms/batch "
              f"({plain_least:.4f} to {plain_most:.4f} over 3 calls) ({card}); under this path's load: "
              f"{clock_under(lambda: detection.detect(model, det_images), 3)}")
        return dets, ms

    det_bf16 = detector("fasterrcnn_resnet50_fpn", torch.bfloat16)
    det_state = det_bf16.state_dict()
    dets_bf16, det_bf16_ms = serve_detector(DET_BF16, det_bf16)
    det_f32 = detector("fasterrcnn_resnet50_fpn", torch.float32, det_state)
    dets_f32, det_f32_ms = serve_detector(DET_F32, det_f32)

    # bfloat16 against float32, same weights: the dense scores and boxes of the float32 run's proposals
    batch, _, _ = detection.GeneralizedRCNNTransform(min_size=320, max_size=640)(det_images)
    canvas = (batch.shape[1], batch.shape[2])
    with _dtype.full_float32(), torch.no_grad():
        feats32 = det_f32.backbone(batch)
        props32, _, _ = det_f32.rpn(feats32, canvas)
        dense = {}
        for name, model in (("f32", det_f32), ("bf16", det_bf16)):
            feats = feats32 if model is det_f32 else model.backbone(batch)
            cl, bd = model.roi_heads(feats[:-1], props32, canvas)
            dense[name] = (cl.float(), bd.float(), torch.softmax(cl.float(), -1)[..., 1:],
                           clip_boxes_to_image(model.roi_heads.coder.decode(bd.float()[:, :, 1:], props32[:, :, None]),
                                               canvas))
    logit_err, delta_err, box_err = (scaled_err(dense["bf16"][i], dense["f32"][i]) for i in (0, 1, 3))
    score_rel = float(((dense["bf16"][2] - dense["f32"][2]).abs() / dense["f32"][2]).max())
    box_px = float((dense["bf16"][3] - dense["f32"][3]).abs().max())
    require(max(logit_err, delta_err) <= VIT_TOL[torch.bfloat16],
            f"bf16 detector vs f32: class logits {logit_err:.3e}, box deltas {delta_err:.3e}")
    matched, total = 0, 0
    for ref_det, got_det in zip(dets_f32, dets_bf16):
        ref_boxes, ref_labels = ref_det["boxes"][ref_det["valid"]], ref_det["labels"][ref_det["valid"]]
        got_boxes, got_labels = got_det["boxes"][got_det["valid"]], got_det["labels"][got_det["valid"]]
        total += len(ref_boxes)
        if len(ref_boxes) and len(got_boxes):
            same = (box_iou(ref_boxes, got_boxes) >= 0.5) & (ref_labels[:, None] == got_labels[None, :])
            matched += int(same.any(dim=1).sum())
    print(f"fasterrcnn_resnet50_fpn bf16 vs f32, same weights, on the f32 run's proposals, max |a - b| / (1 + |b|): "
          f"class logits {logit_err:.3e}, box deltas {delta_err:.3e}, decoded boxes {box_err:.3e} (max |a - b| "
          f"{box_px:.3f} px); scores max |a - b| / |b| {score_rel:.3e}; {matched} of {total} valid "
          f"f32 detections have a bf16 detection of their label at IoU >= 0.5 (the random head's scores differ by "
          f"less than a bf16 step, so the top 100 are chosen by rounding)")
    del feats32, props32, dense, batch

    det_v2 = detector("fasterrcnn_resnet50_fpn_v2", torch.float32)
    dets_v2, det_v2_ms = serve_detector(DET_V2, det_v2)

    # the real inputs of the three nms_sorted calls of one float32 forward, for the kernel's rows
    with nms_kernel.recording() as calls:
        det_f32(detection.GeneralizedRCNNTransform(min_size=320, max_size=640)(det_images)[0])
    nms_inputs = {(tuple(boxes.shape), float(thr)): boxes for boxes, thr in calls}
    del det_bf16, det_f32, det_v2, det_state, dets_bf16, dets_f32, dets_v2

    # ------------------------------ main paths 18 and 19: int8 serving, ViT-B/16 and ResNet-50 at batch 256
    INT8_VIT, INT8_R50 = "int8 vit_b_16 bf16 b256", "int8 resnet50 b256"
    int8_images = torch.from_numpy(np.random.default_rng(0).random((256, 224, 224, 3), dtype=np.float32)).to(dev)
    vit16 = models.get_model("vit_b_16", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    veng = models.Int8ViT.from_model(vit16).calibrate([int8_images[:8]])  # bench_all.py:428
    kernels.reset_launch_counts()
    vlogits = veng(int8_images)
    vcounts = read_counts(INT8_VIT)
    vit_i8_kernel_launches = kernels.attention_block_int8.kernel_launches
    vit_i8_mlp_kernel_launches = kernels.mlp_block_int8.kernel_launches
    print(f"{INT8_VIT} main path launches: {vcounts} (routes {veng.routes()}, {vit_i8_kernel_launches} kernel "
          f"launches in attention_block_int8, {vit_i8_mlp_kernel_launches} in mlp_block_int8)")
    require(launches_at("mlp_block_int8", (256 * 197, 768), torch.bfloat16).get(INT8_VIT) == 12
            and launches_at("attention_block_int8", (256, 197, 768), torch.bfloat16).get(INT8_VIT) == 12
            and vit_i8_kernel_launches == 48 and vit_i8_mlp_kernel_launches == 36 and vcounts["mlp_block_int8"] == 12
            and vcounts["attention_block_int8"] == 12, f"{INT8_VIT}: expected 12 + 12 launches at its shapes, 48 + 36 "
            f"kernel launches")
    require(vlogits.device.type == "cuda" and vlogits.shape == (256, 1000) and vlogits.dtype == torch.float32
            and bool(torch.isfinite(vlogits).all()), "int8 vit logits shape/dtype/device/finite")
    vtwin = models.Int8ViT.from_model(vit16, route="plain").set_scales(veng.scales)(int8_images)
    verr = max_err_f32(vlogits, vtwin, f"{INT8_VIT} vs the same engine on its twins", VIT_TOL[torch.bfloat16],
                       VIT_TOL[torch.bfloat16])
    vbf16 = vit16(int8_images[:64]).float()
    vrel = float(torch.linalg.norm(vlogits[:64] - vbf16) / torch.linalg.norm(vbf16)) * 100
    vfloat = veng.float_reference(int8_images[:64])
    v_ms, v_least, v_most = spread_ms(lambda: veng(int8_images), 10, warmup=2)
    print(f"{INT8_VIT}: {v_ms:.4f} ms/batch ({v_least:.4f} to {v_most:.4f} over 10 calls), {256 / v_ms * 1e3:.1f} "
          f"img/s; logits vs the engine on its twins max |err| {verr:.3e}, scaled {scaled_err(vlogits, vtwin):.3e}; "
          f"|int8 - bf16 model| / |bf16 model| {vrel:.3f} % over 64 images, vs its float graph "
          f"{float(torch.linalg.norm(vlogits[:64] - vfloat) / torch.linalg.norm(vfloat)) * 100:.3f} % (random weights: "
          f"no accuracy figure) ({card}); under its load: {clock_under(lambda: veng(int8_images), 3)}")
    # the kernels' inputs at the main path's shapes: layer 0's real tokens and weights
    with torch.no_grad(), _dtype.full_float32():
        vit_tokens = veng._embed(int8_images)
        ly0, vsc = veng.layers[0], veng.scales
        vit_attn_args = (vit_tokens, ly0.g0, ly0.b0, ly0.qw_qkv, ly0.s_qkv, ly0.b_qkv, ly0.qw_o, ly0.s_o, ly0.b_o,
                         vsc["L0/attn_in"], vsc["L0/attn_out"], 12, 64 ** -0.5, 1e-6)
        vit_mlp_args = (kernels.attention_block_int8(*vit_attn_args).reshape(-1, 768), ly0.g1, ly0.b1ln, ly0.qw1,
                        ly0.s1, ly0.b1, ly0.qw2, ly0.s2, ly0.b2, vsc["L0/mlp_in"], vsc["L0/mlp_gelu"], 1e-6)
    del vit16, vtwin, vbf16, vfloat, vlogits

    r50 = models.get_model("resnet50", generator=torch.Generator().manual_seed(0))
    bn_gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():  # else each block's last batch-norm scale is 0 and its residual branch vanishes
        for m_ in r50.modules():
            if isinstance(m_, torch.nn.BatchNorm2d):
                m_.weight.uniform_(0.5, 1.5, generator=bn_gen)
                m_.bias.uniform_(-0.1, 0.1, generator=bn_gen)
                m_.running_mean.uniform_(-0.3, 0.3, generator=bn_gen)
                m_.running_var.uniform_(0.5, 1.5, generator=bn_gen)
    reng = models.Int8ResNet.from_model(r50).calibrate([int8_images[:32]])  # bench_all.py:410-411
    kernels.reset_launch_counts()
    with int8_matmul.recording() as r50_calls:
        rlogits = reng(int8_images)
        rcounts = read_counts(INT8_R50)
    print(f"{INT8_R50} main path launches: {rcounts}")
    require(rcounts["int8_matmul_requant"] == 36 and len(r50_calls) == 36,
            f"{INT8_R50}: expected 36 int8_matmul_requant launches (16 blocks x 2 + 4 downsamples)")
    require(rlogits.shape == (256, 1000) and bool(torch.isfinite(rlogits).all()), "int8 resnet50 logits")
    r50_held = {}
    for qx_, qw_, sc_, b_, os_, relu_, out_ in r50_calls:  # every launch equal to its twin bit for bit
        exact(out_, int8_matmul.int8_matmul_requant_plain(qx_, qw_, sc_, b_, os_, relu_),
              f"int8_matmul_requant {tuple(qx_.shape)} x {tuple(qw_.shape)}")
        key = (tuple(qx_.shape), qw_.shape[1], relu_)
        r50_held[key] = r50_held.get(key, 0) + 1
    rstock = models.Int8ResNet.from_model(r50, conv1x1="stock").set_scales(reng.scales)(int8_images)
    route_diff = float((rlogits - rstock).abs().max())
    rfloat = reng.float_reference(int8_images[:64])
    r_ms, r_least, r_most = spread_ms(lambda: reng(int8_images), 10, warmup=2)
    reng_stock = models.Int8ResNet.from_model(r50, conv1x1="stock").set_scales(reng.scales)
    rs_ms, rs_least, rs_most = spread_ms(lambda: reng_stock(int8_images), 3, warmup=1)
    print(f"{INT8_R50}: {r_ms:.4f} ms/batch ({r_least:.4f} to {r_most:.4f} over 10 calls), {256 / r_ms * 1e3:.1f} "
          f"img/s; stock 1x1 route {rs_ms:.4f} ms/batch ({rs_least:.4f} to {rs_most:.4f} over 3 calls); every one of "
          f"the 36 launches equal to its twin ({len(r50_held)} shapes); logits on conv1x1=None vs \"stock\": "
          f"max |a - b| {route_diff:.3e} ({'bit for bit' if route_diff == 0 else 'NOT bit for bit'}); "
          f"|int8 - f32 model| / |f32 model| "
          f"{float(torch.linalg.norm(rlogits[:64] - rfloat) / torch.linalg.norm(rfloat)) * 100:.3f} % over 64 images "
          f"(random weights: no accuracy figure) ({card}); under its load: {clock_under(lambda: reng(int8_images), 3)}")
    r50_inputs = [(qx_, qw_, sc_, b_, os_, relu_) for qx_, qw_, sc_, b_, os_, relu_, _ in r50_calls]
    del r50_calls, rstock, rfloat, rlogits, r50, int8_images, reng_stock

    # ------ main paths 20 and 21: ViT-B/16 training, bf16 b128, 3 SGD steps (lr 0.1, momentum 0.9: bench_all.py:497-531)
    # on the kernel routes (attention_block + mlp_block forward, their twins' gradients) and on the plain routes
    from cpu_vision_tpu_torch import parallel
    from cpu_vision_tpu_torch.models import resnet as resnet_module

    train_rng = np.random.default_rng(3)
    train_images = torch.from_numpy(train_rng.random((128, 224, 224, 3), dtype=np.float32)).to(dev)
    train_labels = torch.from_numpy(train_rng.integers(0, 1000, 128)).to(dev)

    def xent(model, batch):  # bench_all.py:514: cross entropy of float32 logits with integer labels
        return F.cross_entropy(model(batch[0], train=True).float(), batch[1]), {}

    def busy_ms(events):
        """Length of the union of the profiler's kernel intervals, in ms."""
        spans = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        total, cur = 0.0, None
        for start, end in spans:
            if cur is None or start > cur[1]:
                total += 0 if cur is None else cur[1] - cur[0]
                cur = [start, end]
            else:
                cur[1] = max(cur[1], end)
        return (total + (0 if cur is None else cur[1] - cur[0])) / 1e3

    def profile_step(model, optimizer, top=8):
        """One more step of ``model`` as ``parallel.make_train_step`` takes it, with CUDA events between its phases
        (forward, backward, optimizer update: ms on the card's clock), and one under ``torch.profiler``: the card's
        busy share and the kernels with the most device time, by name."""
        from torch.profiler import ProfilerActivity, profile

        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.zero_grad(set_to_none=True)
        ev[0].record()
        with _dtype.full_float32():
            loss = xent(model, (train_images, train_labels))[0]
            ev[1].record()
            loss.backward()
        ev[2].record()
        optimizer.step()
        ev[3].record()
        ev[3].synchronize()
        split = {"forward": ev[0].elapsed_time(ev[1]), "backward": ev[1].elapsed_time(ev[2]),
                 "optimizer": ev[2].elapsed_time(ev[3])}
        step = parallel.make_train_step(xent, optimizer)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ev[0].record()
            step(model, (train_images, train_labels))
            ev[1].record()
            ev[1].synchronize()
        wall, busy = ev[0].elapsed_time(ev[1]), busy_ms(prof.events())
        by_kernel = sorted(((e.key[:70], round(e.device_time_total / 1e3, 4), e.count) for e in prof.key_averages()
                            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0),
                           key=lambda r: -r[1])
        return dict(phases_ms=split, backward_share=split["backward"] / sum(split.values()), wall_ms=wall,
                    busy_ms=busy, busy_share=busy / wall, top_kernels=by_kernel[:top])

    def train(model, label, steps, after_first=None, profiled=None):
        """``steps`` SGD steps of ``model`` on the training batch through ``parallel.make_train_step``, the counts
        at 0 before them and read after them: (losses, ms a step from the host's clock, the first step's gradients
        by parameter, counts).  ``after_first()`` runs between the first step and the next; with a dict
        ``profiled``, one more step is profiled after the counts are read (``profile_step``) into it."""
        optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        step = parallel.make_train_step(xent, optimizer)
        kernels.reset_launch_counts()
        losses, ms, first = [], [], None
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, _ = step(model, (train_images, train_labels))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
            if first is None:
                first = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
                if after_first is not None:
                    after_first()
        counts = read_counts(label)
        require(all(math.isfinite(v) for v in losses) and all(bool(torch.isfinite(p).all()) for p in model.parameters()),
                f"{label}: a loss or a parameter is not finite")
        if profiled is not None:
            profiled.update(profile_step(model, optimizer))
        return losses, ms, first, counts

    def worst_param_gap(got, want):
        """(max over parameters of max|got - want| / max|want|, that parameter)."""
        return max((float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-30), n) for n in want)

    def l2_gap(got, want):
        """||got - want|| / ||want|| over all parameters together."""
        num = sum(float((got[n].double() - want[n].double()).square().sum()) for n in want)
        return math.sqrt(num / sum(float(want[n].double().square().sum()) for n in want))

    VIT_TRAIN, VIT_TRAIN_PLAIN, VIT_TRAIN_F32 = ("vit_b_16 train bf16 b128", "vit_b_16 train bf16 b128 plain routes",
                                                 "vit_b_16 train f32 b128 plain routes")
    vit_state = models.get_model("vit_b_16", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).state_dict()
    runs, profiles = {}, {VIT_TRAIN: {}, VIT_TRAIN_PLAIN: {}}
    # the bf16 kernel routes' backward must not recompute a twin: every call of one is counted during that path
    twin_calls, twins = [], {name: getattr(transformer_block, name) for name in ("mlp_block_plain",
                                                                                "attention_block_plain")}
    for twin_name, twin in twins.items():
        setattr(transformer_block, twin_name,
                lambda *a, twin=twin, twin_name=twin_name, **kw: twin_calls.append(twin_name) or twin(*a, **kw))
    for label, dtype, kw, steps in ((VIT_TRAIN, torch.bfloat16, {}, 3),
                                    (VIT_TRAIN_PLAIN, torch.bfloat16, dict(attention="plain", mlp="plain"), 3),
                                    (VIT_TRAIN_F32, torch.float32, dict(attention="plain", mlp="plain"), 1)):
        vit_t = models.get_model("vit_b_16", dtype=dtype, **kw)
        vit_t.load_state_dict(vit_state)
        require(vit_t.routes(train=True) == (("block", "block") if not kw else ("plain", "plain")), f"{label}: routes")
        torch.cuda.reset_peak_memory_stats()
        runs[label] = train(vit_t, label, steps, profiled=profiles.get(label))
        runs[label] += (torch.cuda.max_memory_allocated() / 2**30,)
        if label == VIT_TRAIN:
            require(not twin_calls, f"{VIT_TRAIN}: the backward recomputed a twin {len(twin_calls)} times")
        del vit_t
    for twin_name, twin in twins.items():
        setattr(transformer_block, twin_name, twin)
    (k_loss, k_ms, k_grads, k_counts, k_mem), (p_loss, p_ms, p_grads, p_counts, p_mem), (f_loss, f_ms, f_grads, _, _) = (
        runs[VIT_TRAIN], runs[VIT_TRAIN_PLAIN], runs[VIT_TRAIN_F32])
    print(f"{VIT_TRAIN} main path launches: {k_counts} over 3 steps")
    print(f"backward taken: {VIT_TRAIN}: attention_block and mlp_block the card's own (Kernel B "
          f"attention_core_backward, Kernel A mlp_gelu_backward, ln_backward_rows, bf16_product, wgrad_matmul; "
          f"transformer_block.attention_backward_takes / mlp_backward_takes); {VIT_TRAIN_PLAIN} and "
          f"{VIT_TRAIN_F32}: autograd of stock operators; resnet50: autograd of stock operators; the CNN's conv "
          f"stage: its twin recomputed (fused_conv3x3_relu_pool); conv1x1: wgrad_matmul from 16,384 rows")
    require(launches_at("attention_block", (128, 197, 768), torch.bfloat16).get(VIT_TRAIN) == 36
            and launches_at("mlp_block", (128 * 197, 768), torch.bfloat16).get(VIT_TRAIN) == 36
            and k_counts["attention_block"] == 36 and k_counts["mlp_block"] == 36,
            f"{VIT_TRAIN}: expected 12 attention_block and 12 mlp_block launches a forward")
    # the backward of every block on the card's kernels: one Kernel A an MLP, one Kernel B an attention block, two
    # LayerNorm backward rows a layer, three activation-gradient products and four weight gradients a layer
    require((k_counts["mlp_gelu_backward"], k_counts["attention_core_backward"], k_counts["ln_backward_rows"],
             k_counts["bf16_product"], k_counts["wgrad_matmul"]) == (36, 36, 72, 108, 144),
            f"{VIT_TRAIN}: expected 36 Kernel A, 36 Kernel B, 72 ln_backward_rows, 108 bf16_product and 144 "
            f"wgrad_matmul launches over 3 steps")
    for label, prof in profiles.items():
        print(f"{label}: one more step, on the card's clock {prof['phases_ms']} (backward "
              f"{100 * prof['backward_share']:.1f}%), profiled wall {prof['wall_ms']:.4f} ms, busy "
              f"{prof['busy_ms']:.4f} ms ({100 * prof['busy_share']:.1f}%); top kernels (name, ms, launches): "
              f"{prof['top_kernels']} ({card})")
    require(all(v == 0 for v in p_counts.values()), f"{VIT_TRAIN_PLAIN}: the plain routes launched a kernel")
    loss_gap = abs(k_loss[0] - p_loss[0]) / (1 + abs(p_loss[0]))
    require(loss_gap <= VIT_TOL[torch.bfloat16], f"{VIT_TRAIN}: step-0 loss {k_loss[0]} vs the plain routes' {p_loss[0]}")
    vit_gap, vit_gap_at = worst_param_gap(k_grads, p_grads)
    vit_f32_gap, _ = worst_param_gap(k_grads, f_grads)
    plain_f32_gap, _ = worst_param_gap(p_grads, f_grads)
    require(vit_gap <= GRAD_TOL, f"{VIT_TRAIN}: {vit_gap_at}'s gradient {vit_gap:.3e} of its largest entry from the "
                                 f"plain routes'")
    require(vit_f32_gap <= BF16_SLACK * plain_f32_gap, f"{VIT_TRAIN}: the kernel routes' gradients stray further "
            f"from float32 ({vit_f32_gap:.3e}) than {BF16_SLACK} times the plain routes' ({plain_f32_gap:.3e})")
    print(f"{VIT_TRAIN}: {k_ms[1:]} ms a step after the first ({k_ms[0]:.1f}), {128e3 / np.mean(k_ms[1:]):.1f} img/s, "
          f"peak {k_mem:.2f} GiB; plain routes {p_ms[1:]} ms ({p_ms[0]:.1f}), {128e3 / np.mean(p_ms[1:]):.1f} img/s, "
          f"peak {p_mem:.2f} GiB; f32 plain routes {f_ms[0]:.1f} ms (one step); losses {k_loss} and {p_loss} (f32 "
          f"{f_loss[0]:.6f}); first-step gradients, worst parameter max|a - b| / max|b|: kernel vs plain routes "
          f"{vit_gap:.3e} ({vit_gap_at}), kernel vs f32 {vit_f32_gap:.3e}, plain vs f32 {plain_f32_gap:.3e}; over all "
          f"parameters ||a - b|| / ||b||: kernel vs plain {l2_gap(k_grads, p_grads):.3e}, kernel vs f32 "
          f"{l2_gap(k_grads, f_grads):.3e}, plain vs f32 {l2_gap(p_grads, f_grads):.3e} ({card})")
    vit_train_ms = (float(np.mean(k_ms[1:])), float(np.mean(p_ms[1:])))
    del runs, k_grads, p_grads, f_grads, vit_state

    # ------ main path 22: ResNet-50 training, bf16 b128 with batch statistics (bench_all.py:533-572), 3 SGD steps;
    # its first step's gradients against a float32 run of the same weights, its running statistics against flax's rule
    R50_TRAIN, R50_TRAIN_F32 = "resnet50 train bf16 b128", "resnet50 train f32 b128"
    r50t = models.get_model("resnet50", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # else each block's last batch-norm scale is 0 and its branch gets no gradient
        for stage in (r50t.layer1, r50t.layer2, r50t.layer3, r50t.layer4):
            for block in stage:
                block.last_bn.weight.fill_(0.25)
    r50_state = {k: v.clone() for k, v in r50t.state_dict().items()}
    stat_gaps = []  # (worst gap of the running statistics, worst gap the unbiased variance's rule would leave)
    bn_recording = contextlib.ExitStack()
    bn_inputs = bn_recording.enter_context(resnet_module.recording())

    def check_stats():
        """Each batch norm's running statistics after the first step against flax's rule from its recorded input,
        in float64: mean within STAT_TOL * (1 + |ref|), variance within STAT_TOL * |ref|."""
        bn_recording.close()
        require(len(bn_inputs) == 53, f"{R50_TRAIN}: {len(bn_inputs)} batch norms recorded, not 53")
        worst = unbiased = 0.0
        for bn, x, mean0, var0 in bn_inputs:
            x64 = x.double()
            n = x64.numel() // x64.shape[1]
            var = x64.var(dim=(0, 2, 3), unbiased=False)
            m = 0.9 * mean0.double() + 0.1 * x64.mean(dim=(0, 2, 3))
            v = 0.9 * var0.double() + 0.1 * var
            worst = max(worst, float(((bn.running_mean.double() - m).abs() / (1 + m.abs())).max()),
                        float(((bn.running_var.double() - v).abs() / v).max()))
            unbiased = max(unbiased, float((0.1 * var / (n - 1) / v).max()))
        bn_inputs.clear()
        require(worst <= STAT_TOL, f"{R50_TRAIN}: running statistics {worst:.3e} from flax's rule")
        require(unbiased > STAT_TOL, f"{R50_TRAIN}: the unbiased variance's rule would stand only {unbiased:.3e} off, "
                                     f"within STAT_TOL = {STAT_TOL}: the check could not tell them apart")
        stat_gaps.append((worst, unbiased))

    try:
        r_loss, r_ms, r_grads, r_counts = train(r50t, R50_TRAIN, 3, after_first=check_stats)
    finally:
        bn_recording.close()
    require(all(v == 0 for v in r_counts.values()), f"{R50_TRAIN}: ResNet-50 launched a kernel of the port")
    r32t = models.get_model("resnet50")
    r32t.load_state_dict(r50_state)
    r32_loss, r32_ms, r32_grads, _ = train(r32t, R50_TRAIN_F32, 2)
    r50_l2 = l2_gap(r_grads, r32_grads)
    r50_norm = math.sqrt(sum(float(r_grads[n].double().square().sum()) for n in r32_grads)
                         / sum(float(r32_grads[n].double().square().sum()) for n in r32_grads))
    r50_worst, r50_worst_at = worst_param_gap(r_grads, r32_grads)
    require(r50_l2 < R50_GRAD_L2, f"{R50_TRAIN}: first-step gradients {r50_l2:.3e} of the norm from the f32 run's")
    require(abs(r50_norm - 1) <= R50_GRAD_NORM, f"{R50_TRAIN}: first-step gradients' norm {r50_norm:.4f} times the "
                                                f"f32 run's")
    print(f"{R50_TRAIN}: {r_ms[1:]} ms a step after the first ({r_ms[0]:.1f}), {128e3 / np.mean(r_ms[1:]):.1f} img/s; "
          f"f32 (TF32 off) {r32_ms[1]:.1f} ms a step ({r32_ms[0]:.1f}); losses {r_loss}, f32 {r32_loss}; first-step "
          f"gradients vs the f32 run: ||a - b|| / ||b|| {r50_l2:.3e}, ||a|| / ||b|| {r50_norm:.4f}, worst parameter "
          f"max|a - b| / max|b| {r50_worst:.3e} ({r50_worst_at}); 53 running statistics after step 1 within "
          f"{stat_gaps[0][0]:.3e} of flax's rule (the unbiased variance's rule would stand up to {stat_gaps[0][1]:.3e} "
          f"off) ({card})")
    r50_train_ms = (float(np.mean(r_ms[1:])), float(r32_ms[1]))
    del r50t, r32t, r_grads, r32_grads, r50_state, bn_inputs, train_images, train_labels

    # ------ main paths 23 and 24: the CNN at 28x28x1 b256, 3 SGD steps through cnn_forward on the conv kernel (the
    # default route on the card) and on the plain route, from the same parameters
    CNN_TRAIN, CNN_TRAIN_PLAIN = "cnn train 28x28x1 b256", "cnn train 28x28x1 b256 plain route"
    cnn_params0 = ops.cnn_init(torch.Generator().manual_seed(0), (28, 28), 1, (32, 64), 128, 10)
    cnn_x = torch.from_numpy(rng.random((256, 28, 28, 1), dtype=np.float32)).to(dev)
    cnn_y = torch.from_numpy(rng.integers(0, 10, 256)).to(dev)

    def cnn_train(backend, label):
        tree = {k: {n: t.clone().requires_grad_() for n, t in v.items()} for k, v in cnn_params0.items()}
        leaves = [t for v in tree.values() for t in v.values()]
        opt = torch.optim.SGD(leaves, lr=0.01, momentum=0.9)  # the JAX package's default lr; at 0.1 the loss diverges
        kernels.reset_launch_counts()
        losses, first, ms = [], None, []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            with _dtype.full_float32():
                loss = F.cross_entropy(ops.cnn_forward(tree, cnn_x, backend=backend), cnn_y)
                loss.backward()
            opt.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss.detach()))
            require(all(t.grad is not None for t in leaves), f"{label}: a parameter got no gradient")
            if first is None:
                first = [t.grad.detach().clone() for t in leaves]
        return losses, first, read_counts(label), ms

    c_loss, c_grads, c_counts, c_ms = cnn_train(None, CNN_TRAIN)
    cp_loss, cp_grads, cp_counts, cp_ms = cnn_train("plain", CNN_TRAIN_PLAIN)
    print(f"{CNN_TRAIN} main path launches: {c_counts} over 3 steps")
    require(c_counts["fused_conv3x3_relu_pool"] == 6 and cp_counts["fused_conv3x3_relu_pool"] == 0,
            f"{CNN_TRAIN}: expected the fused stage twice a forward on the kernel route only")
    cnn_grad_err = max(max_err_f32(a, b, f"{CNN_TRAIN} first-step gradients", CONV_ATOL, CONV_RTOL)
                       for a, b in zip(c_grads, cp_grads))
    require(all(abs(a - b) <= LOGIT_TOL * (1 + abs(b)) for a, b in zip(c_loss, cp_loss)), f"{CNN_TRAIN}: losses")
    print(f"{CNN_TRAIN}: {c_ms[1:]} ms a step after the first; plain route {cp_ms[1:]} ms; losses {c_loss} vs plain "
          f"{cp_loss}; first-step gradients max |kernel - plain| {cnn_grad_err:.3e} ({card})")

    # ------ main path 25: conv1x1 training at every 1x1 shape of ResNet-50 b128 with at least 16,384 rows: forward,
    # backward (the weight gradient on wgrad_matmul) and one SGD update of a PointwiseConv, in float32 and bfloat16
    CONV1X1 = "conv1x1 train, ResNet-50 b128 1x1 shapes"
    # (input side, Cin, Cout, stride) at batch 128: layer 1 (56x56, M 401,408); layer 2 (28x28, M 100,352, the
    # downsample from 56x56 with stride 2); layer 3 (14x14, M 25,088, the downsample from 28x28 with stride 2)
    conv1x1_shapes = [(56, 64, 64, 1), (56, 64, 256, 1), (56, 256, 64, 1), (56, 256, 128, 1),
                      (28, 128, 512, 1), (28, 512, 128, 1), (56, 256, 512, 2), (28, 512, 256, 1),
                      (14, 256, 1024, 1), (14, 1024, 256, 1), (28, 512, 1024, 2), (14, 1024, 512, 1)]
    c1_gen = torch.Generator(device=dev).manual_seed(5)
    c1_errs = {}
    kernels.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        for side, cin, cout, stride in conv1x1_shapes:
            c1_conv = ops.PointwiseConv(cin, cout, stride, dtype=dtype, generator=torch.Generator().manual_seed(cin + cout))
            c1_conv = c1_conv.to(dev)
            c1_x = torch.randn((128, side, side, cin), generator=c1_gen, device=dev).to(dtype).requires_grad_()
            c1_y = c1_conv(c1_x)
            c1_g = torch.randn(c1_y.shape, generator=c1_gen, device=dev).to(dtype)
            c1_y.backward(c1_g)
            c1_w0 = c1_conv.weight.detach().clone()
            torch.optim.SGD(c1_conv.parameters(), lr=0.1).step()
            require(bool(torch.allclose(c1_conv.weight, c1_w0 - 0.1 * c1_conv.weight.grad, rtol=1e-6, atol=1e-7)),
                    "SGD update")
            with _dtype.full_float32():  # the same values through F.conv2d autograd in float32
                c1_xr = c1_x.detach().float().requires_grad_()
                c1_wr = c1_w0.to(dtype).float().requires_grad_()
                c1_yr = F.conv2d(c1_xr.permute(0, 3, 1, 2), c1_wr, stride=stride).permute(0, 2, 3, 1)
                c1_yr.backward(c1_g.float())
            c1_tol = WGRAD_TOL if dtype == torch.float32 else C1_BF16_TOL
            c1_errs[(side, cin, cout, stride, str(dtype))] = []
            for c1_what, c1_got, c1_want in (("y", c1_y, c1_yr), ("dx", c1_x.grad, c1_xr.grad),
                                             ("dW", c1_conv.weight.grad, c1_wr.grad)):
                c1_err = float((c1_got.float() - c1_want).abs().max()) / float(c1_want.abs().max())
                require(c1_err <= c1_tol,
                        f"conv1x1 {side}x{side}x{cin}->{cout} s{stride} {dtype}: {c1_what} {c1_err:.3e} of max|ref|")
                c1_errs[(side, cin, cout, stride, str(dtype))].append(c1_err)
            del c1_conv, c1_x, c1_y, c1_g, c1_xr, c1_wr, c1_yr
    c1_counts = read_counts(CONV1X1)
    print(f"{CONV1X1} main path launches: {c1_counts}")
    c1_expected = {}
    for side, cin, cout, stride in conv1x1_shapes:
        rows_ = 128 * (side // stride) ** 2
        for dtype in (torch.float32, torch.bfloat16):
            c1_expected[((rows_, cin), dtype)] = c1_expected.get(((rows_, cin), dtype), 0) + 1
    require(c1_counts["wgrad_matmul"] == 24 and path_shapes[CONV1X1]["wgrad_matmul"] == c1_expected,
            f"{CONV1X1}: expected one wgrad_matmul launch a backward, got {path_shapes[CONV1X1]['wgrad_matmul']}")
    print(f"{CONV1X1}: every output, dx and dW against F.conv2d autograd in float32 on the same values, worst "
          f"max|a - b| / max|ref|: float32 {max(max(e) for k, e in c1_errs.items() if 'float32' in k[4]):.3e}, "
          f"bfloat16 {max(max(e) for k, e in c1_errs.items() if 'bfloat16' in k[4]):.3e} ({card})")

    # ------ main paths 26-28: Swin-T and ConvNeXt-T training, bf16 b128, 3 SGD steps (lr 0.1, momentum 0.9), the
    # stochastic depth drawn from a generator of one seed: Swin-T at its default sd_prob 0.2 (block 0, whose
    # probability is 0, on window_attention_block + mlp_block; the other eleven on the plain routes, the JAX rule),
    # Swin-T at sd_prob 0 (all twelve blocks on the kernels), ConvNeXt-T at its default 0.1 (block 0 on cn_mlp_block,
    # every block's depthwise convolution on depthwise_conv2d); each beside the same seeded steps on the plain routes
    from cpu_vision_tpu_torch.ops.kernels import _grad

    SWIN_TRAIN, SWIN_TRAIN_SD0 = "swin_t_train_b128_bf16", "swin_t_train_b128_bf16_sd0"
    CN_TRAIN = "convnext_tiny_train_b128_bf16"
    sc_rng = np.random.default_rng(4)
    sc_images = torch.from_numpy(sc_rng.random((128, 224, 224, 3), dtype=np.float32)).to(dev)
    sc_labels = torch.from_numpy(sc_rng.integers(0, 1000, 128)).to(dev)
    sc_gen = []  # the generator of the run under way
    sc_recompute = []  # [(start, end)] events around each recomputed backward of a kernel (row 13's on these paths)

    def sc_xent(model, batch):
        return F.cross_entropy(model(batch[0], train=True, generator=sc_gen[-1]).float(), batch[1]), {}

    @contextlib.contextmanager
    def sc_timed_recompute():
        """CUDA events around every backward that recomputes a kernel's twin (``_grad.recompute_backward``)."""
        saved = _grad._RecomputeBackward.__dict__["backward"]

        def timed(ctx, grad):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = saved.__func__(ctx, grad)
            ev[1].record()
            sc_recompute.append(ev)
            return out

        _grad._RecomputeBackward.backward = staticmethod(timed)
        try:
            yield
        finally:
            _grad._RecomputeBackward.backward = saved

    def sc_run(model, label):
        """3 steps of ``model``, the counts at 0 before them and read after them, each timed on the card's clock;
        then one more step split into forward, backward (and within it the recomputed backward, timed apart) and
        optimizer on the card's clock, and one under torch.profiler (the card's busy share, the kernels with the
        most device time)."""
        from torch.profiler import ProfilerActivity, profile

        optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        step = parallel.make_train_step(sc_xent, optimizer)
        sc_gen.append(torch.Generator(device=dev).manual_seed(11))
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, ms, first = [], [], None
        for _ in range(3):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            loss = step(model, (sc_images, sc_labels))[0]
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(loss))
            if first is None:
                first = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        counts = read_counts(label)
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(all(math.isfinite(v) for v in losses) and all(bool(torch.isfinite(p).all()) for p in model.parameters()),
                f"{label}: a loss or a parameter is not finite")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        model.zero_grad(set_to_none=True)
        sc_recompute.clear()
        with sc_timed_recompute():
            ev[0].record()
            with _dtype.full_float32():
                loss = sc_xent(model, (sc_images, sc_labels))[0]
                ev[1].record()
                loss.backward()
            ev[2].record()
        optimizer.step()
        ev[3].record()
        ev[3].synchronize()
        phases = {"forward": ev[0].elapsed_time(ev[1]), "backward": ev[1].elapsed_time(ev[2]),
                  "optimizer": ev[2].elapsed_time(ev[3])}
        recompute = [a.elapsed_time(b) for a, b in sc_recompute]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ev[0].record()
            step(model, (sc_images, sc_labels))
            ev[1].record()
            ev[1].synchronize()
        wall, busy = ev[0].elapsed_time(ev[1]), busy_ms(prof.events())
        top = sorted(((e.key[:70], round(e.device_time_total / 1e3, 4), e.count) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0),
                     key=lambda r: -r[1])[:8]
        return dict(losses=losses, ms=ms, first=first, counts=counts, peak_gib=peak, phases_ms=phases,
                    recompute_ms=sum(recompute), recompute_calls=len(recompute), wall_ms=wall, busy_ms=busy, top=top)

    def sc_path(label, name, state, kernel_kw, plain_kw, want_routes, routes_of, launches):
        """The kernel routes (``kernel_kw``) and the plain routes (``plain_kw``) of one model from ``state``, each
        through ``sc_run`` with the same seed: the first losses held to the bf16 model rule (VIT_TOL), the losses
        after one and two updates to SC_LOSS_TOL, the first gradients to SC_GRAD_L2 over all parameters and over
        those of the stem and of the blocks on the kernels, and the kernel routes' launches to ``launches``
        {wrapper: count over the 3 steps}."""
        runs = {}
        for route, kw in (("kernel", kernel_kw), ("plain", plain_kw)):
            model = models.get_model(name, dtype=torch.bfloat16, **kw)
            model.load_state_dict(state)
            if route == "kernel":
                require(routes_of(model) == want_routes, f"{label}: routes {routes_of(model)}")
                fused = {id(b) for b, r in zip(model.blocks(), want_routes) if r[0] == "block"}
                near = tuple(["features.0."] + [n + "." for n, m in model.named_modules() if id(m) in fused])
            runs[route] = sc_run(model, label if route == "kernel" else label + " plain routes")
            del model
        k, p = runs["kernel"], runs["plain"]
        print(f"{label} main path launches: {k['counts']} over 3 steps")
        require(all(k["counts"][name] == n for name, n in launches.items()),
                f"{label}: expected {launches} launches over 3 steps")
        require(all(v == 0 for v in p["counts"].values()), f"{label} plain routes: a kernel launched")
        gaps = [abs(a - b) / (1 + abs(b)) for a, b in zip(k["losses"], p["losses"])]
        require(gaps[0] <= VIT_TOL[torch.bfloat16], f"{label}: step-0 loss {k['losses'][0]} vs the plain routes' "
                                                    f"{p['losses'][0]}")
        require(max(gaps[1:]) <= SC_LOSS_TOL, f"{label}: losses after the updates {k['losses'][1:]} vs the plain "
                                              f"routes' {p['losses'][1:]}")
        grad_gap, grad_at = worst_param_gap(k["first"], p["first"])
        l2_all = l2_gap(k["first"], p["first"])
        near_p = {n: g for n, g in p["first"].items() if n.startswith(near)}
        l2_near = l2_gap(k["first"], near_p)
        require(l2_all <= SC_GRAD_L2 and l2_near <= SC_GRAD_L2,
                f"{label}: first-step gradients ||a - b|| / ||b|| {l2_all:.3e} over all parameters, {l2_near:.3e} "
                f"over the stem's and the kernel blocks' ({len(near_p)} tensors), past {SC_GRAD_L2}")
        for route, r in runs.items():
            after = r["ms"][1:]
            print(f"{label} {route} routes: ms a step on the card's clock {r['ms']} (after the first: least "
                  f"{min(after):.2f}, most {max(after):.2f}), {128e3 / np.mean(after):.1f} img/s; one more step "
                  f"{ {n: round(v, 2) for n, v in r['phases_ms'].items()} } (backward "
                  f"{100 * r['phases_ms']['backward'] / sum(r['phases_ms'].values()):.1f}%), the recomputed backward "
                  f"of the kernels {r['recompute_ms']:.2f} ms in {r['recompute_calls']} calls "
                  f"({100 * r['recompute_ms'] / sum(r['phases_ms'].values()):.1f}% of the step); profiled wall "
                  f"{r['wall_ms']:.2f} ms, busy {r['busy_ms']:.2f} ms ({100 * r['busy_ms'] / r['wall_ms']:.1f}%); "
                  f"peak {r['peak_gib']:.2f} GiB; losses {r['losses']}; top kernels (name, ms, launches) {r['top']} "
                  f"({card})")
        print(f"{label}: losses kernel vs plain routes {[f'{g:.3e}' for g in gaps]} of (1 + |plain|) (rules "
              f"{VIT_TOL[torch.bfloat16]}, then {SC_LOSS_TOL}); first-step gradients, worst parameter max|a - b| / "
              f"max|b| {grad_gap:.3e} ({grad_at}), ||a - b|| / ||b|| over all {l2_all:.3e}, over the stem's and the "
              f"kernel blocks' {l2_near:.3e} (rule {SC_GRAD_L2})")
        return {route: {key: v for key, v in r.items() if key != "first"} for route, r in runs.items()}

    def swin_routes(model):
        return model.routes(128, 224, 224, train=True)

    swin_state = models.get_model("swin_t", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).state_dict()
    plain_swin = dict(attention="plain", mlp="plain")
    sc_summary = {SWIN_TRAIN: sc_path(SWIN_TRAIN, "swin_t", swin_state, {}, plain_swin,
                                      [("block", "block")] + [("plain", "plain")] * 11, swin_routes,
                                      {"window_attention_block": 3, "mlp_block": 3})}
    require(launches_at("window_attention_block", (128 * 64, 49, 96), torch.bfloat16).get(SWIN_TRAIN) == 3
            and launches_at("mlp_block", (128 * 56 * 56, 96), torch.bfloat16).get(SWIN_TRAIN) == 3,
            f"{SWIN_TRAIN}: block 0's kernels did not take its first stage's shapes")
    sc_summary[SWIN_TRAIN_SD0] = sc_path(SWIN_TRAIN_SD0, "swin_t", swin_state, dict(sd_prob=0.0),
                                         dict(plain_swin, sd_prob=0.0), [("block", "block")] * 12, swin_routes,
                                         {"window_attention_block": 36, "mlp_block": 36})
    del swin_state
    cn_state = models.get_model("convnext_tiny", dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0)).state_dict()
    for key in cn_state:  # at its initial 1e-6 the layer scale would hide the blocks' branches
        if key.endswith("layer_scale"):
            cn_state[key].fill_(0.25)
    sc_summary[CN_TRAIN] = sc_path(CN_TRAIN, "convnext_tiny", cn_state, dict(depthwise="kernel"),
                                   dict(mlp="plain", depthwise="stock"),
                                   [("block", "kernel")] + [("plain", "kernel")] * 17,
                                   lambda model: model.routes(train=True),
                                   {"cn_mlp_block": 3, "depthwise_conv2d": 108})  # 18 a forward, 18 dx a backward
    del cn_state, sc_images, sc_labels
    torch.cuda.empty_cache()


    # ------------------------------------ each kernel against its plain twin
    rows = []

    def row(name, replaces, launches, err, ms, plain_ms, nbytes, nops, library_ms=None, source=STENCIL,
            ops_per_s=F32_OPS_PER_S, at=None, **extra):
        """One kernel at one shape.  ``launches`` is a count read after a main path, or the name of a main
        path: then the row takes the count that path left under the input ``at`` = (shape, dtype), 0 if it ran
        no such input, and lists every path's count at that input beside it."""
        b_ms, b_by = bound(nbytes, nops, ops_per_s)
        if at is not None:
            extra["launches_by_path"] = launches_at(name, *at)
            launches = extra["launches_by_path"].get(launches, 0)
        r = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, **extra}
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        print(f"{name}{' ' + str(extra['shape']) if 'shape' in extra else ''}: kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {lib}, max_abs_err {err}, "
              f"main-path launches {extra.get('launches_by_path', launches)}")
        return r

    def entry(main, path, others, **extra):
        """One kernel's entry in the kernels' line: its row ``main``, ``launches`` the wrapper's whole count on
        the main path ``path``, every path's count beside it, and its rows at other shapes."""
        by_path = launches_of(main["name"])
        if "launches_by_path" in main:  # the row's own counts, at its shape
            extra["launches_at_shape"] = main["launches_by_path"]
        return dict(main, launches=by_path.get(path, 0), launches_on=path, launches_by_path=by_path,
                    other_shapes=others, **extra)

    def launch_split(fn, chain, calls=3, tries=5, keep=None):
        """[(kernel, device ms)] of each of the ``chain`` launches of one call of ``fn``, in launch order: the
        profiler's kernel intervals over ``calls`` calls, averaged by position in the chain.  One more call leads
        the window, since the profiler may miss the first kernels after it starts; the last ``calls`` chains are
        read, and each position must hold one kernel in every call.  A window may also see no kernel at all:
        up to ``tries`` windows are profiled, then None (not measured).  ``keep(name)``, where given, picks the
        chain's kernels out of others that a call launches (the stock operators of a wrapper's set-up)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(1 + calls):
                    fn()
                torch.cuda.synchronize()
            spans = sorted((e.time_range.start, e.time_range.end, e.name[:e.name.rfind("(")].replace("void ", ""))
                           for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
            spans = [sp for sp in spans if keep is None or keep(sp[2])]
            if len(spans) >= calls * chain:
                break
        else:
            print(f"  the profiler saw {len(spans)} kernels in {1 + calls} calls of {chain}, {tries} times: "
                  f"launches apart not measured")
            return None
        spans = spans[-calls * chain:]
        require(all(spans[c * chain + i][2] == spans[i][2] for c in range(calls) for i in range(chain)),
                f"the profiler's kernels do not repeat by call: {[sp[2] for sp in spans]}")
        return [(spans[i][2], sum(spans[c * chain + i][1] - spans[c * chain + i][0] for c in range(calls)) / calls / 1e3)
                for i in range(chain)]

    def split_is_x3(split, products):
        """Whether a float32 block's launches (``launch_split``'s) hold ``products`` split-TF32 products and no scalar
        ln_gemm_kernel (deleted: its name must not come back)."""
        names = [name for name, _ in split]
        return sum("x3_gemm_kernel" in name for name in names) == products and not any("ln_gemm" in n for n in names)

    marker = []  # the name the profiler gives torch.cuda._sleep's kernel, read once

    def calls_on_device(fn, calls=5, tries=5):
        """[[(kernel, device ms)] of each call] of ``calls`` calls of ``fn``, every kernel and copy each launches,
        from the profiler: a call is what runs on the card between two marker kernels (``torch.cuda._sleep``)
        launched before and after it, so the count of a call's kernels is read, not assumed.  One call leads,
        since the profiler may miss the first kernels of a window; every call must launch the same kernels in
        the same order.  None if no window of ``tries`` saw them all."""
        from torch.profiler import ProfilerActivity, profile

        def device_spans(prof):
            return sorted((e.time_range.start, e.time_range.end, e.name[:e.name.rfind("(")].replace("void ", ""))
                          for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)

        for _ in range(tries if not marker else 0):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            names = {sp[2] for sp in device_spans(prof)}
            require(len(names) <= 1, f"torch.cuda._sleep's window holds other kernels too: {names}")
            marker.extend(names)
            if marker:
                break
        require(bool(marker), "the profiler saw no kernel of torch.cuda._sleep")
        fn()
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1000)
                for _ in range(1 + calls):
                    fn()
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            segments, current = [], None
            for sp in device_spans(prof):
                if sp[2] == marker[0]:
                    if current is not None:
                        segments.append(current)
                    current = []
                elif current is not None:
                    current.append((sp[2], (sp[1] - sp[0]) / 1e3))
            if len(segments) >= calls:
                break
        else:
            print(f"  the profiler saw {len(segments)} whole calls of {calls}, {tries} times: not measured")
            return None
        segments = segments[-calls:]
        require(all([k for k, _ in seg] == [k for k, _ in segments[0]] for seg in segments),
                f"the calls launch different kernels: {[[k for k, _ in seg] for seg in segments]}")
        return segments

    def mlp_split_bytes(tokens, d, dh, size, post_norm=False):
        """Bytes the MLP blocks pass through device memory between their launches, each written once and read
        once: the LN rows (not with post_norm), the (tokens, Dh) activations, post_norm's float32 branch; in the
        weights' dtype (bf16 or f32)."""
        return 2 * tokens * (dh * size + (d * 4 if post_norm else d * size))

    held = []  # checks of kernel against twin that are not timed: what was held, the error, the main paths' counts there

    def hold(name, shape, dtype, err, **options):
        held.append({"name": name, "shape": list(shape), "dtype": str(dtype).replace("torch.", ""), **options,
                     "max_abs_err": err, "launches_by_path": launches_at(name, shape, dtype)})
        print(f"{name} {list(shape)} {dtype} {options}: max_abs_err {err}, main-path launches {held[-1]['launches_by_path']}")

    px = b * h * w
    k = 5
    t14, t15, t10 = (stencil.gaussian_taps(k, s) for s in (1.4, 1.5, 1.0))
    blur_ops = 2 * (2 * k - 1)  # separable: k mul + (k-1) add per axis
    sobel_ops = 18 + 4          # gx, gy (4 mul + 5 add each), mag (2 mul, add, sqrt)
    cls = kernels.canny_stage1(maps, 0.1, 0.2)
    err = exact(cls, stencil.canny_stage1_plain(maps, t14, 0.1, 0.2), "canny_stage1")
    rows.append(row("canny_stage1", f"{PALLAS}:446", canny_counts["canny_stage1"], err,
                    time_ms(lambda: kernels.canny_stage1(maps, 0.1, 0.2), 50),
                    time_ms(lambda: stencil.canny_stage1_plain(maps, t14, 0.1, 0.2), 5),
                    px * (4 + 1), px * (blur_ops + sobel_ops + 15), kernel="canny_strip_kernel<5>"))
    cls_noise = kernels.canny_stage1(noise8, 0.3, 0.6)
    exact(cls_noise, stencil.canny_stage1_plain(noise8, t14, 0.3, 0.6), "canny_stage1 on noise")

    # the in-tile rounds depend on the data and add integer work only: bytes bound it either way
    err = exact(cls_tile, stencil.canny_stage1_plain(maps, t14, 0.1, 0.2, in_tile=stencil.IN_TILE),
                "canny_stage1 with in-tile hysteresis")
    rows.append(row("canny_stage1_in_tile", f"{PALLAS}:499", tile_counts["canny_stage1_in_tile"], err,
                    time_ms(lambda: kernels.canny_stage1(maps, 0.1, 0.2, in_tile_hysteresis=True), 50),
                    time_ms(lambda: stencil.canny_stage1_plain(maps, t14, 0.1, 0.2, in_tile=stencil.IN_TILE), 3),
                    px * (4 + 1), px * (blur_ops + sobel_ops + 15 + 8),
                    global_passes_with_without=tile_passes))
    exact(kernels.canny_stage1(noise8, 0.3, 0.6, in_tile_hysteresis=True),
          stencil.canny_stage1_plain(noise8, t14, 0.3, 0.6, in_tile=stencil.IN_TILE), "in-tile hysteresis on noise")
    del cls_tile, noise8

    # the sweeps and both device flags (any pixel changed; the last sweep changed one) on the scene's and noise's
    # class maps, against the twin's maps and flags; the fixpoint against the op-by-op hysteresis
    sweeps, err = stencil.SWEEPS_PER_PASS, 0.0
    buf = torch.empty_like(cls)
    for what, cmap in (("scene", cls), ("noise", cls_noise)):
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
        swept = kernels.hysteresis_sweeps(cmap, sweeps, changed=flags[:1], last_changed=flags[1:])
        before, twin = stencil._sweeps_plain(cmap, sweeps)
        err = max(err, exact(swept, twin, f"hysteresis_sweeps x{sweeps} on {what}"))
        twin_flags = [int(bool((twin != cmap).any())), int(bool((twin != before).any()))]
        require(flags.tolist() == twin_flags, f"hysteresis flags on {what}: {flags.tolist()}, twin {twin_flags}")
        exact(kernels.hysteresis_fixpoint(cmap) == 2, ops.hysteresis(cmap == 2, cmap >= 1), f"hysteresis fixpoint, {what}")
    del cls_noise, before, twin
    rows.append(row("hysteresis_sweeps", f"{PALLAS}:404", canny_counts["hysteresis_sweeps"], err,
                    time_ms(lambda: kernels.hysteresis_sweeps(cls, sweeps, out=buf), 50),
                    time_ms(lambda: stencil.hysteresis_sweeps_plain(cls, sweeps), 5),
                    px * 2, px * sweeps * 8, kernel=f"hysteresis_bits_kernel<{sweeps}>",
                    sweeps=sweeps, host_flag_reads=canny_reads))

    # blur + Sobel (row 4) bit for bit against the twin at 512x512, at 1080p b8 and there at K 3, 7 and 9 (four, four
    # and two columns a lane); library_ms is the op-by-op path's composite of stock calls, ops.sobel(ops.gaussian_blur)
    m512 = x512[None]  # (N, H, W) for the twin; the wrapper takes the HW image
    err = exact(kernels.fused_blur_sobel(x512), stencil.fused_blur_sobel_plain(m512, t15)[0], "blur_sobel 512")
    err = max(err, exact(kernels.fused_blur_sobel(x)[..., 0], stencil.fused_blur_sobel_plain(maps, t15),
                         "blur_sobel 1080p b8"))
    for ks in (3, 7, 9):
        err = max(err, exact(kernels.fused_blur_sobel(x, ks, 1.5)[..., 0],
                             stencil.fused_blur_sobel_plain(maps, stencil.gaussian_taps(ks, 1.5)),
                             f"blur_sobel 1080p b8 K {ks}"))
    b_ms, b_by = bound(px * 8, px * (blur_ops + sobel_ops))
    at_1080p = dict(shape=list(maps.shape), ms=time_ms(lambda: kernels.fused_blur_sobel(x), 50),
                    plain_ms=time_ms(lambda: stencil.fused_blur_sobel_plain(maps, t15), 5), bound_ms=b_ms,
                    bound_by=b_by, library_ms=time_ms(lambda: ops.sobel(ops.gaussian_blur(x, 5, 1.5)), 10),
                    library_composite=True, max_abs_err=err)
    print(f"fused_blur_sobel at 1080p b8: kernel_ms {at_1080p['ms']:.4f} plain_ms {at_1080p['plain_ms']:.4f} "
          f"bound_ms {b_ms:.4f} ({b_by}) library_ms {at_1080p['library_ms']:.4f} (composite), max_abs_err {err}")
    rows.append(row("fused_blur_sobel", f"{PALLAS}:377", bs_counts["fused_blur_sobel"], err,
                    time_ms(lambda: kernels.fused_blur_sobel(x512), 200),
                    time_ms(lambda: stencil.fused_blur_sobel_plain(m512, t15), 20),
                    512 * 512 * 8, 512 * 512 * (blur_ops + sobel_ops),
                    library_ms=time_ms(lambda: ops.sobel(ops.gaussian_blur(x512, 5, 1.5)), 50), library_composite=True,
                    kernel="blur_sobel_strip_kernel<5>", shape=[512, 512], at_1080p_b8=at_1080p))

    m32 = torch.from_numpy(imgs32[..., 0]).to(dev)
    hp = hb * h * w
    err = exact(kernels.harris_response_fused(m32[..., None]), stencil.harris_response_fused_plain(m32, t10, 0.04)[..., None],
                "harris")
    # library_ms of Harris is a composite of stock calls (ops.harris_response: reflect pad, conv2d Sobel,
    # products, separable conv2d window), not one kernel
    rows.append(row("harris_response_fused", f"{PALLAS}:591", hr_counts["harris_response_fused"], err,
                    time_ms(lambda: kernels.harris_response_fused(m32[..., None]), 20),
                    time_ms(lambda: stencil.harris_response_fused_plain(m32, t10, 0.04), 3),
                    hp * 8, hp * (sobel_ops - 4 + 3 + 3 * blur_ops + 7),
                    library_ms=time_ms(lambda: ops.harris_response(m32[..., None]), 3), library_composite=True,
                    shape=list(m32.shape)))

    del m32

    # library_ms of the blur and of the conv stage are composites of stock calls
    # (shifted-slice sums; conv2d + relu + max_pool2d in full f32), not one kernel.  The blur reads NHWC frames of
    # 1, 3 or 4 channels as they lie: one launch a call, no copy, held to the twin bit for bit; launch_ms is the
    # call's launches apart on the device clock
    def blur_at(img, what):
        m, restore = stencil._as_nhw(img)  # (N*C, H, W) maps for the twin
        out = kernels.fused_gaussian_blur(img)
        require(out.is_contiguous() and out.shape == img.shape, f"{what}: the blur's output is not contiguous NHWC")
        err = exact(out, restore(stencil.fused_gaussian_blur_plain(m, t15)), what)
        del out
        split = launch_split(lambda: kernels.fused_gaussian_blur(img), 1)
        print(f"  fused_gaussian_blur {list(img.shape)}'s launches apart (device ms): {split}")
        return row("fused_gaussian_blur", f"{PALLAS}:357", "pyramid/resize/rotate/blur 64x480x640x3", err,
                   time_ms(lambda: kernels.fused_gaussian_blur(img), 20),
                   time_ms(lambda: stencil.fused_gaussian_blur_plain(m, t15), 3),
                   img.numel() * 8, img.numel() * blur_ops,
                   library_ms=time_ms(lambda: ops.gaussian_blur(img, 5, 1.5), 3), at=(img.shape, img.dtype),
                   shape=list(img.shape), kernel=f"blur_strip_kernel<5, {img.shape[-1]}>", launch_ms=split)

    rows.append(entry(blur_at(x3, "gaussian_blur 64x480x640x3"), "pyramid/resize/rotate/blur 64x480x640x3",
                      [blur_at(x, "gaussian_blur 1080p b8")]))
    del x3
    x4 = torch.from_numpy(rng.random((8, 480, 640, 4), dtype=np.float32)).to(dev)
    m4, restore4 = stencil._as_nhw(x4)
    hold("fused_gaussian_blur", x4.shape, x4.dtype, exact(kernels.fused_gaussian_blur(x4), restore4(
        stencil.fused_gaussian_blur_plain(m4, t15)), "gaussian_blur 8x480x640x4"), channels=4)
    del x4, m4

    # row 7 is an implicit GEMM on split TF32 (four tf32 products a product): its bound takes the products at
    # TF32X3_OPS_PER_S, as the split-TF32 products', and fma_floor_ms is the same work on the FMA units
    # (F32_OPS_PER_S); f64_err against the stage in float64 on the batch's first 16 images, beside the twin's (TF32
    # off), held to twice it
    def stage_f64(x, wgt, bias):
        y = F.conv2d(x.double().permute(0, 3, 1, 2), wgt.double().permute(3, 2, 0, 1), bias.double(), padding=1)
        return F.max_pool2d(torch.relu(y), 2).permute(0, 2, 3, 1)

    def f64_err(out, ref64):
        return float((out.double() - ref64).abs().max() / ref64.abs().max())

    conv_rows = []
    for hw in (28, 224):
        params, xc, path = cnn[hw]
        for i in (0, 1):
            wgt, bias = params[f"conv{i}"]["w"], params[f"conv{i}"]["b"]
            out = kernels.fused_conv3x3_relu_pool(xc, wgt, bias)
            twin = conv_block.fused_conv3x3_relu_pool_plain(xc, wgt, bias)
            err = max_err_f32(out, twin, f"conv{i} at {hw}", CONV_ATOL, CONV_RTOL)
            max_err_f32(out, kernels.conv3x3_relu_pool(xc, wgt, bias, "stock"), f"conv{i} at {hw} vs stock",
                        CONV_ATOL, CONV_RTOL)
            ref64 = stage_f64(xc[:16], wgt, bias)
            errs64 = (f64_err(out[:16], ref64), f64_err(twin[:16], ref64))
            require(errs64[0] <= 2 * errs64[1], f"conv{i} at {hw}: float64 error {errs64[0]:.3e} past twice the "
                                                f"twin's {errs64[1]:.3e}")
            del twin, ref64
            conv_px = xc.shape[0] * xc.shape[1] * xc.shape[2]
            nops = conv_px * 2 * 9 * wgt.shape[2] * wgt.shape[3] + 3 * out.numel()
            conv_rows.append(row(
                "fused_conv3x3_relu_pool", f"{PALLAS_CONV}:36", path, err,
                time_ms(lambda: kernels.fused_conv3x3_relu_pool(xc, wgt, bias), 10),
                time_ms(lambda: conv_block.fused_conv3x3_relu_pool_plain(xc, wgt, bias), 3),
                4 * (xc.numel() + wgt.numel() + bias.numel() + out.numel()), nops,
                library_ms=time_ms(lambda: kernels.conv3x3_relu_pool(xc, wgt, bias, "stock"), 10),
                ops_per_s=TF32X3_OPS_PER_S, fma_floor_ms=nops / F32_OPS_PER_S * 1e3, f64_err=errs64[0],
                twin_f64_err=errs64[1], source=CONV_BLOCK, at=(xc.shape, xc.dtype),
                shape=[list(xc.shape), wgt.shape[3]]))
            xc = out
    # one entry for the kernel: its heaviest main-path shape, the other three beside it
    rows.append(entry(conv_rows[-1], cnn[224][2], conv_rows[:-1]))


    # the transformer kernels at ViT-B/16's shapes; library_ms of the two blocks
    # are composites of stock calls (layer_norm, linear, gelu, SDPA), not one kernel
    gen = torch.Generator(device=dev).manual_seed(0)
    d_model, heads, d_hidden, seq = 768, 12, 3072, 197
    hd = d_model // heads
    rate = {torch.float32: F32_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S}
    # the products of the MLP blocks and of wgrad_matmul: float32 by split TF32
    x3_rate = {torch.float32: TF32X3_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S}

    def f64_err(out, ref64):
        """max |out - ref64| / max |ref64|, in float64: a product's distance to the same function in float64."""
        return float((out.double() - ref64).abs().max() / ref64.abs().max())

    # the cases held for the training paths draw from a generator of their own, so that every other case's checked
    # inputs stay as they were before those cases were added.  Drawn from the checks' generator, they moved the first
    # float32 case of the f32 Swin-T path onto a draw past its float64 rule: fault 2, replayed and printed there
    draw_gens, train_draws = [gen], torch.Generator(device=dev).manual_seed(21)

    @contextlib.contextmanager
    def drawing_from(g):
        draw_gens.append(g)
        try:
            yield
        finally:
            draw_gens.pop()

    def normal(shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=draw_gens[-1], device=dev) * std + mean).to(dtype)

    def hold_joined(args, what):
        """attention_block_int8's joined heads against the twin's by JOINED_FLIPS' rule: the block's output is x plus
        a small projection of them, where a wrong head or scale column could hide.  (most steps apart, share apart)"""
        steps = (int8_transformer.attention_block_int8_joined(*args).int()
                 - int8_transformer.attention_block_int8_joined_plain(*args).int()).abs()
        most, share = int(steps.max()), float((steps > 0).float().mean())
        require(most <= 1 and int((steps > 0).sum()) <= 1 + JOINED_FLIPS[args[0].dtype] * steps.numel(),
                f"{what}: joined heads up to {most} int8 steps from the twin's, {share:.3e} of them apart")
        return most, share

    def attention_ops(n):  # QK^T and PV, plus scale, max, exp, sum and divide per score
        return n * heads * seq * seq * (4 * hd + 5)

    def core_fields(split, nbytes, nops, ops_per_s, library_ms):
        """The attention core's own launch in a block's chain of launches: its device ms (``split``'s entry of the
        core, None where the profiler saw no kernel), its bound (its own inputs and output once, its operations at
        ``ops_per_s``) and ``library_ms``, one PyTorch call of the same function (SDPA)."""
        core = None if split is None else next(ms for name, ms in split
                                               if "core_kernel" in name or "_tc_kernel" in name or "_x3_kernel" in name)
        b_ms, b_by = bound(nbytes, nops, ops_per_s)
        return dict(core_ms=core, core_bound_ms=b_ms, core_bound_by=b_by, core_library_ms=library_ms)

    def sdpa_ms(n, s, n_heads, head_dim, dtype, scale, mask=None, generator=None):
        """ms of F.scaled_dot_product_attention on q, k and v read as strided views of an (n, s, 3 n_heads head_dim)
        QKV buffer of ``dtype``, as the cores read them (the yardstick, never on a path); the buffer drawn from
        ``generator`` where one is given, else from the checks' own."""
        if generator is None:
            buf = normal((n, s, 3 * n_heads * head_dim), dtype)
        else:
            buf = torch.randn((n, s, 3 * n_heads * head_dim), generator=generator, device=dev).to(dtype)
        qs, ks, vs = (a.reshape(n, s, n_heads, head_dim).permute(0, 2, 1, 3)
                      for a in buf.split(n_heads * head_dim, dim=-1))
        return time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=scale), 10)

    # flash_mha: float32 at ViT-B/16 b64 (the f32 path's shape), and bf16 at b256 (the tensor-core core of the bf16
    # blocks alone; no main path runs flash_mha in bf16).  At head dim 64 float32 runs split TF32 (three tf32
    # products a product: its bound at TF32X3_OPS_PER_S), held to float64: f64_err = max |out - f64| / max |f64| no
    # more than twice scalar_f64_err, the scalar float32 core's that it replaced (_flash_mha_scalar, timed beside it)
    scale = hd ** -0.5
    flash_rows = []
    core_rate = {torch.float32: TF32X3_OPS_PER_S, torch.bfloat16: BF16_OPS_PER_S}
    for dtype, batch in ((torch.float32, 64), (torch.bfloat16, 256)):
        q, k, v = (normal((batch, seq, heads, hd), dtype) for _ in range(3))
        out = kernels.flash_mha(q, k, v, scale)
        err = max_err_f32(out, flash_attention.flash_mha_plain(q, k, v, scale), f"flash_mha {dtype}", TOL[dtype],
                          TOL[dtype])
        require(torch.equal(kernels.flash_mha(q, k, v, scale), out), f"flash_mha {dtype}: two calls differ")
        qh, kh, vh = (a.permute(0, 2, 1, 3) for a in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        figures = {}
        if dtype == torch.float32:
            max_err_f32(out, sdpa, "flash_mha vs SDPA", 1e-3, 1e-3)
            ref64 = torch.einsum("nhqk,nkhd->nhqd", torch.softmax(
                torch.einsum("nqhd,nkhd->nhqk", q.double(), k.double()) * scale, dim=-1), v.double())
            scalar = flash_attention._flash_mha_scalar(q, k, v, scale)
            figures = dict(f64_err=f64_err(out, ref64), scalar_f64_err=f64_err(scalar, ref64),
                           library_f64_err=f64_err(sdpa, ref64),
                           scalar_core_ms=time_ms(lambda: flash_attention._flash_mha_scalar(q, k, v, scale), 20),
                           hgmma_tf32_in_sass=sum(x3_core_hgmma.values()),
                           occupancy=flash_attention.kernel_info("attention_x3_kernel<64>"))
            print(f"  flash_mha f32, max|a - f64| / max|f64|: split-TF32 core {figures['f64_err']:.3e}, scalar core "
                  f"{figures['scalar_f64_err']:.3e}, SDPA {figures['library_f64_err']:.3e}; scalar core "
                  f"{figures['scalar_core_ms']:.4f} ms")
            require(figures["f64_err"] <= 2 * figures["scalar_f64_err"],
                    "flash_mha f32 strays from float64 past twice the scalar core")
            del ref64, scalar
        else:
            max_err_f32(out, sdpa, "flash_mha bf16 vs SDPA", 5e-2, 5e-2)
            print(f"flash_mha bf16 vs SDPA: max |err| {float((out.float() - sdpa.float()).abs().max()):.3e}")
        flash_rows.append(row("flash_mha", f"{PALLAS_FLASH}:56", "vit_b_16 f32 b64", err,
                              time_ms(lambda: kernels.flash_mha(q, k, v, scale), 20),
                              time_ms(lambda: flash_attention.flash_mha_plain(q, k, v, scale), 5),
                              4 * q.numel() * q.element_size(), attention_ops(batch),
                              library_ms=time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 20),
                              source=ATTENTION, ops_per_s=core_rate[dtype], at=(q.shape, dtype), shape=list(q.shape),
                              dtype=str(dtype).replace("torch.", ""), **figures))
        del q, k, v, qh, kh, vh, out, sdpa
    # Every head dim of the cores runs on the tensor cores (bf16 wgmma; float32 split TF32), head dim 80
    # being ViT-H/14's.  Its two paths' shapes as rows (their launches from the vit_h_14 paths), the float32 one held
    # to float64 no further than twice the scalar yardstick at head dim 80; then, drawn from a generator of their own,
    # the cores at head dims 16, 64 and 80 in bf16, float32 and into int8 (attention_block_int8, both dtypes): S 257
    # and S 65-128 (every tail of a 64-key tile, so every tail of the float32 core's 32-key tiles too), each within
    # its twin's rule and the same bits twice, and the float32 cores no further from float64 than twice the scalar
    # yardstick at their head dim (at (4, 257, 4, hd))
    core_draws = torch.Generator(device=dev).manual_seed(22)
    with drawing_from(core_draws):
        for c_dtype, c_n in ((torch.bfloat16, 64), (torch.float32, 16)):
            c_path = f"vit_h_14 {'bf16' if c_dtype == torch.bfloat16 else 'f32'} b{c_n}"
            cq, ck, cv = (normal((c_n, 257, 16, 80), c_dtype) for _ in range(3))
            c_scale = 80 ** -0.5
            c_out = kernels.flash_mha(cq, ck, cv, c_scale)
            c_err = max_err_f32(c_out, flash_attention.flash_mha_plain(cq, ck, cv, c_scale), f"flash_mha {c_path}", TOL[c_dtype],
                              TOL[c_dtype])
            require(torch.equal(kernels.flash_mha(cq, ck, cv, c_scale), c_out), f"flash_mha {c_path}: two calls differ")
            cqh, ckh, cvh = (a.permute(0, 2, 1, 3) for a in (cq, ck, cv))
            c_fig = {}
            if c_dtype == torch.float32:
                c_ref64 = torch.einsum("nhqk,nkhd->nhqd", torch.softmax(
                    torch.einsum("nqhd,nkhd->nhqk", cq.double(), ck.double()) * c_scale, dim=-1), cv.double())
                c_scalar = flash_attention._flash_mha_scalar(cq, ck, cv, c_scale)
                c_fig = dict(f64_err=f64_err(c_out, c_ref64), scalar_f64_err=f64_err(c_scalar, c_ref64),
                               scalar_core_ms=time_ms(lambda: flash_attention._flash_mha_scalar(cq, ck, cv, c_scale), 20),
                               occupancy=flash_attention.kernel_info("attention_x3_kernel<80>"))
                print(f"  flash_mha {c_path}, max|a - f64| / max|f64|: split-TF32 core {c_fig['f64_err']:.3e}, scalar "
                      f"core {c_fig['scalar_f64_err']:.3e}; scalar core {c_fig['scalar_core_ms']:.4f} ms")
                require(c_fig["f64_err"] <= 2 * c_fig["scalar_f64_err"],
                        f"flash_mha {c_path} strays from float64 past twice the scalar core")
                del c_ref64, c_scalar
            else:
                c_fig = dict(occupancy=flash_attention.kernel_info("attention_tc_kernel<80>"))
            flash_rows.append(row("flash_mha", f"{PALLAS_FLASH}:56", c_path, c_err,
                                  time_ms(lambda: kernels.flash_mha(cq, ck, cv, c_scale), 20),
                                  time_ms(lambda: flash_attention.flash_mha_plain(cq, ck, cv, c_scale), 5),
                                  4 * cq.numel() * cq.element_size(), c_n * 16 * 257 * 257 * (4 * 80 + 5),
                                  library_ms=time_ms(lambda: F.scaled_dot_product_attention(cqh, ckh, cvh, scale=c_scale),
                                                     20),
                                  source=ATTENTION, ops_per_s=core_rate[c_dtype], at=(cq.shape, c_dtype),
                                  shape=list(cq.shape), dtype=str(c_dtype).replace("torch.", ""), **c_fig))
            del cq, ck, cv, cqh, ckh, cvh, c_out
        held_cores, core_f64, joined_share = 0, {}, {}
        for c_hd in (16, 64, 80):
            for c_dtype in (torch.bfloat16, torch.float32):
                for c_s in (257, *range(65, 129)):
                    cq, ck, cv = (normal((1, c_s, 2, c_hd), c_dtype) for _ in range(3))
                    c_out = kernels.flash_mha(cq, ck, cv, c_hd ** -0.5)
                    max_err_f32(c_out, flash_attention.flash_mha_plain(cq, ck, cv, c_hd ** -0.5),
                                f"flash_mha (1, {c_s}, 2, {c_hd}) {c_dtype}", TOL[c_dtype], TOL[c_dtype])
                    require(torch.equal(kernels.flash_mha(cq, ck, cv, c_hd ** -0.5), c_out),
                            f"flash_mha (1, {c_s}, 2, {c_hd}) {c_dtype}: two calls differ")
                    held_cores += 1
                if c_dtype == torch.float32:
                    cq, ck, cv = (normal((4, 257, 4, c_hd), c_dtype) for _ in range(3))
                    c_ref64 = torch.einsum("nhqk,nkhd->nhqd", torch.softmax(
                        torch.einsum("nqhd,nkhd->nhqk", cq.double(), ck.double()) * c_hd ** -0.5, dim=-1), cv.double())
                    core_f64[c_hd] = (f64_err(kernels.flash_mha(cq, ck, cv, c_hd ** -0.5), c_ref64),
                                    f64_err(flash_attention._flash_mha_scalar(cq, ck, cv, c_hd ** -0.5), c_ref64))
                    require(core_f64[c_hd][0] <= 2 * core_f64[c_hd][1],
                            f"flash_mha f32 at head dim {c_hd} strays from float64 past twice the scalar core")
            for c_dtype in (torch.bfloat16, torch.float32):  # into int8: the int8 block, 2 heads
                c_d8 = 2 * c_hd
                for c_s in (257, 70):
                    c_a1, c_ao = normal((c_d8,), torch.float32, 0.005, 0.02), normal((c_d8,), torch.float32, 0.005, 0.02)
                    c_wqkv, c_sqkv = kernels.quantize_weight(normal((c_d8, 3 * c_d8), torch.float32, c_d8 ** -0.5) * c_a1[:, None])
                    c_wo, c_so = kernels.quantize_weight(normal((c_d8, c_d8), torch.float32, c_d8 ** -0.5) * c_ao[:, None])
                    c_args = (normal((2, c_s, c_d8), c_dtype), normal((c_d8,), torch.float32, 0.2, 1.0),
                               normal((c_d8,), torch.float32, 0.1), c_wqkv, c_sqkv, normal((3 * c_d8,), torch.float32, 0.1),
                               c_wo, c_so, normal((c_d8,), torch.float32, 0.1), c_a1, c_ao, 2, c_hd ** -0.5)
                    c_got = kernels.attention_block_int8(*c_args)
                    c_want = int8_transformer.attention_block_int8_plain(*c_args)
                    require(scaled_err(c_got, c_want) <= TOL[torch.bfloat16],
                            f"attention_block_int8 (2, {c_s}, {c_d8}) {c_dtype}: {scaled_err(c_got, c_want):.3e} from its twin")
                    require(torch.equal(kernels.attention_block_int8(*c_args), c_got),
                            f"attention_block_int8 (2, {c_s}, {c_d8}) {c_dtype}: two calls differ")
                    c_share = hold_joined(c_args, f"attention_block_int8 (2, {c_s}, {c_d8}) {c_dtype}")[1]
                    joined_share[c_dtype] = max(joined_share.get(c_dtype, 0.0), c_share)
                    held_cores += 1
        print(f"the attention cores at head dims 16, 64 and 80: {held_cores} cases held to their twins and the same "
              f"bits twice (bf16 and f32 at S 257 and 65-128, int8 out at S 257 and 70); float32 max|a - f64| / "
              f"max|f64| against the scalar yardstick's at (4, 257, 4, hd): "
              f"{ {c_hd: (f'{a:.3e}', f'{b:.3e}') for c_hd, (a, b) in core_f64.items()} }; int8 out, the most of "
              f"the joined heads a step from the twin's: bf16 {joined_share[torch.bfloat16]:.3e}, f32 "
              f"{joined_share[torch.float32]:.3e} (at most {JOINED_FLIPS[torch.bfloat16]}, "
              f"{JOINED_FLIPS[torch.float32]})")
    rows.append(entry(flash_rows[0], "vit_b_16 f32 b64", flash_rows[1:], core_hgmma_in_sass=core_hgmma["attention"],
                      head_dims_held=held_cores,
                      int8_joined_share={str(k).replace("torch.", ""): v for k, v in joined_share.items()}))

    def ln_params():
        return normal((d_model,), torch.float32, 0.2, 1.0), normal((d_model,), torch.float32, 0.1)

    dtype = torch.bfloat16
    x = normal((256, seq, d_model), dtype)
    ln_g, ln_b = ln_params()
    w_qkv, b_qkv = normal((d_model, 3 * d_model), dtype, d_model ** -0.5), normal((3 * d_model,), torch.float32, 0.1)
    w_o, b_o = normal((d_model, d_model), dtype, d_model ** -0.5), normal((d_model,), torch.float32, 0.1)
    args = (x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads, scale, 1e-6)
    out = kernels.attention_block(*args)
    err = max_err_f32(out, transformer_block.attention_block_plain(*args), "attention_block", TOL[dtype], TOL[dtype])

    def attention_library():
        h = F.layer_norm(x, (d_model,), ln_g.to(dtype), ln_b.to(dtype), 1e-6)
        a, b, c = (t.reshape(256, seq, heads, hd).permute(0, 2, 1, 3)
                   for t in F.linear(h, w_qkv.t(), b_qkv.to(dtype)).split(d_model, dim=-1))
        o = F.scaled_dot_product_attention(a, b, c, scale=scale).permute(0, 2, 1, 3).reshape(256, seq, d_model)
        return x + F.linear(o, w_o.t(), b_o.to(dtype))

    max_err_f32(out, attention_library(), "attention_block vs the stock composite", 5e-2, 5e-2)
    tokens = 256 * seq
    # the bound counts what the function needs: inputs and output once.  The (N*S, 3D) QKV product and the
    # (N*S, D) joined heads, written and read once each between the three launches of a call (the TPU kernel
    # keeps them on chip), are this split's own traffic: their time at the memory rate is split_bytes_ms
    block_bytes = 2 * x.numel() * 2 + (w_qkv.numel() + w_o.numel()) * 2 + 4 * (6 * d_model)
    split_bytes = 2 * 5 * x.numel() * 2  # the LN rows (D), the QKV product (3 D), the joined heads (D)
    split = launch_split(lambda: kernels.attention_block(*args), vit_block_kernel_launches // 12)
    print(f"  attention_block's launches apart (device ms): {split}")
    require(torch.equal(kernels.attention_block(*args), out), "attention_block bf16: two calls differ")
    # the core alone: q, k and v read once out of the (N*S, 3D) buffer, the joined heads written once
    core = core_fields(split, 4 * x.numel() * 2, attention_ops(256), BF16_OPS_PER_S,
                       sdpa_ms(256, seq, heads, hd, dtype, scale))
    attn_main = (row("attention_block", f"{PALLAS_BLOCK}:237", vit[dtype]["attention_block"], err,
                    time_ms(lambda: kernels.attention_block(*args), 5),
                    time_ms(lambda: transformer_block.attention_block_plain(*args), 3),
                    block_bytes, tokens * (8 * d_model * d_model + 8 * d_model) + attention_ops(256),
                    library_ms=time_ms(attention_library, 5), source=TRANSFORMER, ops_per_s=rate[dtype],
                    shape=list(x.shape), dtype="bfloat16", kernel_launches=vit_block_kernel_launches,
                    split_bytes_ms=split_bytes / HBM_BYTES_PER_S * 1e3, launch_ms=split,
                    hgmma_in_sass=hgmma["transformer_block"], core_hgmma_in_sass=core_hgmma["transformer_block"],
                    **core))
    print(f"  under attention_block's load: {clock_under(lambda: kernels.attention_block(*args), 40)}")
    args128 = (x[:128].contiguous(), *args[1:])  # the training path's batch
    hold("attention_block", args128[0].shape, dtype,
         max_err_f32(kernels.attention_block(*args128), transformer_block.attention_block_plain(*args128),
                     "attention_block b128", TOL[dtype], TOL[dtype]))
    del x, out, args, args128, w_qkv, w_o

    # attention_block in float32 at ViT-B/16 b64's shape: on no measured path (the f32 None route takes flash_mha),
    # timed beside its composite (TF32 off); four launches: LN rows, the QKV product and the output projection on
    # split TF32 (x3_gemm_kernel), the split-TF32 core between them; held to float64 as the f32 MLP: f64_err no more
    # than twice the twin's (TF32 off)
    x = normal((64, seq, d_model), torch.float32)
    ln_g, ln_b = ln_params()
    w_qkv = normal((d_model, 3 * d_model), torch.float32, d_model ** -0.5)
    b_qkv = normal((3 * d_model,), torch.float32, 0.1)
    w_o, b_o = normal((d_model, d_model), torch.float32, d_model ** -0.5), normal((d_model,), torch.float32, 0.1)
    args = (x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, heads, scale, 1e-6)
    chain = kernels.attention_block.kernel_launches
    out = kernels.attention_block(*args)
    chain = kernels.attention_block.kernel_launches - chain
    err = max_err_f32(out, transformer_block.attention_block_plain(*args), "attention_block f32", TOL[torch.float32],
                      TOL[torch.float32])

    def attention_library_f32():
        h = F.layer_norm(x, (d_model,), ln_g, ln_b, 1e-6)
        a, b, c = (t.reshape(64, seq, heads, hd).permute(0, 2, 1, 3)
                   for t in F.linear(h, w_qkv.t(), b_qkv).split(d_model, dim=-1))
        o = F.scaled_dot_product_attention(a, b, c, scale=scale).permute(0, 2, 1, 3).reshape(64, seq, d_model)
        return x + F.linear(o, w_o.t(), b_o)

    max_err_f32(out, attention_library_f32(), "attention_block f32 vs the stock composite", 1e-3, 1e-3)
    require(torch.equal(kernels.attention_block(*args), out), "attention_block f32: two calls differ")
    require(chain == 4, f"attention_block f32: {chain} kernel launches a call, not 4")
    split = launch_split(lambda: kernels.attention_block(*args), chain)
    print(f"  attention_block f32's launches apart (device ms): {split}")
    require(split is not None and split_is_x3(split, 2), f"attention_block f32's launches: {split}")
    ref64 = transformer_block._attention_block_f64(*args)
    figures = dict(f64_err=f64_err(out, ref64), twin_f64_err=f64_err(transformer_block.attention_block_plain(*args),
                                                                     ref64))
    del ref64
    print(f"  attention_block f32, max|a - f64| / max|f64|: kernel {figures['f64_err']:.3e}, twin (TF32 off) "
          f"{figures['twin_f64_err']:.3e}")
    require(figures["f64_err"] <= 2 * figures["twin_f64_err"], "attention_block f32 strays from float64 past twice the twin")
    core = core_fields(split, 4 * x.numel() * 4, attention_ops(64), TF32X3_OPS_PER_S,
                       sdpa_ms(64, seq, heads, hd, torch.float32, scale))
    # every operation at the split-TF32 rate: the products and the core are three tf32 products a product
    attn_f32 = row("attention_block", f"{PALLAS_BLOCK}:237", "vit_b_16 f32 b64", err,
                   time_ms(lambda: kernels.attention_block(*args), 5),
                   time_ms(lambda: transformer_block.attention_block_plain(*args), 3),
                   2 * x.numel() * 4 + (w_qkv.numel() + w_o.numel()) * 4 + 4 * (6 * d_model),
                   64 * seq * (8 * d_model * d_model + 8 * d_model) + attention_ops(64), ops_per_s=TF32X3_OPS_PER_S,
                   ops_by_rate={"tf32x3": {"products": 64 * seq * (8 * d_model * d_model + 8 * d_model),
                                           "core": attention_ops(64)}},
                   library_ms=time_ms(attention_library_f32, 5), source=TRANSFORMER, at=(x.shape, torch.float32),
                   shape=list(x.shape), dtype="float32", kernel_launches=chain,
                   split_bytes_ms=2 * 5 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3, launch_ms=split,
                   hgmma_tf32_in_sass=tf32_hgmma["transformer_block"], **figures, **core)
    rows.append(entry(attn_main, "vit_b_16 bf16 b256", [attn_f32]))
    del x, out, args, w_qkv, w_o

    mlp_rows = []
    for dtype, batch in ((torch.float32, 64), (torch.bfloat16, 256)):
        tokens = batch * seq
        x = normal((tokens, d_model), dtype)
        ln_g, ln_b = ln_params()
        w1, b1 = normal((d_model, d_hidden), dtype, d_model ** -0.5), normal((d_hidden,), torch.float32, 0.1)
        w2, b2 = normal((d_hidden, d_model), dtype, d_hidden ** -0.5), normal((d_model,), torch.float32, 0.1)
        args = (x, ln_g, ln_b, w1, b1, w2, b2, 1e-6)
        out = kernels.mlp_block(*args)
        err = max_err_f32(out, transformer_block.mlp_block_plain(*args), f"mlp_block {dtype}", TOL[dtype], TOL[dtype])

        def mlp_library():
            h = F.layer_norm(x, (d_model,), ln_g.to(dtype), ln_b.to(dtype), 1e-6)
            return x + F.linear(F.gelu(F.linear(h, w1.t(), b1.to(dtype))), w2.t(), b2.to(dtype))

        max_err_f32(out, mlp_library(), f"mlp_block {dtype} vs the stock composite",
                    5e-2 if dtype == torch.bfloat16 else 1e-3, 5e-2 if dtype == torch.bfloat16 else 1e-3)
        size = x.element_size()
        chain = vit_mlp_kernel_launches if dtype == torch.bfloat16 else vit_f32_mlp_kernel_launches
        products = hgmma if dtype == torch.bfloat16 else tf32_hgmma
        extra = dict(launch_ms=launch_split(lambda: kernels.mlp_block(*args), chain // 12), kernel_launches=chain,
                     hgmma_in_sass=products["transformer_block"])
        print(f"  mlp_block's launches apart (device ms): {extra['launch_ms']}")
        require(torch.equal(kernels.mlp_block(*args), out), f"mlp_block {dtype}: two calls differ")
        if dtype == torch.float32:  # the split-TF32 products against the block in float64 (the twins' LN and erf)
            h64 = transformer_block._ln_f32(x.double(), ln_g.double(), ln_b.double(), 1e-6)
            h64 = transformer_block._gelu_f32(h64 @ w1.double() + b1.double())
            ref64 = x.double() + h64 @ w2.double() + b2.double()
            del h64
            extra.update(f64_err=f64_err(out, ref64),
                         twin_f64_err=f64_err(transformer_block.mlp_block_plain(*args), ref64))
            del ref64
            print(f"  mlp_block f32, max|a - f64| / max|f64|: kernel {extra['f64_err']:.3e}, twin (TF32 off) "
                  f"{extra['twin_f64_err']:.3e}")
            require(extra["f64_err"] <= 2 * extra["twin_f64_err"], "mlp_block f32 strays from float64 past twice the twin")
        mlp_rows.append(row("mlp_block", f"{PALLAS_BLOCK}:125", f"vit_b_16 {'bf16' if dtype == torch.bfloat16 else 'f32'} b{batch}", err,
                            time_ms(lambda: kernels.mlp_block(*args), 5),
                            time_ms(lambda: transformer_block.mlp_block_plain(*args), 3),
                            2 * x.numel() * size + (w1.numel() + w2.numel()) * size + 4 * (4 * d_model + d_hidden),
                            tokens * (4 * d_model * d_hidden + 20 * d_hidden + 8 * d_model),
                            library_ms=time_ms(mlp_library, 5), source=TRANSFORMER, ops_per_s=x3_rate[dtype],
                            at=(x.shape, dtype), shape=list(x.shape), dtype=str(dtype).replace("torch.", ""),
                            split_bytes_ms=mlp_split_bytes(tokens, d_model, d_hidden, size) / HBM_BYTES_PER_S * 1e3,
                            **extra))
        print(f"  under mlp_block's load: {clock_under(lambda: kernels.mlp_block(*args), 20 if dtype == torch.bfloat16 else 100)}")
        if dtype == torch.bfloat16:  # the training path's batch, 128 images
            args128 = (x[:128 * seq].contiguous(), *args[1:])
            hold("mlp_block", args128[0].shape, dtype,
                 max_err_f32(kernels.mlp_block(*args128), transformer_block.mlp_block_plain(*args128), "mlp_block b128",
                             TOL[dtype], TOL[dtype]))
            del args128
        del x, out, args, w1, w2

    # mlp_block and cn_mlp_block at every shape the Swin, ConvNeXt and ViT-H/14 paths hand them, and their options
    def mlp_case(tokens, d, dtype, path=None, cn=False, post_norm=False, ln_count=0, eps=None, strict=False):
        """Kernel against twin on (tokens, d) in ``dtype``; timed, and a row returned, where ``path`` names the
        main path that runs this shape; else held only.  ``strict`` (mlp_block without options) also requires the
        same bits twice and, in float32, no further from float64 than twice the twin."""
        dh = 4 * (ln_count or d)
        x = normal((tokens, d), dtype)
        ln_g, ln_b = normal((d,), torch.float32, 0.2, 1.0), normal((d,), torch.float32, 0.1)
        w1, b1 = normal((d, dh), dtype, d ** -0.5), normal((dh,), torch.float32, 0.1)
        w2, b2 = normal((dh, d), dtype, dh ** -0.5), normal((d,), torch.float32, 0.1)
        if ln_count:  # a zero-padded channel layout: the real channels first
            for t in (x, ln_g, ln_b, b2):
                t[..., ln_count:] = 0
            w1[ln_count:] = 0
            w2[:, ln_count:] = 0
        eps = eps or (1e-6 if cn else 1e-5)
        if cn:
            res, gamma = normal((tokens, d), dtype), normal((d,), torch.float32, 0.5)
            args = (x, res, ln_g, ln_b, w1, b1, w2, b2, gamma, eps)
            fn, twin, name, line = kernels.cn_mlp_block, transformer_block.cn_mlp_block_plain, "cn_mlp_block", 391
        else:
            args = (x, ln_g, ln_b, w1, b1, w2, b2, eps, post_norm, ln_count)
            fn, twin, name, line = kernels.mlp_block, transformer_block.mlp_block_plain, "mlp_block", 125
        kernel_launches = fn.kernel_launches
        out = fn(*args)
        kernel_launches = fn.kernel_launches - kernel_launches  # of this one call, as counted
        what = f"{name} {tokens}x{d} {dtype} post_norm={post_norm} ln_count={ln_count}"
        err = max_err_f32(out, twin(*args), what, TOL[dtype], TOL[dtype])
        figures = {}
        if strict:
            require(torch.equal(fn(*args), out), f"{what}: two calls differ")
            if dtype == torch.float32:  # the split-TF32 products against the block in float64 (the twin's LN, erf)
                h64 = transformer_block._ln_f32(x.double(), ln_g.double(), ln_b.double(), eps)
                h64 = transformer_block._gelu_f32(h64 @ w1.double() + b1.double())
                ref64 = x.double() + h64 @ w2.double() + b2.double()
                del h64
                figures = dict(f64_err=f64_err(out, ref64), twin_f64_err=f64_err(twin(*args), ref64))
                del ref64
                print(f"  {what}, max|a - f64| / max|f64|: kernel {figures['f64_err']:.3e}, twin (TF32 off) "
                      f"{figures['twin_f64_err']:.3e}")
                require(figures["f64_err"] <= 2 * figures["twin_f64_err"],
                        f"{what}: strays from float64 past twice the twin")
        if path is None:
            hold(name, x.shape, dtype, err, post_norm=post_norm, ln_count=ln_count, kernel_launches=kernel_launches)
            return None

        def library():
            h = x if post_norm else F.layer_norm(x, (d,), ln_g.to(dtype), ln_b.to(dtype), eps)
            h = F.linear(F.gelu(F.linear(h, w1.t(), b1.to(dtype))), w2.t(), b2.to(dtype))
            if post_norm:
                h = F.layer_norm(h, (d,), ln_g.to(dtype), ln_b.to(dtype), eps)
            return res + h * gamma.to(dtype) if cn else x + h

        size = x.element_size()
        products = hgmma if dtype == torch.bfloat16 else tf32_hgmma
        extra = dict(launch_ms=launch_split(lambda: fn(*args), kernel_launches),
                     hgmma_in_sass=products["transformer_block"], **figures)
        return row(name, f"{PALLAS_BLOCK}:{line}", path, err, time_ms(lambda: fn(*args), 5),
                   time_ms(lambda: twin(*args), 3),
                   (3 if cn else 2) * x.numel() * size + (w1.numel() + w2.numel()) * size + 4 * (4 * d + dh),
                   tokens * (4 * d * dh + 20 * dh + 8 * d), library_ms=time_ms(library, 5), source=TRANSFORMER,
                   ops_per_s=x3_rate[dtype], at=(x.shape, dtype), shape=[tokens, d], dtype=str(dtype).replace("torch.", ""),
                   split_bytes_ms=mlp_split_bytes(tokens, d, dh, size, post_norm) / HBM_BYTES_PER_S * 1e3,
                   kernel_launches=kernel_launches, **extra)

    # ViT-H/14's two paths' shapes (D 1280, MLP 5120, LN eps 1e-6), drawn from a generator of their own so that the
    # other cases' inputs stay as they were: rows of the ViT entry, their launches from the vit_h_14 paths
    with drawing_from(torch.Generator(device=dev).manual_seed(14)):
        mlp_rows += [mlp_case(64 * 257, 1280, torch.bfloat16, "vit_h_14 bf16 b64", eps=1e-6, strict=True),
                     mlp_case(16 * 257, 1280, torch.float32, "vit_h_14 f32 b16", eps=1e-6, strict=True)]
    rows.append(entry(mlp_rows[1], "vit_b_16 bf16 b256", mlp_rows[:1] + mlp_rows[2:]))

    widths = (96, 192, 384, 768)
    sides = (56, 28, 14, 7)      # Swin-T's and ConvNeXt-T's maps at 224x224
    sides_v2 = (64, 32, 16, 8)   # Swin-v2-T's at 256x256
    swin_mlp_rows, cn_rows = [], []
    for dtype in (torch.float32, torch.bfloat16):
        # batch 256: the bfloat16 main paths' shapes; float32 at the same shapes is timed beside them and is on no path
        for c, side in zip(widths, sides):
            swin_mlp_rows.append(mlp_case(256 * side * side, c, dtype, SWIN))
            cn_rows.append(mlp_case(256 * side * side, c, dtype, CN, cn=True))
        mlp_case(4 * 49, 1536, dtype)  # ConvNeXt-L's last width
    swin_f32_rows = [mlp_case(32 * side * side, c, torch.float32, SWIN_F32)  # the float32 path's shapes, batch 32
                     for c, side in zip(widths, sides)]
    for c, side in zip(widths, sides_v2):  # Swin-v2-T's, batch 64: post_norm at every width
        mlp_case(64 * side * side, c, torch.bfloat16, post_norm=True)
    for c, real, side in ((128, 96, 56), (256, 192, 28), (384, 0, 14), (768, 0, 7)):  # the padded Swin-T's, batch 64
        mlp_case(64 * side * side, c, torch.bfloat16, ln_count=real)
    for c, real in ((96, 0), (128, 96), (256, 192)):  # the options in float32, and both at once; shapes of no path
        mlp_case(48 * 28 * 28, c, torch.float32, post_norm=True, ln_count=real)
        mlp_case(48 * 28 * 28, c, torch.float32, ln_count=real)
    mlp_case(48 * 28 * 28, 256, torch.bfloat16, post_norm=True, ln_count=192)
    with drawing_from(train_draws):
        for c, side in zip(widths, sides):  # the Swin-T training paths' shapes, batch 128 (and ConvNeXt-T's block 0)
            mlp_case(128 * side * side, c, torch.bfloat16)
        mlp_case(128 * 56 * 56, 96, torch.bfloat16, cn=True)
    # mlp_block has two entries: the one above on the ViT paths (D 768, Dh a multiple of 256), this one on the
    # Swin paths, which run the widths, post_norm and ln_count that the kernel gained for them
    rows.append(entry(swin_mlp_rows[4], SWIN, swin_mlp_rows[:4] + swin_mlp_rows[5:] + swin_f32_rows,
                      kernel_launches_a_forward={k: v for k, v in mlp_kernel_launches.items() if "convnext" not in k}))
    rows.append(entry(cn_rows[-1], CN, cn_rows[:-1],
                      kernel_launches_a_forward={k: v for k, v in mlp_kernel_launches.items() if "convnext" in k}))

    # window_attention_block at every shape the Swin paths hand it.  The SDPA buffers of the cases on no path (timed
    # only in float32) draw from a generator of their own, so that timing them leaves every case's checked inputs as
    # they were before those cases were timed.  Other draws can take the bf16 v2 padded case past its rule: that fault
    # is open (ROADMAP.md queue 3), and tests/test_torch_cuda.py::test_bf16_v2_window_block_over_seeds sweeps draws
    held_sdpa_gen = torch.Generator(device=dev).manual_seed(1)

    def window_case(nw, s, c, nw_img, dtype, path=None, v2=False, masked=True, ln_count=0, spread=False):
        n_heads = c // 32
        x = normal((nw, s, c), dtype)
        ln_g, ln_b = normal((c,), torch.float32, 0.2, 1.0), normal((c,), torch.float32, 0.1)
        w_qkv, b_qkv = normal((c, 3 * c), dtype, c ** -0.5), normal((3 * c,), torch.float32, 0.1)
        w_o, b_o = normal((c, c), dtype, c ** -0.5), normal((c,), torch.float32, 0.1)
        rel_bias = normal((n_heads, s, s), torch.float32, 0.3)
        ws = int(round(s ** 0.5))
        side = int(round(nw_img ** 0.5)) * ws
        mask = None
        if masked:  # a window as large as the map is never shifted; it still gets a mask here, of one region
            mask = models.swin._shift_mask(side, side, ws, ws // 2 if nw_img > 1 else 0, ws // 2 if nw_img > 1 else 0).to(dev)
        logit_scale = normal((n_heads,), torch.float32, 0.5, 2.3) if v2 else None
        if spread:  # per-head logits spread over +-100 (v2) or offset by -150 and 120 (v1)
            if v2:
                logit_scale = torch.tensor([100.0, 0.01, 1.0], device=dev)
                rel_bias = torch.zeros_like(rel_bias)
            else:
                rel_bias = rel_bias + torch.tensor([0.0, -150.0, 120.0], device=dev)[:, None, None]
        if ln_count:
            for t in (x, ln_g, ln_b, b_o):
                t[..., ln_count:] = 0
            w_qkv[ln_count:] = 0
            w_o[:, ln_count:] = 0
        if v2:
            b_qkv[c : 2 * c] = 0
        scale = 32 ** -0.5
        args = (x, ln_g, ln_b, w_qkv, b_qkv, w_o, b_o, rel_bias, mask, logit_scale, n_heads, scale, 1e-5, v2, nw_img, ln_count)
        kernel_launches = kernels.window_attention_block.kernel_launches
        out = kernels.window_attention_block(*args)
        kernel_launches = kernels.window_attention_block.kernel_launches - kernel_launches  # of this one call, as counted
        what = f"window_attention_block {nw}x{s}x{c} {dtype} v2={v2} masked={masked} ln_count={ln_count} spread={spread}"
        twin = swin_attention.window_attention_block_plain(*args)
        err = max_err_f32(out, twin, what, TOL[dtype], TOL[dtype])
        require(torch.equal(kernels.window_attention_block(*args), out), what + ": two calls differ")
        want_launches = 5 if v2 and dtype == torch.bfloat16 else 4  # bf16 v2: v, then q and k in float64
        require(kernel_launches == want_launches, f"{what}: {kernel_launches} kernel launches a call, not {want_launches}")
        extra = {}
        if dtype == torch.float32 or path is not None:
            extra["launch_ms"] = launch_split(lambda: kernels.window_attention_block(*args), kernel_launches)
        if dtype == torch.float32:
            # the products on split TF32: each launch apart, and the block held to float64 (f64_err no more than
            # twice the twin's, TF32 off), as the f32 MLP
            split = extra["launch_ms"]
            require(split is not None and split_is_x3(split, 2), f"{what}: launches {split}")
            ref64 = swin_attention._window_attention_block_f64(*args)
            extra.update(f64_err=f64_err(out, ref64), twin_f64_err=f64_err(twin, ref64))
            del ref64
            print(f"  {what}: launches apart {split}; max|a - f64| / max|f64|: kernel {extra['f64_err']:.3e}, twin "
                  f"(TF32 off) {extra['twin_f64_err']:.3e}")
            require(extra["f64_err"] <= 2 * extra["twin_f64_err"], what + ": strays from float64 past twice the twin")
        del twin
        tokens, size = nw * s, x.element_size()
        core_ops = nw * n_heads * s * s * (4 * 32 + 5)
        if dtype == torch.float32 or path is not None:
            add = rel_bias[None].expand(nw, -1, -1, -1)  # the bias and mask as SDPA's additive mask
            if mask is not None:
                add = add + mask.repeat(nw // nw_img, 1, 1)[:, None]
            add32, add = add.float().contiguous(), add.to(dtype).contiguous()
            # the core alone (on every float32 case, and in bf16 on the paths' rows): the float32 QKV rows, position
            # bias, mask and logit scale read once, the joined heads written once, its operations at the rate of the
            # products that carry them (split TF32 in float32); SDPA on q, k and v of the compute dtype with the bias
            # and mask as its additive mask
            extra.update(core_fields(extra["launch_ms"], tokens * 3 * c * 4 + 4 * rel_bias.numel()
                                     + (4 * mask.numel() if masked else 0) + (4 * n_heads if v2 else 0)
                                     + tokens * c * size, core_ops, core_rate[dtype],
                                     sdpa_ms(nw, s, n_heads, 32, dtype, scale, add if dtype == torch.bfloat16 else add32,
                                             None if path is not None else held_sdpa_gen)))
        if path is None:
            hold("window_attention_block", x.shape, dtype, err, v2=v2, masked=masked, ln_count=ln_count, spread=spread,
                 kernel_launches=kernel_launches, **extra)
            return None

        # the stock composite: layer_norm + linear + SDPA with the bias and mask as its additive mask + linear
        def library():
            h = F.layer_norm(x, (c,), ln_g.to(dtype), ln_b.to(dtype), 1e-5)
            q, k, v = (t.reshape(nw, s, n_heads, 32).permute(0, 2, 1, 3)
                       for t in F.linear(h, w_qkv.t(), b_qkv.to(dtype)).split(c, dim=-1))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=add, scale=scale).permute(0, 2, 1, 3).reshape(nw, s, c)
            return x + F.linear(o, w_o.t(), b_o.to(dtype))

        # v2: linear, cosine attention (q and k normalised, q times each head's exp(logit scale)) through SDPA with
        # the CPB bias and mask as its additive mask, linear, then the post-norm layer_norm and the residual
        def library_v2(dt):
            xx = x.to(dt)
            q, k, v = (t.reshape(nw, s, n_heads, 32).permute(0, 2, 1, 3)
                       for t in F.linear(xx, w_qkv.to(dt).t(), b_qkv.to(dt)).split(c, dim=-1))
            q = F.normalize(q, dim=-1) * torch.exp(logit_scale.clamp_max(float(np.log(100.0)))).to(dt)[:, None, None]
            o = F.scaled_dot_product_attention(q, F.normalize(k, dim=-1), v, attn_mask=add if dt == dtype else add32,
                                               scale=1.0)
            o = F.linear(o.permute(0, 2, 1, 3).reshape(nw, s, c), w_o.to(dt).t(), b_o.to(dt))
            return xx + F.layer_norm(o, (c,), ln_g.to(dt), ln_b.to(dt), 1e-5)

        if v2:
            # in bfloat16 the composite rounds q, k and the post-norm's input where the kernel keeps float32, and the
            # post-norm magnifies that (0.25 on an H100): its formula is held in float32 against the twin instead
            args32 = (x.float(), ln_g, ln_b, w_qkv.float(), b_qkv, w_o.float(), *args[6:])
            with _dtype.full_float32():
                max_err_f32(library_v2(torch.float32), swin_attention.window_attention_block_plain(*args32),
                            what + " in float32 vs the stock composite", 1e-3, 1e-3)
            library_ms = time_ms(lambda: library_v2(dtype), 5)
        else:
            max_err_f32(out, library(), what + " vs the stock composite", 5e-2 if dtype == torch.bfloat16 else 1e-3,
                        5e-2 if dtype == torch.bfloat16 else 1e-3)
            library_ms = time_ms(library, 5)
        # the bound counts what the function needs: x and out once, the weights, LayerNorm parameters, biases,
        # position bias, mask and logit scale once.  The float32 QKV product, the joined heads and v2's float32
        # branch rows, written and read once each between the launches of a call, are this split's own traffic
        # (the TPU kernels keep them on chip): their time at the memory rate is split_bytes_ms
        nbytes = (2 * x.numel() * size + (w_qkv.numel() + w_o.numel()) * size + 4 * (6 * c + rel_bias.numel())
                  + (4 * mask.numel() if masked else 0) + (4 * n_heads if v2 else 0))
        # (+ the LN rows of v1, written by a row pass and read by the QKV product)
        split_bytes = (2 * tokens * 3 * c * 4 + 2 * tokens * c * size + (2 * tokens * c * 4 if v2 else 0)
                       + (2 * tokens * c * size if not v2 else 0))
        if dtype == torch.bfloat16:
            extra.update(hgmma_in_sass=hgmma["swin_attention"], core_hgmma_in_sass=core_hgmma["swin_attention"],
                         core_occupancy=window_core_info["window_tc_kernel"])
        else:
            extra.update(hgmma_tf32_in_sass=tf32_hgmma["swin_attention"],
                         core_hgmma_tf32_in_sass=sum(window_x3_hgmma.values()),
                         core_occupancy=window_core_info["window_x3_kernel"])
        # the products and the core at one rate: split TF32's in float32 (TF32X3_OPS_PER_S), bf16's in bf16
        nops = tokens * (8 * c * c + 8 * c) + core_ops
        return row("window_attention_block", f"{PALLAS_SWIN}:234", path, err,
                   time_ms(lambda: kernels.window_attention_block(*args), 5),
                   time_ms(lambda: swin_attention.window_attention_block_plain(*args), 3), nbytes, nops,
                   library_ms=library_ms, source=SWIN_ATTENTION, ops_per_s=x3_rate[dtype], at=(x.shape, dtype),
                   shape=[nw, s, c], dtype=str(dtype).replace("torch.", ""), v2=v2, kernel_launches=kernel_launches,
                   split_bytes_ms=split_bytes / HBM_BYTES_PER_S * 1e3, **extra)

    window_rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for c, side in zip(widths, sides):  # batch 256, shifted and masked; float32 at these shapes is on no path
            nw_img = (side // 7) ** 2
            window_rows.append(window_case(256 * nw_img, 49, c, nw_img, dtype, SWIN))
        window_case(256 * 64, 49, 96, 64, dtype, masked=False)
        window_case(64 * 64, 64, 96, 64, dtype, v2=True, masked=False)
        window_case(64 * 64, 49, 128, 64, dtype, v2=True, ln_count=96)
    # fault 2 (ROADMAP.md queue 3, fixed): where the training paths' held cases drew from the checks'
    # generator ahead of the next loop, its first case, (2048, 49, 96) masked, stood past its float64 rule.  Its draw
    # is the checks' generator at this offset plus what those cases drew (seed 0, offset 12968 on an H100 SXM, as
    # tests/test_torch_cuda.py::test_f32_window_block_on_fault_2s_draw replays it); it is replayed after the loop and
    # held to the rule
    f2_at = (gen.initial_seed(), gen.get_offset() + train_draws.get_offset())
    for c, side in zip(widths, sides):  # the float32 path's shapes, batch 32 (its last stage takes the plain route)
        nw_img = (side // 7) ** 2
        window_case(32 * nw_img, 49, c, nw_img, torch.float32, masked=nw_img > 1)
    f2_gen = torch.Generator(device=dev).manual_seed(f2_at[0])
    f2_gen.set_offset(f2_at[1])
    with drawing_from(f2_gen):
        f2_args = [normal((2048, 49, 96), torch.float32), normal((96,), torch.float32, 0.2, 1.0),
                   normal((96,), torch.float32, 0.1), normal((96, 288), torch.float32, 96 ** -0.5),
                   normal((288,), torch.float32, 0.1), normal((96, 96), torch.float32, 96 ** -0.5),
                   normal((96,), torch.float32, 0.1), normal((3, 49, 49), torch.float32, 0.3),
                   models.swin._shift_mask(56, 56, 7, 3, 3).to(dev), None, 3, 32 ** -0.5, 1e-5, False, 64, 0]
    f2_ref64 = swin_attention._window_attention_block_f64(*f2_args)
    f2_err = (f64_err(kernels.window_attention_block(*f2_args), f2_ref64),
              f64_err(swin_attention.window_attention_block_plain(*f2_args), f2_ref64))
    print(f"fault 2 (fixed): the f32 window block (2048, 49, 96) masked on the draw at seed {f2_at[0]}, offset "
          f"{f2_at[1]} of the checks' generator: max|a - f64| / max|f64| kernel {f2_err[0]:.3e}, twin (TF32 off) "
          f"{f2_err[1]:.3e}, {f2_err[0] / f2_err[1]:.3f} times (rule 2)")
    require(f2_err[0] <= 2 * f2_err[1], "fault 2's draw: the f32 window block strays from float64 past twice the twin")
    del f2_args, f2_ref64
    for c, side in zip(widths, sides_v2):  # Swin-v2-T's, batch 64, windows of 8
        nw_img = (side // 8) ** 2
        case = window_case(64 * nw_img, 64, c, nw_img, torch.bfloat16, SWIN_V2 if c == 96 else None, v2=True,
                           masked=nw_img > 1)
        if case is not None:
            window_rows.append(case)
        window_case(64 * nw_img, 64, c, nw_img, torch.float32, v2=True, masked=nw_img > 1)
    for c, real, side in ((128, 96, 56), (256, 192, 28), (384, 0, 14), (768, 0, 7)):  # the padded Swin-T's, batch 64
        nw_img = (side // 7) ** 2
        window_case(64 * nw_img, 49, c, nw_img, torch.bfloat16, ln_count=real, masked=nw_img > 1)
        if real:
            window_case(64 * nw_img, 49, c, nw_img, torch.float32, ln_count=real)
    window_case(16, 64, 96, 16, torch.float32, v2=True, masked=False, spread=True)
    window_case(64, 49, 96, 64, torch.float32, masked=False, spread=True)
    with drawing_from(train_draws):
        for c, side in zip(widths, sides):  # the Swin-T training paths' shapes, batch 128
            nw_img = (side // 7) ** 2
            window_case(128 * nw_img, 49, c, nw_img, torch.bfloat16, masked=nw_img > 1)

    # fault 1 (ROADMAP.md queue 3, fixed): the bf16 v2 block at the held case's shape (4096, 49, 128), ln_count 96,
    # Swin-T's shift mask, on the 24 draws of tests/test_torch_cuda.py::test_bf16_v2_window_block_over_seeds (numpy
    # seeds 0-23, drawn in that test's order, the k bias zeroed), each within the bf16 rule of the twin
    f1_mask, f1_bf = models.swin._shift_mask(56, 56, 7, 3, 3).to(dev), torch.bfloat16
    f1_worst = []
    for f1_seed in range(24):
        f1_rng = np.random.default_rng(f1_seed)

        def f1_normal(shape, dtype, std=1.0, mean=0.0):
            return torch.from_numpy((f1_rng.standard_normal(shape) * std + mean).astype(np.float32)).to(dev, dtype)

        f1_rng.random((64, 49, 49))  # the test's own mask and logit scales, drawn and replaced as it replaces them
        f1_rng.uniform(0.5, 2.0, 4)
        f1_args = [f1_normal((4096, 49, 128), f1_bf), f1_normal((128,), torch.float32, 0.2, 1.0),
                   f1_normal((128,), torch.float32, 0.1), f1_normal((128, 384), f1_bf, 128 ** -0.5),
                   f1_normal((384,), torch.float32, 0.1), f1_normal((128, 128), f1_bf, 128 ** -0.5),
                   f1_normal((128,), torch.float32, 0.1), f1_normal((4, 49, 49), torch.float32, 0.3)]
        for t in (f1_args[0], f1_args[1], f1_args[2], f1_args[6]):
            t[..., 96:] = 0
        f1_args[3][96:] = 0
        f1_args[5][:, 96:] = 0
        f1_args += [f1_mask, f1_normal((4,), torch.float32, 0.5, 2.3), 4, 32 ** -0.5, 1e-5, True, 64, 96]
        f1_args[4][128:256] = 0
        f1_out = kernels.window_attention_block(*f1_args)
        f1_twin = swin_attention.window_attention_block_plain(*f1_args)
        f1_err = (f1_out.float() - f1_twin.float()).abs()
        f1_worst.append((float(f1_err.max()), float((f1_err / (TOL[f1_bf] * (1 + f1_twin.float().abs()))).max())))
        del f1_args, f1_out, f1_twin, f1_err
    print(f"fault 1: the bf16 v2 block on the card test's 24 draws, (max |err|, max |err| / (2e-2 (1 + |twin|))) a "
          f"draw: {[(round(e, 5), round(r, 3)) for e, r in f1_worst]}")
    require(all(r <= 1 for _, r in f1_worst), f"fault 1: draws {[i for i, (_, r) in enumerate(f1_worst) if r > 1]} "
                                               f"break the bf16 rule")
    main = next(r for r in window_rows if r["dtype"] == "bfloat16" and r["shape"] == [256 * 64, 49, 96] and not r["v2"])
    rows.append(entry(main, SWIN, [r for r in window_rows if r is not main],
                      kernel_launches_a_forward=window_kernel_launches))
    print(f"  window_attention_block's launches apart at {main['shape']} (device ms): {main['launch_ms']}")

    # depthwise_conv2d 7x7 at ConvNeXt-T's stage shapes (batch 256), 3x3 and 5x5, and shapes off its tiles (9x13 maps,
    # C 40 and 200); every case twice, the same bits, with the tile, registers, shared memory and blocks an SM of its
    # launch (depthwise.kernel_info).  The bound is the function's: its operations at the card's peak rate for the
    # inputs' type (bf16: the tensor cores', so bytes bind).  The kernel does them as f32 FMAs on the CUDA cores in
    # either dtype; that pipe's floor, the operations at 67 TFLOP/s, is printed apart as fma_floor_ms
    def depthwise_case(shape, ks, dtype, path=None, use_bias=True):
        c = shape[3]
        x = normal(shape, dtype)
        taps, bias = normal((ks, ks, c), dtype, 1.0 / ks), normal((c,), torch.float32)
        out = kernels.depthwise_conv2d(x, taps, bias, use_bias)
        ref = depthwise.depthwise_conv2d_plain(x, taps, bias, use_bias)
        what = f"depthwise_conv2d {shape} {ks}x{ks} {dtype} bias={use_bias}"
        if dtype == torch.float32:
            err = max_err_f32(out, ref, what, CONV_ATOL, CONV_RTOL)
        else:
            err = max_err_f32(out, ref, what, TOL[dtype], TOL[dtype])
        require(torch.equal(kernels.depthwise_conv2d(x, taps, bias, use_bias), out), what + ": two calls differ")
        info = depthwise.kernel_info(x, ks)
        print(f"  {what}: {info}")
        if path is None:
            hold("depthwise_conv2d", shape, dtype, err, taps=ks, bias=use_bias, kernel_info=info)
            return None
        weight = taps.permute(2, 0, 1)[:, None].contiguous()
        nchw = x.permute(0, 3, 1, 2)  # a channels-last view of the same memory

        def library():
            with _dtype.full_float32():
                return F.conv2d(nchw, weight, bias.to(dtype) if use_bias else None, padding=ks // 2, groups=c)

        max_err_f32(out, library().permute(0, 2, 3, 1), what + " vs F.conv2d", 1e-4 if dtype == torch.float32 else 5e-2,
                    1e-4 if dtype == torch.float32 else 5e-2)
        ops = x.numel() * 2 * ks * ks
        return row("depthwise_conv2d", f"{PALLAS_DEPTHWISE}:57", path, err,
                   time_ms(lambda: kernels.depthwise_conv2d(x, taps, bias, use_bias), 10),
                   time_ms(lambda: depthwise.depthwise_conv2d_plain(x, taps, bias, use_bias), 3),
                   2 * x.numel() * x.element_size() + taps.numel() * x.element_size() + 4 * c, ops,
                   library_ms=time_ms(library, 10), source=DEPTHWISE, ops_per_s=rate[dtype], at=(x.shape, dtype),
                   shape=list(shape), taps=ks, dtype=str(dtype).replace("torch.", ""), kernel_info=info,
                   fma_floor_ms=ops / F32_OPS_PER_S * 1e3)

    dw_rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for c, side in zip(widths, sides):
            dw_rows.append(depthwise_case((256, side, side, c), 7, dtype, CN))
        depthwise_case((128, 28, 28, 192), 3, dtype)
        depthwise_case((64, 56, 56, 96), 5, dtype, use_bias=False)
        depthwise_case((16, 9, 13, 40), 7, dtype)
        depthwise_case((16, 9, 13, 200), 5, dtype, use_bias=False)
        depthwise_case((64, 7, 7, 200), 3, dtype)
    with drawing_from(train_draws):
        for c, side in zip(widths, sides):  # the ConvNeXt-T training path's shapes, batch 128 (forward and dx)
            depthwise_case((128, side, side, c), 7, torch.bfloat16)
    main = next(r for r in dw_rows if r["dtype"] == "bfloat16" and r["shape"] == [256, 56, 56, 96])

    # row 14's backward dx at ConvNeXt-T's stage shapes, bf16 b256: the forward kernel on the flipped taps (one launch,
    # depthwise.py:_backward), held to its plain version; bound: the gradient read and dx written once; library:
    # aten.convolution_backward with groups=C, dx only (cuDNN, TF32 off)
    def depthwise_dx_case(shape):
        c = shape[3]
        g, xin = normal(shape, torch.bfloat16), normal(shape, torch.bfloat16)
        taps = normal((7, 7, c), torch.bfloat16, 1.0 / 7)
        flipped, no_bias = taps.flip(0, 1).contiguous(), torch.zeros(c, device=dev)
        out = kernels.depthwise_conv2d(g, flipped, no_bias, use_bias=False)
        what = f"depthwise_conv2d dx {list(shape)}"
        require(torch.equal(kernels.depthwise_conv2d(g, flipped, no_bias, use_bias=False), out), what + ": two calls differ")
        err = max_err_f32(out, depthwise.depthwise_conv2d_plain(g, flipped, None), what, TOL[torch.bfloat16],
                          TOL[torch.bfloat16])
        weight = taps.permute(2, 0, 1)[:, None].contiguous()
        g_nchw, x_nchw = g.permute(0, 3, 1, 2), xin.permute(0, 3, 1, 2)  # channels-last views of the same memory

        def library():
            with _dtype.full_float32():
                return torch.ops.aten.convolution_backward(g_nchw, x_nchw, weight, None, [1, 1], [3, 3], [1, 1], False,
                                                           [0, 0], c, [True, False, False])[0]

        max_err_f32(out, library().permute(0, 2, 3, 1), what + " vs aten.convolution_backward", 5e-2, 5e-2)
        b_ms, b_by = bound(2 * g.numel() * 2 + taps.numel() * 2, g.numel() * 2 * 49, BF16_OPS_PER_S)
        dx = dict(shape=list(shape), taps=7, dtype="bfloat16", max_abs_err=err,
                  ms=time_ms(lambda: kernels.depthwise_conv2d(g, flipped, no_bias, use_bias=False), 10),
                  plain_ms=time_ms(lambda: depthwise.depthwise_conv2d_plain(g, flipped, None), 3),
                  bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, 10),
                  fma_floor_ms=g.numel() * 2 * 49 / F32_OPS_PER_S * 1e3)
        print(f"depthwise_conv2d backward dx {list(shape)}: kernel_ms {dx['ms']:.4f} plain_ms {dx['plain_ms']:.4f} "
              f"bound_ms {b_ms:.4f} ({b_by}) library_ms {dx['library_ms']:.4f}, max_abs_err {err}")
        return dx

    rows.append(entry(main, CN, [r for r in dw_rows if r is not main],
                      backward_dx=[depthwise_dx_case((256, side, side, c)) for c, side in zip(widths, sides)]))

    # nms_sorted at the three shapes of a detection forward, on the boxes the float32 path handed it; the bound counts
    # the IoUs this data needs (every pair of kept boxes, one a struck box against a kept box that struck it), each
    # box's area once, and the boxes and keep mask once; the suppression bits the first launch writes and the second
    # reads are the split's own traffic (split_bytes_ms)
    def nms_needed_ops(boxes, keep):
        """NMS_*_OPS over the pairs this data needs: a struck box's pair meets; a pair of kept boxes meets where
        the product of its clipped sides is above 0, as the kernel computes it."""
        n_ = boxes.shape[1]
        meeting, disjoint = 0, 0
        for b, k in zip(boxes.float(), keep):
            x1, y1, x2, y2 = b[k].unbind(-1)
            w = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])).clamp_min(0)
            h = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])).clamp_min(0)
            meets = int(torch.triu(w * h > 0, diagonal=1).sum())
            kept = int(k.sum())
            meeting += meets + n_ - kept
            disjoint += kept * (kept - 1) // 2 - meets
            del w, h
        nops = boxes.shape[0] * n_ * NMS_AREA_OPS + meeting * NMS_PAIR_OPS + disjoint * NMS_DISJOINT_OPS
        return nops, meeting, disjoint

    def nms_case(boxes, thr, path=None, what=""):
        keep = kernels.nms_sorted(boxes, thr)
        err = exact(keep, nms_kernel.nms_sorted_plain(boxes, thr), f"nms_sorted {list(boxes.shape)} {what}")
        p_, n_ = boxes.shape[0], boxes.shape[1]
        kept = keep.sum(dim=1).double()
        if path is None:
            hold("nms_sorted", boxes.shape, boxes.dtype, err, threshold=thr, case=what, kept=int(kept.sum()))
            return None
        nops, meeting, disjoint = nms_needed_ops(boxes, keep)
        split = launch_split(lambda: kernels.nms_sorted(boxes, thr), 2, keep=lambda name: "nms_" in name)
        print(f"  nms_sorted {list(boxes.shape)}'s launches apart (device ms): {split}")
        return row("nms_sorted", f"{PALLAS_NMS}:93", path, err, time_ms(lambda: kernels.nms_sorted(boxes, thr), 20),
                   time_ms(lambda: nms_kernel.nms_sorted_plain(boxes, thr), 3), p_ * n_ * (16 + 1), nops,
                   source=NMS, at=(boxes.shape, boxes.dtype), shape=list(boxes.shape), threshold=thr,
                   kept=int(kept.sum()), iou_pairs_needed={"meeting": meeting, "disjoint": disjoint}, ops_needed=nops,
                   launch_ms=split, kernel_launches=2,
                   split_bytes_ms=2 * p_ * nms_kernel.mask_words(n_) * 8 / HBM_BYTES_PER_S * 1e3)

    require({(shape, torch.float32) for shape, _ in nms_inputs} == set(det_nms_shapes),
            f"captured nms_sorted inputs {list(nms_inputs)}")
    nms_rows = [nms_case(boxes, thr, DET_F32, "the f32 detection path's boxes") for (_, thr), boxes in nms_inputs.items()]
    crowd_ctr = torch.rand((8, 4096, 2), generator=gen, device=dev) * 80
    crowd_wh = torch.rand((8, 4096, 2), generator=gen, device=dev) * 40 + 5
    nms_case(torch.cat([crowd_ctr - crowd_wh / 2, crowd_ctr + crowd_wh / 2], -1), 0.5, what="dense overlaps")
    odd = torch.rand((3, 333, 4), generator=gen, device=dev) * 50
    nms_case(torch.cat([odd[..., :2], odd[..., :2] + odd[..., 2:] + 1], -1), 0.7, what="N off the tile of 64")
    # past the scan's staged words (csrc/nms.cu NMS_STAGE_WORDS, 64 x 64 boxes): the later words from device memory
    far = torch.rand((1, 8500, 4), generator=gen, device=dev) * torch.tensor([900.0, 900.0, 60.0, 60.0], device=dev)
    nms_case(torch.cat([far[..., :2], far[..., :2] + far[..., 2:] + 2], -1), 0.5, what="N past the staged words")
    del far
    main = next(r for r in nms_rows if r["shape"] == [8, 4096, 4])
    nms_entry = entry(main, DET_F32, [r for r in nms_rows if r is not main])
    rows.append(nms_entry)

    # int8_matmul_requant at each of the 15 distinct (M, K, N) of the int8 ResNet-50 path, on the path's own inputs;
    # the entry is the heaviest shape, layer 1's (802,816 x 256) @ (256 x 64), with the others beside it and the sums
    # over a forward's 36 launches (forward_ms, forward_library_ms, forward_bound_ms: each shape's time times its
    # launches).  library_ms is a composite: torch._int_mm on the weight laid out for cuBLASLt, then the stock
    # epilogue.  Bound: the int8 operands and output once, 2 M K N int8 operations
    def int8_mm_row(qx_, qw_, sc_, b_, os_, relu_, timed):
        m_, k_ = qx_.shape
        n_ = qw_.shape[1]
        err = exact(kernels.int8_matmul_requant(qx_, qw_, sc_, b_, os_, relu_),
                    int8_matmul.int8_matmul_requant_plain(qx_, qw_, sc_, b_, os_, relu_),
                    f"int8_matmul_requant {m_}x{k_}x{n_}")
        inv_ = 1.0 / os_
        qw_cm = qw_.t().contiguous().t()

        def library():
            f_ = torch._int_mm(qx_, qw_cm).float() * sc_ + b_
            return int8_matmul.quantize_i8(torch.relu(f_) if relu_ else f_, inv_)

        exact(library(), int8_matmul.int8_matmul_requant_plain(qx_, qw_, sc_, b_, os_, relu_), "int8 composite")
        if not timed:
            return None
        return row("int8_matmul_requant", f"{PALLAS_INT8_MM}:55", INT8_R50, err,
                   time_ms(lambda: kernels.int8_matmul_requant(qx_, qw_, sc_, b_, os_, relu_), 20),
                   time_ms(lambda: int8_matmul.int8_matmul_requant_plain(qx_, qw_, sc_, b_, os_, relu_), 5),
                   m_ * k_ + k_ * n_ + m_ * n_ + 8 * n_, 2 * m_ * k_ * n_, library_ms=time_ms(library, 10),
                   source=INT8_MATMUL, ops_per_s=INT8_OPS_PER_S, at=(qx_.shape, qx_.dtype), shape=[m_, k_, n_],
                   relu=relu_)

    mm_rows, mm_launches = {}, {}
    for args in r50_inputs:
        key = (args[0].shape[0], args[0].shape[1], args[1].shape[1])
        mm_launches[key] = mm_launches.get(key, 0) + 1
        timed_row = int8_mm_row(*args, timed=key not in mm_rows)
        if timed_row is not None:
            mm_rows[key] = timed_row
    for key, r in mm_rows.items():
        r["launches_a_forward"] = mm_launches[key]
    mm_forward = {f"forward_{k}": sum(r[k] * r["launches_a_forward"] for r in mm_rows.values())
                  for k in ("ms", "library_ms", "bound_ms")}
    print(f"  int8_matmul_requant over one {INT8_R50} forward ({sum(mm_launches.values())} launches, {len(mm_rows)} "
          f"shapes): {mm_forward} ({card})")
    require(len(mm_rows) == 15 and sum(mm_launches.values()) == 36, f"{INT8_R50}: expected 36 launches in 15 shapes")
    main = mm_rows[(802816, 256, 64)]
    rows.append(entry(main, INT8_R50, [r for r in mm_rows.values() if r is not main], held_exact_at_shapes=len(r50_held),
                      **mm_forward))
    del r50_inputs

    # mlp_block_int8 and attention_block_int8 at ViT-B/16's shapes on layer 0's real inputs; library_ms is a composite
    # (layer_norm, quantise, torch._int_mm, gelu or SDPA, quantise, torch._int_mm, epilogue).  Bound: x in and out
    # once, the int8 weights once, 4 D Dh (MLP) or 8 D^2 (attention projections) int8 operations a token at the
    # int8 rate, plus the attention core's S^2 (4 hd + 5) a head at the bf16 rate
    xm = vit_mlp_args[0]
    err = max_err_f32(kernels.mlp_block_int8(*vit_mlp_args), int8_transformer.mlp_block_int8_plain(*vit_mlp_args),
                      "mlp_block_int8", TOL[torch.bfloat16], TOL[torch.bfloat16])
    w1c, w2c = vit_mlp_args[3].t().contiguous().t(), vit_mlp_args[6].t().contiguous().t()
    inv1, inv2 = 1.0 / vit_mlp_args[9], 1.0 / vit_mlp_args[10]

    def mlp_i8_library():
        _, g_, bb_, _, s1_, b1_, _, s2_, b2_, _, _, eps_ = vit_mlp_args
        h_ = F.layer_norm(xm.float(), (768,), g_, bb_, eps_)
        f_ = F.gelu(torch._int_mm(int8_matmul.quantize_i8(h_, inv1), w1c).float() * s1_ + b1_)
        return (xm.float() + (torch._int_mm(int8_matmul.quantize_i8(f_, inv2), w2c).float() * s2_ + b2_)).to(xm.dtype)

    max_err_f32(mlp_i8_library(), int8_transformer.mlp_block_int8_plain(*vit_mlp_args), "mlp_block_int8 composite",
                5e-2, 5e-2)
    tok = xm.shape[0]
    kernels.reset_launch_counts()
    require(torch.equal(kernels.mlp_block_int8(*vit_mlp_args), kernels.mlp_block_int8(*vit_mlp_args))
            and kernels.mlp_block_int8.kernel_launches == 6, "mlp_block_int8: two calls differ, or a call is not three "
            "kernel launches")
    # its three launches apart on the device clock: LN rows to int8, up-projection, down-projection (the wrapper's
    # stock set-up, the inverse activation scales, is left out)
    mlp_i8_calls = calls_on_device(lambda: kernels.mlp_block_int8(*vit_mlp_args))
    require(mlp_i8_calls is not None, "mlp_block_int8: the profiler missed its calls")
    mlp_i8_chains = [[(k, ms) for k, ms in call if "ln_quant_rows_kernel" in k or "i8_tc_gemm_kernel" in k]
                     for call in mlp_i8_calls]
    require(all(len(c) == 3 and "ln_quant_rows_kernel" in c[0][0] and "i8_tc_gemm_kernel<0" in c[1][0]
                and "i8_tc_gemm_kernel<1" in c[2][0] for c in mlp_i8_chains),
            f"mlp_block_int8: a call ran {[k for k, _ in mlp_i8_calls[0]]}, not LN rows and two s8 products")
    mlp_i8_split = [(mlp_i8_chains[0][i][0], sum(c[i][1] for c in mlp_i8_chains) / len(mlp_i8_chains))
                    for i in range(3)]
    print(f"  mlp_block_int8's launches apart (device ms): {mlp_i8_split}; a call's other kernels: "
          f"{[k for k, _ in mlp_i8_calls[0] if not any(k == c for c, _ in mlp_i8_chains[0])]}")
    rows.append(entry(row("mlp_block_int8", f"{PALLAS_INT8_TB}:88", INT8_VIT, err,
                          time_ms(lambda: kernels.mlp_block_int8(*vit_mlp_args), 5),
                          time_ms(lambda: int8_transformer.mlp_block_int8_plain(*vit_mlp_args), 3),
                          2 * xm.numel() * 2 + 2 * 768 * 3072 + 4 * (5 * 768 + 3 * 3072), tok * 4 * 768 * 3072,
                          library_ms=time_ms(mlp_i8_library, 5), source=INT8_TRANSFORMER,
                          ops_per_s=INT8_OPS_PER_S, at=(xm.shape, xm.dtype), shape=list(xm.shape), dtype="bfloat16",
                          kernel_launches=vit_i8_mlp_kernel_launches,
                          split_bytes_ms=2 * tok * (768 + 3072) / HBM_BYTES_PER_S * 1e3, launch_ms=mlp_i8_split,
                          igmma_in_sass=sum(ig for fn, (ig, _) in i8_products.items() if "ILi0E" in fn or "ILi1E" in fn)),
                      INT8_VIT, []))
    print(f"  under mlp_block_int8's load: {clock_under(lambda: kernels.mlp_block_int8(*vit_mlp_args), 20)}")

    xa = vit_attn_args[0]
    err = max_err_f32(kernels.attention_block_int8(*vit_attn_args),
                      int8_transformer.attention_block_int8_plain(*vit_attn_args), "attention_block_int8",
                      TOL[torch.bfloat16], TOL[torch.bfloat16])
    wqkv_c, wo_c = vit_attn_args[3].t().contiguous().t(), vit_attn_args[6].t().contiguous().t()
    inv_a, inv_o = 1.0 / vit_attn_args[9], 1.0 / vit_attn_args[10]

    def attention_i8_library():
        _, g_, bb_, _, sq_, bq_, _, so_, bo_, _, _, nh_, sc_, eps_ = vit_attn_args
        n_, s_, d_ = xa.shape
        h_ = F.layer_norm(xa.float(), (d_,), g_, bb_, eps_).reshape(-1, d_)
        qkv_ = (torch._int_mm(int8_matmul.quantize_i8(h_, inv_a), wqkv_c).float() * sq_ + bq_).to(xa.dtype)
        q_, k_, v_ = (t_.reshape(n_, s_, nh_, d_ // nh_).transpose(1, 2) for t_ in qkv_.split(d_, dim=-1))
        o_ = F.scaled_dot_product_attention(q_, k_, v_, scale=sc_).transpose(1, 2).reshape(-1, d_)
        proj_ = torch._int_mm(int8_matmul.quantize_i8(o_.float(), inv_o), wo_c)
        return ((xa.float().reshape(-1, d_) + proj_.float() * so_) + bo_).to(xa.dtype).reshape(n_, s_, d_)

    max_err_f32(attention_i8_library(), int8_transformer.attention_block_int8_plain(*vit_attn_args),
                "attention_block_int8 composite", 5e-2, 5e-2)
    joined_most, joined_apart = hold_joined(vit_attn_args, "attention_block_int8")
    print(f"  attention_block_int8's joined heads: at most {joined_most} int8 step from the twin's, {joined_apart:.3e} "
          f"of them apart")
    tok = xa.shape[0] * xa.shape[1]
    attn_core_ops = 256 * 12 * 197 * 197 * (4 * 64 + 5)
    kernels.reset_launch_counts()
    require(torch.equal(kernels.attention_block_int8(*vit_attn_args), kernels.attention_block_int8(*vit_attn_args))
            and kernels.attention_block_int8.kernel_launches == 8, "attention_block_int8: two calls differ, or a call "
            "is not four kernel launches")
    # its four launches apart on the device clock: LN rows to int8, the QKV product, the core, the output product
    # (the wrapper's stock set-up, the inverse activation scales, is left out)
    attn_i8_calls = calls_on_device(lambda: kernels.attention_block_int8(*vit_attn_args))
    require(attn_i8_calls is not None, "attention_block_int8: the profiler missed its calls")
    attn_i8_chains = [[(k, ms) for k, ms in call if "ln_quant_rows_kernel" in k or "i8_tc_gemm_kernel" in k
                       or "_tc_kernel" in k or "core_kernel" in k] for call in attn_i8_calls]
    require(all(len(c) == 4 and "ln_quant_rows_kernel" in c[0][0] and "i8_tc_gemm_kernel<2" in c[1][0]
                and "attention_tc_kernel" in c[2][0] and "i8_tc_gemm_kernel<3" in c[3][0] for c in attn_i8_chains),
            f"attention_block_int8: a call ran {[k for k, _ in attn_i8_calls[0]]}, not LN rows, an s8 product, the "
            f"core and an s8 product")
    split = [(attn_i8_chains[0][i][0], sum(c[i][1] for c in attn_i8_chains) / len(attn_i8_chains)) for i in range(4)]
    print(f"  attention_block_int8's launches apart (device ms): {split}; a call's other kernels: "
          f"{[k for k, _ in attn_i8_calls[0] if not any(k == c for c, _ in attn_i8_chains[0])]}")
    # the core alone: bf16 q, k and v read once out of the (N*S, 3D) buffer, the int8 joined heads written once
    core = core_fields(split, tok * 3 * 768 * 2 + tok * 768 + 4 * 768, attn_core_ops, BF16_OPS_PER_S,
                       sdpa_ms(256, 197, 12, 64, torch.bfloat16, vit_attn_args[12]))
    rows.append(entry(row("attention_block_int8", f"{PALLAS_INT8_TB}:163", INT8_VIT, err,
                          time_ms(lambda: kernels.attention_block_int8(*vit_attn_args), 5),
                          time_ms(lambda: int8_transformer.attention_block_int8_plain(*vit_attn_args), 3),
                          2 * xa.numel() * 2 + 4 * 768 * 768 + 4 * (8 * 768),
                          tok * 8 * 768 * 768 + attn_core_ops * INT8_OPS_PER_S / BF16_OPS_PER_S,
                          library_ms=time_ms(attention_i8_library, 5), source=INT8_TRANSFORMER,
                          ops_per_s=INT8_OPS_PER_S, at=(xa.shape, xa.dtype), shape=list(xa.shape), dtype="bfloat16",
                          kernel_launches=vit_i8_kernel_launches,
                          split_bytes_ms=(tok * 768 * 2 + tok * 3 * 768 * 2 * 2 + tok * 768 * 2) / HBM_BYTES_PER_S * 1e3,
                          launch_ms=split, core_hgmma_in_sass=core_hgmma["int8_transformer"],
                          joined_steps=joined_most, joined_share=joined_apart,
                          igmma_in_sass=sum(ig for fn, (ig, _) in i8_products.items() if "ILi2E" in fn or "ILi3E" in fn),
                          **core),
                      INT8_VIT, []))
    print(f"  under attention_block_int8's load: "
          f"{clock_under(lambda: kernels.attention_block_int8(*vit_attn_args), 20)}")
    del vit_mlp_args, vit_attn_args, xm, xa, veng, reng

    # wgrad_matmul at every shape the conv1x1 path handed it, in both dtypes; bound: x and dy read once, dW written
    # once, 2 M Cin Cout operations at the split-TF32 rate (float32) or the bf16 rate; library_ms: torch.mm(x.t(), dy)
    # in float32 (TF32 off), for bfloat16 inputs the cast to float32 and that product (a composite).  The
    # products run on the tensor cores: f64_err is max |out - f64| / max |f64| against the product of the same inputs
    # in float64 on the card, held to at most twice library_f64_err, that of the library call
    from cpu_vision_tpu_torch.ops.kernels.wgrad_matmul import wgrad_matmul_plain

    wgrad_rows = []
    w_gen = torch.Generator(device=dev).manual_seed(6)
    for dtype in (torch.float32, torch.bfloat16):
        for side, cin, cout, stride in conv1x1_shapes:
            m_ = 128 * (side // stride) ** 2
            xw = torch.randn((m_, cin), generator=w_gen, device=dev).to(dtype)
            dyw = torch.randn((m_, cout), generator=w_gen, device=dev).to(dtype)
            out = kernels.wgrad_matmul(xw, dyw)
            ref = wgrad_matmul_plain(xw, dyw)
            err = float((out - ref).abs().max())
            require(err <= WGRAD_TOL * float(ref.abs().max()), f"wgrad_matmul {m_}x{cin}x{cout} {dtype}: max |err| {err}")
            require(torch.equal(kernels.wgrad_matmul(xw, dyw), out), f"wgrad_matmul {m_}x{cin}x{cout}: not deterministic")

            def library():
                with _dtype.full_float32():
                    return torch.mm(xw.t(), dyw) if dtype == torch.float32 else torch.mm(xw.t().float(), dyw.float())

            lib_out = library()
            require(float((lib_out - ref).abs().max()) <= WGRAD_TOL * float(ref.abs().max()), "wgrad library call")
            ref64 = xw.t().double() @ dyw.double()
            figures = dict(f64_err=f64_err(out, ref64), library_f64_err=f64_err(lib_out, ref64))
            require(figures["f64_err"] <= 2 * figures["library_f64_err"],
                    f"wgrad_matmul {m_}x{cin}x{cout} {dtype}: float64 error {figures} past twice the library's")
            wgrad_rows.append(row("wgrad_matmul", f"{PALLAS_WGRAD}:54", CONV1X1, err,
                                  time_ms(lambda: kernels.wgrad_matmul(xw, dyw), 20),
                                  time_ms(lambda: wgrad_matmul_plain(xw, dyw), 5),
                                  m_ * (cin + cout) * xw.element_size() + 4 * cin * cout, 2 * m_ * cin * cout,
                                  library_ms=time_ms(library, 10), source=WGRAD, ops_per_s=x3_rate[dtype],
                                  at=(xw.shape, dtype), shape=[m_, cin, cout], dtype=str(dtype).replace("torch.", ""),
                                  max_abs_ref=float(ref.abs().max()), library_composite=dtype != torch.float32,
                                  hgmma_in_sass=tf32_hgmma["wgrad_matmul"], **figures))
            print(f"  float64 error, max|a - f64| / max|f64|: kernel {figures['f64_err']:.3e}, library "
                  f"{figures['library_f64_err']:.3e}")
            del xw, dyw, out, ref, ref64, lib_out
    # and in bfloat16 at the ViT-B/16 b128 training path's four shapes (M 25,216): dW2 = aᵀ·g, dW1 = hᵀ·[du hi | lo],
    # dW_o = joinedᵀ·g and dW_qkv = hᵀ·dqkv; printed beside torch.mm in bfloat16 (no cast), which they should beat
    for cin, cout in ((3072, 768), (768, 6144), (768, 768), (768, 2304)):
        xw = torch.randn((128 * 197, cin), generator=w_gen, device=dev).to(torch.bfloat16)
        dyw = torch.randn((128 * 197, cout), generator=w_gen, device=dev).to(torch.bfloat16)
        out, ref = kernels.wgrad_matmul(xw, dyw), wgrad_matmul_plain(xw, dyw)
        err = float((out - ref).abs().max())
        require(err <= WGRAD_TOL * float(ref.abs().max()), f"wgrad_matmul 25216x{cin}x{cout}: max |err| {err}")
        ms = time_ms(lambda: kernels.wgrad_matmul(xw, dyw), 10)
        mm_bf16 = time_ms(lambda: torch.mm(xw.t(), dyw), 10)
        wgrad_rows.append(row("wgrad_matmul", f"{PALLAS_WGRAD}:54", VIT_TRAIN, err, ms,
                              time_ms(lambda: wgrad_matmul_plain(xw, dyw), 3),
                              xw.numel() * 2 + dyw.numel() * 2 + 4 * cin * cout, 2 * xw.shape[0] * cin * cout,
                              library_ms=time_ms(lambda: torch.mm(xw.t().float(), dyw.float()), 5), source=WGRAD,
                              ops_per_s=BF16_OPS_PER_S, at=(xw.shape, torch.bfloat16),
                              shape=[xw.shape[0], cin, cout], dtype="bfloat16", library_composite=True,
                              torch_mm_bf16_ms=mm_bf16))
        hold("wgrad_matmul", xw.shape, torch.bfloat16, err, cout=cout)
        print(f"  wgrad_matmul 25216x{cin}x{cout}: {ms:.4f} ms against torch.mm in bf16 {mm_bf16:.4f} "
              f"({'ahead' if ms <= mm_bf16 else 'behind'})")
        del xw, dyw, out, ref
    main = next(r for r in wgrad_rows if r["dtype"] == "bfloat16" and r["shape"] == [401408, 64, 64])
    rows.append(entry(main, CONV1X1, [r for r in wgrad_rows if r is not main]))
    ones = torch.ones(401408, 64, device=dev)
    print(f"  under wgrad_matmul's load: {clock_under(lambda: kernels.wgrad_matmul(ones, ones), 50)}")
    del ones

    # ---- the bf16 blocks' backward at ViT-B/16 b128's training shapes (rows 9-12's backward, since PR 11): Kernel B,
    # Kernel A, ln_backward_rows and the activation-gradient products against their plain versions, and four more
    # wgrad_matmul shapes.  Bounds count the function's inputs and outputs once; library_ms is one PyTorch call of
    # the same function: the backward of F.scaled_dot_product_attention (its graph kept, its kernels' time on the
    # device clock, as Kernel B's beside it), aten.gelu_backward (exact erf, on u and the rounded da), aten.native_layer_norm_backward, torch.mm in bf16
    from cpu_vision_tpu_torch.ops.kernels.transformer_block import (bf16_product_plain, ln_backward_plain,
                                                                    mlp_gelu_backward_plain)

    bf = torch.bfloat16
    tb_tokens = 128 * seq
    bgen = torch.Generator(device=dev).manual_seed(11)

    def bnormal(shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=bgen, device=dev) * std + mean).to(dtype)

    # Kernel B at the training path's (128, 197, 12, 64), and past the first design's cap of S 256: (64, 257, 16, 64)
    # and (16, 577, 16, 64), a 384² input of ViT-L/16's width; two launches a call (query-tile blocks, key-tile
    # blocks), counted and each timed apart from the profiler, with its registers, shared memory and blocks an SM
    bwd_occupancy = {name: flash_attention.kernel_info(name) for name in ("attention_bwd_q_kernel",
                                                                          "attention_bwd_kv_kernel")}

    def core_b_case(n, s_len, n_heads):
        qb, kb, vb = (bnormal((n, s_len, n_heads, hd), bf) for _ in range(3))
        dob = bnormal((n, n_heads, s_len, hd), bf)
        ob = torch.empty_like(qb)
        got = kernels.attention_core_backward(qb, kb, vb, dob, scale, o=ob)
        with _dtype.float32_products(bf):
            ref = flash_attention.attention_core_backward_plain(qb, kb, vb, dob, scale)
            joined = flash_attention.flash_mha_plain(qb, kb, vb, scale).transpose(1, 2).contiguous()
        err = max(max_err_f32(a, b, f"attention_core_backward {name} S {s_len}", TOL[bf], TOL[bf])
                  for a, b, name in zip((*got, ob), (*ref, joined), ("dq", "dk", "dv", "o")))
        require(all(torch.equal(a, b) for a, b in zip(got, kernels.attention_core_backward(qb, kb, vb, dob, scale))),
                f"attention_core_backward S {s_len}: two calls differ")
        del ref, joined
        qh, kh, vh = (t.permute(0, 2, 1, 3).detach().requires_grad_() for t in (qb, kb, vb))
        sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)

        def sdpa_backward():  # SDPA's backward kernels alone: its graph is kept between calls
            torch.autograd.grad(sdpa_out, (qh, kh, vh), dob, retain_graph=True)

        def call():
            kernels.attention_core_backward(qb, kb, vb, dob, scale, o=ob)

        # both on the device clock, the sum of the kernels of one call, in three rounds taken in turn: the
        # range over all fifteen calls of each is printed beside its mean
        device = {"kernel": [], "library": []}
        for _ in range(3):
            for side, fn in (("kernel", call), ("library", sdpa_backward)):
                seen = calls_on_device(fn)
                require(seen is not None, f"attention_core_backward S {s_len}: the profiler missed the {side}'s calls")
                device[side].extend(seen)
        kernel_launches = len(device["kernel"][0])
        require(kernel_launches == 2 and "attention_bwd_q_kernel" in device["kernel"][0][0][0]
                and "attention_bwd_kv_kernel" in device["kernel"][0][1][0],
                f"attention_core_backward S {s_len}: a call ran {[k for k, _ in device['kernel'][0]]}, not the "
                f"query-tile and key-tile kernels")
        sums = {side: [sum(t for _, t in seg) for seg in segs] for side, segs in device.items()}
        figures = {f"{side}_device_ms": sum(v) / len(v) for side, v in sums.items()}
        figures.update({f"{side}_device_ms_range": [min(v), max(v)] for side, v in sums.items()})
        launch_ms = [(device["kernel"][0][i][0], sum(seg[i][1] for seg in device["kernel"]) / len(device["kernel"]))
                     for i in range(kernel_launches)]
        print(f"  attention_core_backward {list(qb.shape)} on the device clock over {len(sums['kernel'])} calls: "
              f"kernel {figures['kernel_device_ms']:.4f} ms ({min(sums['kernel']):.4f}-{max(sums['kernel']):.4f}), "
              f"SDPA's backward {figures['library_device_ms']:.4f} ms ({min(sums['library']):.4f}-"
              f"{max(sums['library']):.4f}; its kernels {[k for k, _ in device['library'][0]]})")
        return row("attention_core_backward", f"{PALLAS_FLASH}:83", VIT_TRAIN, err, time_ms(call, 20),
                   time_ms(lambda: flash_attention.attention_core_backward_plain(qb, kb, vb, dob, scale), 3),
                   8 * qb.numel() * 2, 6 * 2 * n * n_heads * s_len * s_len * hd,
                   library_ms=figures["library_device_ms"], source=ATTENTION,
                   ops_per_s=BF16_OPS_PER_S, at=(qb.shape, bf), shape=list(qb.shape), dtype="bfloat16",
                   writes_joined_heads=True, kernel_launches=kernel_launches, launch_ms=launch_ms,
                   library_events_ms=time_ms(sdpa_backward, 10), **figures)

    core_b = core_b_case(128, seq, heads)
    rows.append(entry(core_b, VIT_TRAIN, [core_b_case(64, 257, 16), core_b_case(16, 577, 16)],
                      occupancy=bwd_occupancy,
                      hgmma_in_sass=sum(c for fn, c in _build.sass_counts("attention", "HGMMA").items() if "bwd" in fn)))
    print(f"  attention_core_backward's launches apart at {core_b['shape']} (device ms): {core_b['launch_ms']}; "
          f"occupancy {bwd_occupancy}")

    da32, hw = bnormal((tb_tokens, d_hidden), torch.float32), bnormal((tb_tokens, d_hidden), torch.float32, 2.0)
    b1 = bnormal((d_hidden,), torch.float32, 0.3)
    du2, a_out, db1 = kernels.mlp_gelu_backward(da32, hw, b1)
    ref_du2, ref_a, ref_db1 = mlp_gelu_backward_plain(da32, hw, b1)
    # the activations and du's two halves are the plain version's bits (its operators, in order, none contracted);
    # db1 sums 25,216 rows in another order: within 1e-5·(1 + |plain|) and 1e-5 of its largest
    exact(a_out, ref_a, "mlp_gelu_backward: the activations")
    exact(du2, ref_du2, "mlp_gelu_backward: du")
    err = max_err_f32(db1, ref_db1, "mlp_gelu_backward db1", 1e-5 * (1 + float(ref_db1.abs().max())), 1e-5)
    u_lib, da_lib = (hw + b1), da32.to(bf).float()
    gelu_a = row("mlp_gelu_backward", f"{PALLAS_BLOCK}:335", VIT_TRAIN, err,
                 time_ms(lambda: kernels.mlp_gelu_backward(da32, hw, b1), 20),
                 time_ms(lambda: mlp_gelu_backward_plain(da32, hw, b1), 3),
                 da32.numel() * (4 + 4 + 2 * 2 + 2) + 4 * d_hidden, 40 * da32.numel(),
                 library_ms=time_ms(lambda: torch.ops.aten.gelu_backward(da_lib, u_lib), 10), source=TRANSFORMER,
                 at=(da32.shape, torch.float32), shape=list(da32.shape), dtype="float32")
    rows.append(entry(gelu_a, VIT_TRAIN, []))
    del da32, hw, du2, a_out, ref_du2, ref_a, u_lib, da_lib

    xl, dhl, rl = (bnormal((tb_tokens, d_model), bf) for _ in range(3))
    gl = bnormal((d_model,), torch.float32, 0.2, 1.0)
    got = kernels.ln_backward_rows(xl, gl, dhl, rl)
    ref = ln_backward_plain(xl, gl, dhl, rl)
    err = max(max_err_f32(got[0], ref[0], "ln_backward_rows dx", TOL[bf], TOL[bf]),
              *(max_err_f32(a, b, "ln_backward_rows d ln_g / d ln_b", 1e-5 * (1 + float(b.abs().max())), 1e-5)
                for a, b in zip(got[1:], ref[1:])))  # sums over 25,216 rows in another order
    require(all(torch.equal(a, b) for a, b in zip(got, kernels.ln_backward_rows(xl, gl, dhl, rl))),
            "ln_backward_rows: two calls differ")
    _, mean_l, rstd_l = torch.ops.aten.native_layer_norm(xl, [d_model], gl.to(bf), None, 1e-6)
    # the vector kernel (three 16-byte chunks of a row a lane) on its persistent grid, then the blocks' sums added
    ln_info = transformer_block.ln_backward_info(xl, gl, dhl, rl)
    require(ln_info["chunks_a_lane"] == 3, f"ln_backward_rows: ViT-B/16's rows took {ln_info}, not the vector kernel")
    ln_calls = calls_on_device(lambda: kernels.ln_backward_rows(xl, gl, dhl, rl))
    require(ln_calls is not None and all([k for k, _ in c] == [k for k, _ in ln_calls[0]] for c in ln_calls)
            and sum("ln_backward_vec_kernel" in k for k, _ in ln_calls[0]) == 1
            and sum("ln_backward_reduce_kernel" in k for k, _ in ln_calls[0]) == 1,
            f"ln_backward_rows: a call ran {ln_calls and [k for k, _ in ln_calls[0]]}")
    ln_split = [(k, sum(c[i][1] for c in ln_calls) / len(ln_calls)) for i, (k, _) in enumerate(ln_calls[0])]
    print(f"  ln_backward_rows {list(xl.shape)}: {ln_info}; launches apart (device ms): {ln_split}")
    ln_rows = row("ln_backward_rows", f"{PALLAS_BLOCK}:299", VIT_TRAIN, err,
                  time_ms(lambda: kernels.ln_backward_rows(xl, gl, dhl, rl), 20),
                  time_ms(lambda: ln_backward_plain(xl, gl, dhl, rl), 5), 4 * xl.numel() * 2, 10 * xl.numel(),
                  library_ms=time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                      dhl, xl, [d_model], mean_l, rstd_l, gl.to(bf), None, [True, True, False]), 10),
                  source=TRANSFORMER, at=(xl.shape, bf), shape=list(xl.shape), dtype="bfloat16", kernel_info=ln_info,
                  kernel_launches=len(ln_split), launch_ms=ln_split)
    rows.append(entry(ln_rows, VIT_TRAIN, []))
    del xl, dhl, rl, got, ref, mean_l, rstd_l

    product_rows = []  # the activation gradients: du·[w1ᵀ; w1ᵀ] on du's two halves, g·w_oᵀ, dqkv·w_qkvᵀ
    for k_dim in (2 * d_hidden, d_model, 3 * d_model):
        ap, wp = bnormal((tb_tokens, k_dim), bf), bnormal((k_dim, d_model), bf, k_dim ** -0.5)
        zeros = torch.zeros(d_model, device=dev)
        out = kernels.bf16_product(ap, wp, zeros)
        err = max_err_f32(out, bf16_product_plain(ap, wp, zeros), f"bf16_product K {k_dim}", TOL[bf], TOL[bf])
        product_rows.append(row("bf16_product", f"{PALLAS_BLOCK}:335", VIT_TRAIN, err,
                                time_ms(lambda: kernels.bf16_product(ap, wp, zeros), 10),
                                time_ms(lambda: bf16_product_plain(ap, wp, zeros), 3),
                                (ap.numel() + wp.numel() + out.numel()) * 2, 2 * tb_tokens * k_dim * d_model,
                                library_ms=time_ms(lambda: torch.mm(ap, wp), 10), source=TRANSFORMER,
                                ops_per_s=BF16_OPS_PER_S, at=(ap.shape, bf), shape=list(ap.shape), n=d_model,
                                dtype="bfloat16"))
        del ap, wp, out
    rows.append(entry(product_rows[0], VIT_TRAIN, product_rows[1:]))

    # rows 12-14's gradients on the card (their kernels' routes against their twins' under autograd, at Swin-T's and
    # ConvNeXt-T's first stage, 2 and 4 images): float32 within 1e-5·(1 + |twin|); bfloat16 within 1e-2·(1 + |twin|),
    # the twin's products under float32_products, and no further from the float32 function's gradient than 1.5
    # times the twin's with full float32 products
    def grads_of(fn, args, seed=7):
        args = [a.detach().requires_grad_(a.dtype.is_floating_point) for a in args]
        out = fn(*args)
        g = torch.Generator(device=dev).manual_seed(seed)
        out.backward(torch.randn(out.shape, generator=g, device=dev).to(out.dtype))
        return [a.grad for a in args]

    def grad_rules(name, kernel_fn, twin_fn, args, dtype):
        got = grads_of(kernel_fn, args)
        with _dtype.float32_products(dtype):
            ref = grads_of(twin_fn, args)
        worst = max(scaled_err(a, b) for a, b in zip(got, ref))
        require(all(a.dtype == b.dtype and a.shape == b.shape for a, b in zip(got, ref)), f"{name}: gradient dtypes")
        require(worst <= (1e-5 if dtype == torch.float32 else 1e-2), f"{name} {dtype}: gradients {worst:.3e} off")
        ratio = None
        if dtype == torch.bfloat16:
            with _dtype.full_float32():
                full = grads_of(twin_fn, args)
                truth = grads_of(twin_fn, [a.float() for a in args])
            ratio = max(float((a.double() - t.double()).norm()) / max(float((f.double() - t.double()).norm()), 1e-30)
                        for a, f, t in zip(got, full, truth))
            require(ratio <= 1.5, f"{name}: gradients stray {ratio:.3f} times as far from float32 as the twin's")
        print(f"{name} {dtype} gradients: max |a - twin| / (1 + |twin|) {worst:.3e}"
              + ("" if ratio is None else f", distance from float32 {ratio:.3f} of the twin's"))

    for dtype in (torch.float32, bf):
        cn_args = [bnormal((2 * 56 * 56, 96), dtype), bnormal((2 * 56 * 56, 96), dtype),
                   bnormal((96,), torch.float32, 0.2, 1.0), bnormal((96,), torch.float32, 0.1),
                   bnormal((96, 384), dtype, 96 ** -0.5), bnormal((384,), torch.float32, 0.1),
                   bnormal((384, 96), dtype, 384 ** -0.5), bnormal((96,), torch.float32, 0.1),
                   bnormal((96,), torch.float32, 0.5)]
        grad_rules("cn_mlp_block (row 12)", kernels.cn_mlp_block, transformer_block.cn_mlp_block_plain, cn_args, dtype)
        win_mask = torch.where(torch.rand((64, 49, 49), generator=bgen, device=dev) < 0.3, -100.0, 0.0)
        win = [bnormal((128, 49, 96), dtype), bnormal((96,), torch.float32, 0.2, 1.0), bnormal((96,), torch.float32, 0.1),
               bnormal((96, 288), dtype, 96 ** -0.5), bnormal((288,), torch.float32, 0.1), bnormal((96, 96), dtype, 96 ** -0.5),
               bnormal((96,), torch.float32, 0.1), bnormal((3, 49, 49), torch.float32, 0.3)]
        grad_rules("window_attention_block v1 masked (row 13)",
                   lambda *a: kernels.window_attention_block(*a, win_mask, None, 3, 32 ** -0.5, 1e-5, False, 64),
                   lambda *a: swin_attention.window_attention_block_plain(*a, win_mask, None, 3, 32 ** -0.5, 1e-5, False, 64),
                   win, dtype)
        dw_args = [bnormal((4, 56, 56, 96), dtype), bnormal((7, 7, 96), dtype, 1.0 / 7), bnormal((96,), torch.float32)]
        grad_rules("depthwise_conv2d 7x7 (row 14)", kernels.depthwise_conv2d, depthwise.depthwise_conv2d_plain, dw_args,
                   dtype)
        del cn_args, win, dw_args, win_mask

    # the backward kernels at every shape the Swin and ConvNeXt training paths gave them, on inputs drawn as the ViT
    # training rows below draw theirs, against their plain versions by those rows' rules.  The token count M gives
    # the stage's width c and the MLP's products follow: du·[w1ᵀ; w1ᵀ] over 8c into c columns, hᵀ·du over c into 8c,
    # aᵀ·g over 4c into c, or into 3c beside the layer scale's products (ConvNeXt); LN's residual gradient is Swin's
    sc_plain = {"mlp_gelu_backward": mlp_gelu_backward_plain, "ln_backward_rows": ln_backward_plain,
                "bf16_product": bf16_product_plain, "wgrad_matmul": wgrad_matmul_plain}
    width_at, sc_held = {128 * side * side: c for c, side in zip(widths, sides)}, set()
    for path in (SWIN_TRAIN, SWIN_TRAIN_SD0, CN_TRAIN):
        for name, plain_fn in sc_plain.items():
            for (m_, k_), dtype in path_shapes[path][name]:
                c, bf = width_at[m_], torch.bfloat16
                n_ = {"bf16_product": k_ // 8, "wgrad_matmul": 8 * c if k_ == c else 3 * c if path == CN_TRAIN else c,
                      "ln_backward_rows": path != CN_TRAIN}.get(name)
                if (name, m_, k_, n_) in sc_held:
                    continue
                sc_held.add((name, m_, k_, n_))
                with drawing_from(train_draws):
                    if name == "mlp_gelu_backward":
                        args = [normal((m_, k_), dtype), normal((m_, k_), dtype, 2.0), normal((k_,), dtype, 0.3)]
                    elif name == "ln_backward_rows":
                        args = [normal((m_, k_), bf), normal((k_,), torch.float32, 0.2, 1.0), normal((m_, k_), bf),
                                normal((m_, k_), bf) if n_ else None]
                    elif name == "bf16_product":
                        args = [normal((m_, k_), bf), normal((k_, n_), bf, k_ ** -0.5), torch.zeros(n_, device=dev)]
                    else:
                        args = [normal((m_, k_), bf), normal((m_, n_), bf)]
                got, ref = getattr(kernels, name)(*args), plain_fn(*args)
                what = f"{name} {[m_, k_]} {dtype} (Swin/ConvNeXt training)"
                if name == "mlp_gelu_backward":
                    exact(got[0], ref[0], what + ": du")
                    exact(got[1], ref[1], what + ": the activations")
                    err = max_err_f32(got[2], ref[2], what + ": db1", 1e-5 * (1 + float(ref[2].abs().max())), 1e-5)
                elif name == "ln_backward_rows":
                    err = max(max_err_f32(got[0], ref[0], what + ": dx", TOL[bf], TOL[bf]),
                              *(max_err_f32(a, b, what + ": d ln_g / d ln_b", 1e-5 * (1 + float(b.abs().max())), 1e-5)
                                for a, b in zip(got[1:], ref[1:])))
                elif name == "bf16_product":
                    err = max_err_f32(got, ref, what, TOL[bf], TOL[bf])
                else:
                    err = float((got - ref).abs().max())
                    require(err <= WGRAD_TOL * float(ref.abs().max()), f"{what}: max |err| {err}")
                hold(name, (m_, k_), dtype, err, path="swin/convnext training",
                     **({"resid": n_} if name == "ln_backward_rows" else {} if n_ is None else {"n": n_}))
                del args, got, ref

    # every shape that a training path handed to a kernel was held above
    held_at = {(r["name"], tuple(r["shape"]), r["dtype"]) for r in held}
    for r in rows:
        held_at |= {(r["name"], tuple(at["shape"]), at.get("dtype")) for at in (r, *r.get("other_shapes", ()))
                    if "shape" in at and isinstance(at["shape"][0], int)}
    for path in (VIT_TRAIN, SWIN_TRAIN, SWIN_TRAIN_SD0, CN_TRAIN):
        for name in ("attention_block", "mlp_block", "attention_core_backward", "mlp_gelu_backward", "ln_backward_rows",
                     "bf16_product", "wgrad_matmul"):
            for shape, dtype in path_shapes[path][name]:
                require((name, shape, str(dtype).replace("torch.", "")) in held_at,
                        f"{path}: {name} ran on {shape} {dtype}, which was not held against its twin")
    require(set(path_shapes[CNN_TRAIN]["fused_conv3x3_relu_pool"]) == set(path_shapes[cnn[28][2]]["fused_conv3x3_relu_pool"]),
            f"{CNN_TRAIN}: the fused stage ran at shapes that the CNN rows did not hold")

    # every shape that a Swin or ConvNeXt main path handed to one of these four wrappers was held above
    new_kernels = ("mlp_block", "cn_mlp_block", "window_attention_block", "depthwise_conv2d")
    checked = {(r["name"], tuple(r["shape"]), r["dtype"]) for r in held}
    for r in rows:
        if r["name"] in new_kernels:
            checked |= {(r["name"], tuple(at["shape"]), at["dtype"]) for at in (r, *r["other_shapes"])}
    for path in (SWIN, SWIN_V2, SWIN_PADDED, SWIN_F32, CN, CN_STOCK, SWIN_TRAIN, SWIN_TRAIN_SD0, CN_TRAIN):
        for name in new_kernels:
            for shape, dtype in path_shapes[path][name]:
                require((name, shape, str(dtype).replace("torch.", "")) in checked,
                        f"{path}: {name} ran on {shape} {dtype}, which was not held against its twin")
    # and every shape that a ViT-H/14 path handed to its two kernels
    for path in ("vit_h_14 bf16 b64", "vit_h_14 f32 b16"):
        for name in ("flash_mha", "mlp_block", "attention_block"):
            for shape, dtype in path_shapes[path][name]:
                require((name, shape, str(dtype).replace("torch.", "")) in held_at,
                        f"{path}: {name} ran on {shape} {dtype}, which was not held against its twin")
    # and every shape that a detection path handed to nms_sorted
    held_nms = {tuple(r["shape"]) for r in (nms_entry, *nms_entry["other_shapes"])}
    for path in (DET_BF16, DET_F32, DET_V2):
        for shape, dtype in path_shapes[path]["nms_sorted"]:
            require(shape in held_nms and dtype == torch.float32,
                    f"{path}: nms_sorted ran on {shape} {dtype}, which was not held against its twin")

    require(len(rows) == 23 and len({r["name"] for r in rows}) == 22 and all(r["launches"] >= 1 for r in rows),
            "twenty-three entries of twenty-two wrappers, each launched on a main path")
    print(f"training, ms a step: vit_b_16 bf16 b128 kernel routes {vit_train_ms[0]:.1f}, plain routes "
          f"{vit_train_ms[1]:.1f}; resnet50 b128 bf16 {r50_train_ms[0]:.1f}, f32 {r50_train_ms[1]:.1f}; "
          + "; ".join(f"{label} kernel routes {np.mean(r['kernel']['ms'][1:]):.1f}, plain routes "
                      f"{np.mean(r['plain']['ms'][1:]):.1f} (card's clock)" for label, r in sc_summary.items())
          + f" ({card})")
    print(json.dumps({"kernels": rows, "held_untimed": held}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
