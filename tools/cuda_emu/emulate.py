#!/usr/bin/env python3
"""Run the port's transformer (and the bf16 blocks' backward), window
attention, depthwise, NMS, int8, weight-gradient, fused convolution and stencil
kernels on the CPU, with no card and no ``nvcc``.

The sources ``cpu_vision_tpu_torch/csrc/attention.cu``, ``transformer_block.cu``,
``swin_attention.cu``, ``depthwise.cu``, ``nms.cu``, ``int8_matmul.cu``,
``int8_transformer.cu``, ``wgrad_matmul.cu``, ``conv_block.cu`` and ``stencil.cu``
(with the ``.cuh`` headers) are rewritten a little,
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
self-check of the kernels against their plain twins.

Covered: ``__global__`` templates, ``threadIdx``/``blockIdx``, ``__syncthreads``,
``__syncthreads_or``, ``__syncwarp``, the shuffles ``__shfl_sync``, ``__shfl_xor_sync``, ``__shfl_up_sync`` and
``__shfl_down_sync`` on 4-byte values, ``__ballot_sync``, ``__any_sync``, ``__reduce_or_sync``, ``__brev``,
``__ffsll``, ``__funnelshift_l`` and ``__funnelshift_r``, dynamic shared memory
declared as ``extern __shared__ [__align__(16)] T name[];`` of any type T,
static ``__shared__`` arrays,
``float4``, ``int4``, ``uint4`` (``make_uint4``), ``__int2float_rn``, ``__float_as_int``, ``__fmul_rn`` and its kin,
``__double2float_rn``, ``__nv_bfloat16`` with its conversions (a pair too),
``cudaFuncSetAttribute``, ``cudaFuncGetAttributes`` and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (stubs: no
registers, one block an SM),
``blockDim``, ``gridDim``, the ``<<<...>>>`` launch, ``make_float4``, and the functions of ``csrc/hopper.cuh`` (``cp.async``
of 16 and 4 bytes, ``wgmma`` of bf16 and of tf32, ``cvt.rna.tf32.f32``; the stand-in ``hopper.cuh`` here replaces that
header).  Not covered: everything else; extend the headers as a source needs.  The CPU twins of the blur+Sobel
and Canny kernels take ``torch.sqrt``, which on the CPU may differ from the correctly rounded square root in the last
bit: hold those to the twins on the card, or to the twins with a root taken in float64 and rounded (Canny's
``root``).
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
STEMS = ("attention", "transformer_block", "swin_attention", "depthwise", "nms", "int8_matmul", "int8_transformer",
         "wgrad_matmul", "conv_block", "stencil")
EMU_SMS = 132  # the SM count the wrappers read, as an H100's

_DYNAMIC_SHARED = re.compile(r"extern __shared__ (__align__\(\d+\) )?(\w+) (\w+)\[\];")
_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;(]*>)?)<<<([^;]*?)>>>\(([^;]*?)\);", re.S)


def translate(text: str) -> str:
    """CUDA C++ of the covered subset as C++ for the stand-in headers."""
    text = _DYNAMIC_SHARED.sub(r"\2* \3 = reinterpret_cast<\2*>(emu_shared);", text)
    text = text.replace("__shared__", "static")
    return _LAUNCH.sub(r"emu_launch(\2, [=] { \1(\3); });", text)


def compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the emulation needs a C++20 compiler")
    return found


def build(build_dir, stems=STEMS) -> Path:
    """Translate and compile ``stems`` (all of ``STEMS`` by default) into ``build_dir``; returns it."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        if not (HERE / header.name).exists():  # a stand-in here (hopper.cuh) takes the header's place
            (build_dir / header.name).write_text(translate(header.read_text()))
    jobs = []
    for stem in stems:
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
def kernels_on_cpu(build_dir, stems=STEMS) -> Iterator[None]:
    """Inside, the wrappers of ``flash_attention``, ``transformer_block``,
    ``swin_attention``, ``depthwise``, ``nms``, ``int8_matmul``, ``int8_transformer`` and ``wgrad_matmul`` take CPU
    tensors through the emulated CUDA sources instead of the twins.
    Builds ``stems`` (all by default; a wrapper of a source left out fails to load) into ``build_dir`` unless the
    libraries are there already."""
    sys.path.insert(0, str(REPO))
    import importlib
    import types

    import torch
    from cpu_vision_tpu_torch.ops.kernels import (_build, conv_block, depthwise, flash_attention, int8_matmul,
                                                  int8_transformer, nms, stencil, swin_attention, transformer_block)

    wgrad = importlib.import_module("cpu_vision_tpu_torch.ops.kernels.wgrad_matmul")  # the package exports its function
    modules = (flash_attention, transformer_block, swin_attention, depthwise, nms, int8_matmul, int8_transformer, wgrad,
               conv_block, stencil)

    build_dir = Path(build_dir)
    if not all((build_dir / f"lib{stem}.so").exists() for stem in stems):
        build(build_dir, stems)

    def launch(lib, name, x, *args):
        err = getattr(lib, name)(*args, None)
        if err != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")

    saved = (_build.load, _build.on_card, _build.launch, torch.cuda.get_device_properties)
    _build.load = lambda stem: ctypes.CDLL(str(build_dir / f"lib{stem}.so"))
    _build.on_card = lambda x: True
    _build.launch = launch
    torch.cuda.get_device_properties = lambda device: types.SimpleNamespace(multi_processor_count=EMU_SMS)
    for module in modules:
        module._c_lib = None
    try:
        yield
    finally:
        _build.load, _build.on_card, _build.launch, torch.cuda.get_device_properties = saved
        for module in modules:
            module._c_lib = None


def main() -> int:
    import tempfile

    import torch

    sys.path.insert(0, str(REPO))
    from cpu_vision_tpu_torch.ops import kernels
    from cpu_vision_tpu_torch.ops.kernels import conv_block, stencil, swin_attention

    gen = torch.Generator().manual_seed(0)
    yardsticks = {}  # name: float64 result of the float32 v2 window blocks (split-TF32 products at logit scale 100)

    def normal(shape, dtype, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen) * std + mean).to(dtype)

    worst = 0.0
    with tempfile.TemporaryDirectory() as tmp, kernels_on_cpu(tmp):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            pairs = []
            for hd in (16, 64):  # bf16 at head dim 64: the tensor-core core, two key tiles, the second with 6 keys
                q, k, v = (normal((1, 70, 2, hd), dtype) for _ in range(3))
                pairs.append((f"flash_mha hd {hd}", kernels.flash_mha(q, k, v, 0.25),
                              kernels.flash_mha_plain(q, k, v, 0.25)))
            d, dh = 256, 512  # four heads of 64
            ln = (normal((d,), torch.float32, 0.2, 1.0), normal((d,), torch.float32, 0.1))
            attn = (normal((2, 37, d), dtype), *ln, normal((d, 3 * d), dtype, d ** -0.5), normal((3 * d,), torch.float32, 0.1),
                    normal((d, d), dtype, d ** -0.5), normal((d,), torch.float32, 0.1), 4, 0.125)
            pairs.append(("attention_block", kernels.attention_block(*attn), kernels.attention_block_plain(*attn)))
            mlp = (normal((37, d), dtype), *ln, normal((d, dh), dtype, d ** -0.5), normal((dh,), torch.float32, 0.1),
                   normal((dh, d), dtype, dh ** -0.5), normal((d,), torch.float32, 0.1))
            pairs.append(("mlp_block", kernels.mlp_block(*mlp), kernels.mlp_block_plain(*mlp)))
            # D 96 with a hidden dim of 256 + 128, post_norm, ln_count, the ConvNeXt tail; D 1536 at 16 rows a block
            d, dh = 96, 384
            ln = (normal((d,), torch.float32, 0.2, 1.0), normal((d,), torch.float32, 0.1))
            mlp = (normal((41, d), dtype), *ln, normal((d, dh), dtype, d ** -0.5), normal((dh,), torch.float32, 0.1),
                   normal((dh, d), dtype, dh ** -0.5), normal((d,), torch.float32, 0.1))
            for kw in ({}, {"post_norm": True}, {"ln_count": 80}, {"post_norm": True, "ln_count": 80}):
                pairs.append((f"mlp_block D 96 {kw}", kernels.mlp_block(*mlp, 1e-5, **kw),
                              kernels.mlp_block_plain(*mlp, 1e-5, **kw)))
            cn = (mlp[0], normal((41, d), dtype), *mlp[1:], normal((d,), torch.float32, 0.5))
            pairs.append(("cn_mlp_block", kernels.cn_mlp_block(*cn), kernels.cn_mlp_block_plain(*cn)))
            d, dh = 1536, 256
            mlp = (normal((19, d), dtype), normal((d,), torch.float32, 0.2, 1.0), normal((d,), torch.float32, 0.1),
                   normal((d, dh), dtype, d ** -0.5), normal((dh,), torch.float32, 0.1),
                   normal((dh, d), dtype, dh ** -0.5), normal((d,), torch.float32, 0.1))
            pairs.append(("mlp_block D 1536", kernels.mlp_block(*mlp), kernels.mlp_block_plain(*mlp)))
            # window attention: 2 heads of 32, 49 tokens (2 images of 2 windows) or 64; v1/v2, with and without mask
            c, heads, nw_img = 64, 2, 2
            for v2, masked, s_len, nw in ((False, False, 49, 4), (False, True, 49, 4), (True, False, 49, 4),
                                          (True, True, 49, 4), (True, False, 64, 2)):
                mask = (normal((nw_img, s_len, s_len), torch.float32) > 0.5).float() * -100.0 if masked else None
                swin = (normal((nw, s_len, c), dtype), normal((c,), torch.float32, 0.2, 1.0),
                        normal((c,), torch.float32, 0.1), normal((c, 3 * c), dtype, c ** -0.5),
                        normal((3 * c,), torch.float32, 0.1), normal((c, c), dtype, c ** -0.5),
                        normal((c,), torch.float32, 0.1), normal((heads, s_len, s_len), torch.float32, 0.3), mask,
                        torch.tensor([4.7, -1.0]) if v2 else None, heads, 32 ** -0.5, 1e-5, v2, nw_img,
                        48 if masked else 0)
                pairs.append((f"window_attention_block S {s_len} v2={v2} masked={masked}",
                              kernels.window_attention_block(*swin), kernels.window_attention_block_plain(*swin)))
                if dtype == torch.float32 and v2:
                    yardsticks[pairs[-1][0]] = swin_attention._window_attention_block_f64(*swin)
            for ks in (3, 5, 7):
                dw = (normal((2, 9, 19, 40), dtype), normal((ks, ks, 40), dtype, 1.0 / ks), normal((40,), torch.float32))
                pairs.append((f"depthwise_conv2d {ks}x{ks}", kernels.depthwise_conv2d(*dw, use_bias=ks != 5),
                              kernels.depthwise_conv2d_plain(*dw, use_bias=ks != 5)))
            if dtype == torch.float32:  # NMS: fields sparse and crowded, N off the tile of 32, identical boxes
                for p, n, extent, thr in ((3, 70, 100.0, 0.5), (2, 300, 20.0, 0.3), (1, 33, 5.0, 0.7), (2, 129, 8.0, 0.5)):
                    ctr, wh = torch.rand((p, n, 2), generator=gen) * extent, torch.rand((p, n, 2), generator=gen) * 15 + 1
                    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
                    boxes[0, 5:9] = boxes[0, 4]
                    pairs.append((f"nms_sorted {p}x{n} thr {thr}", kernels.nms_sorted(boxes, thr).float(),
                                  kernels.nms_sorted_plain(boxes, thr).float()))
            if dtype == torch.float32:  # int8: the requantising product, ragged M, N and K off 32; the two sub-blocks
                for m, k, n in ((300, 96, 200), (130, 16, 7)):
                    qx = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
                    qw = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
                    sc, bias = torch.rand(n, generator=gen) * 1e-2 + 1e-3, torch.rand(n, generator=gen) - 0.5
                    for relu, out_scale in ((False, None), (True, torch.tensor(0.05))):
                        pairs.append((f"int8_matmul_requant {m}x{k}x{n} relu={relu}",
                                      kernels.int8_matmul_requant(qx, qw, sc, bias, out_scale, relu).float(),
                                      kernels.int8_matmul_requant_plain(qx, qw, sc, bias, out_scale, relu).float()))
            d, dh = 256, 512
            ln = (normal((d,), torch.float32, 0.2, 1.0), normal((d,), torch.float32, 0.1))
            a1, a2, ao = (torch.rand(w, generator=gen) * 0.02 + 0.01 for w in (d, dh, d))
            qw1, s1 = kernels.quantize_weight(normal((d, dh), torch.float32, d ** -0.5) * a1[:, None])
            qw2, s2 = kernels.quantize_weight(normal((dh, d), torch.float32, dh ** -0.5) * a2[:, None])
            mlp8 = (normal((45, d), dtype), *ln, qw1, s1, normal((dh,), torch.float32, 0.1), qw2, s2,
                    normal((d,), torch.float32, 0.1), a1, a2)
            pairs.append(("mlp_block_int8", kernels.mlp_block_int8(*mlp8), kernels.mlp_block_int8_plain(*mlp8)))
            qwqkv, sqkv = kernels.quantize_weight(normal((d, 3 * d), torch.float32, d ** -0.5) * a1[:, None])
            qwo, so = kernels.quantize_weight(normal((d, d), torch.float32, d ** -0.5) * ao[:, None])
            attn8 = (normal((2, 33, d), dtype), *ln, qwqkv, sqkv, normal((3 * d,), torch.float32, 0.1), qwo, so,
                     normal((d,), torch.float32, 0.1), a1, ao, 4, 0.125)
            pairs.append(("attention_block_int8", kernels.attention_block_int8(*attn8),
                          kernels.attention_block_int8_plain(*attn8)))
            for m, cin, cout in ((1000, 70, 65), (300, 3, 5), (40, 64, 64)):  # slabs, ragged tiles, one slab
                x, dy = normal((m, cin), dtype), normal((m, cout), dtype)
                pairs.append((f"wgrad_matmul {m}x{cin}x{cout}", kernels.wgrad_matmul(x, dy),
                              kernels.wgrad_matmul_plain(x, dy)))
            if dtype == torch.float32:  # the fused conv stage (split TF32, Cin 3 and 40: two chunks) and Harris
                for shape, cout in (((1, 6, 20, 3), 5), ((1, 4, 6, 40), 70)):
                    xc = torch.rand(shape, generator=gen)
                    wc, bc = normal((3, 3, shape[-1], cout), dtype, 0.3), normal((cout,), dtype, 0.1)
                    pairs.append((f"fused_conv3x3_relu_pool {list(shape)} -> {cout}",
                                  kernels.fused_conv3x3_relu_pool(xc, wc, bc),
                                  conv_block.fused_conv3x3_relu_pool_plain(xc, wc, bc)))
                maps = torch.rand((2, 70, 140), generator=gen)
                pairs.append(("harris_response_fused 2x70x140", kernels.harris_response_fused(maps[..., None])[..., 0],
                              stencil.harris_response_fused_plain(maps, stencil.gaussian_taps(5, 1.0), 0.04)))
                # Canny's two kernels: the strip kernel against the twin with a correctly rounded root, and the
                # sweeps on bit masks (rows of 16-byte chunks at W 1920, byte loads at W 140) with their flags
                root = lambda v: torch.sqrt(v.double()).float()  # noqa: E731
                cls = stencil.canny_stage1_plain(maps, stencil.gaussian_taps(5, 1.4), 0.05, 0.2, root=root)
                pairs.append(("canny_stage1 2x70x140", kernels.canny_stage1(maps, 0.05, 0.2), cls))
                for cmap in (cls, stencil.canny_stage1_plain(torch.rand((1, 9, 1920), generator=gen),
                                                             stencil.gaussian_taps(5, 1.4), 0.05, 0.2)):
                    flags = torch.zeros(2, dtype=torch.int32)
                    swept = kernels.hysteresis_sweeps(cmap, 4, changed=flags[:1], last_changed=flags[1:])
                    before, twin = stencil._sweeps_plain(cmap, 4)
                    twin_flags = torch.tensor([bool((twin != cmap).any()), bool((twin != before).any())]).int()
                    pairs.append((f"hysteresis_sweeps x4 {list(cmap.shape)} and flags",
                                  torch.cat([swept.flatten(), flags]), torch.cat([twin.flatten(), twin_flags])))
            for name, out, ref in pairs:
                err = (out.float() - ref.float()).abs()
                note = ""
                if name.startswith("wgrad_matmul"):  # the weight gradient's rule on the card: 1e-5 max |twin|
                    ok = float(err.max()) <= 1e-5 * float(ref.abs().max())
                elif name.startswith(("harris", "canny", "hysteresis")):  # bit for bit, as on the card
                    ok = torch.equal(out, ref)
                elif name.startswith("fused_conv"):  # the conv stage's rule
                    ok = bool((err <= 1e-5 + 1e-5 * ref.abs()).all())
                elif dtype == torch.float32 and name in yardsticks:
                    # the float32 v2 window blocks, held as on the card: within 2e-4 (1 + |twin|) of the twin and no
                    # further from float64 than twice the twin (at v2's logit scale 100 the split-TF32 kernel and the
                    # twin stray from float64 about alike, in different directions, past this check's 2e-5 of each
                    # other); attention_block and the v1 window blocks keep the 2e-5 rule
                    ref64 = yardsticks[name]
                    far = [float((a.double() - ref64).abs().max() / ref64.abs().max()) for a in (out, ref)]
                    ok = bool((err <= 2e-4 + 2e-4 * ref.abs()).all()) and far[0] <= 2 * far[1]
                    note = f", from float64 {far[0]:.3e} (twin {far[1]:.3e})"
                else:
                    ok = bool((err <= tol + tol * ref.float().abs()).all())
                print(f"{name} {dtype}: max |err| {float(err.max()):.3e}{note} {'ok' if ok else 'FAILED'}")
                worst = max(worst, 0.0 if ok else 1.0)
    return int(worst)


if __name__ == "__main__":
    sys.exit(main())
