"""Post-training int8 serving of the ResNet family: ``Int8ResNet``.

Counterpart of the JAX package's ``models/quantization_resnet.py``:

* each batch norm is folded into its convolution's kernel (eps 1e-5) before
  per-output-channel symmetric int8 quantisation of the kernel, so the batch
  norm's scale is absorbed exactly and its shift becomes a bias;
* every convolution is int8 x int8 summed exactly in int32, then
  ``acc * (in_scale * w_scale) + bias`` in float32, ReLU, and requantisation to
  the next site's static scale, ``clip(rint(f * (1 / s)), -127, 127)`` (a
  product by the inverse, never a division: ``f / s`` and ``f * (1 / s)`` differ
  in the last bit near a rounding half, enough to flip an int8 value), so the
  tensors between layers are int8;
* the residual add requantises each branch to its own scale first and adds the
  two rescaled branches in float32 (the TFLite recipe); the int8 max pool pads
  with -128 (requantisation is monotone, so pooling int8 values is exact);
* scales come from a calibration pass of the same graph in float32
  (``calibrate``), recording max |x| at every requantisation site; scales are
  max(amax, 1e-8) / 127, one a site.

Convolutions.  1x1, padding-0, ungrouped convolutions (the bottlenecks' and
the downsamples') take ``conv1x1``'s route: ``None`` (the default) or
``"kernel"``, ``ops.kernels.int8_matmul_requant``, the product and its
epilogue in one kernel (a stride is a spatial slice first); ``"stock"``, the
route of every other convolution: patches gathered with ``Tensor.unfold`` and
multiplied with ``torch._int_mm`` (``int8_matmul.int_mm``; one product a group
for ResNeXt), then the epilogue as stock operators.  Both routes run the same
float32 operations in the same order on exact sums, so their logits agree bit
for bit.  ``None`` takes the kernel where it takes the input's channels (a
multiple of 16) and the stock route elsewhere, a decision by shape.  The 7x7
stride-2 stem runs as a space-to-depth and a 4x4 stride-1 convolution
(``use_s2d2_stem``, a permutation of the int8 kernel, exact); ``bf16_epilogue``
carries the pre-requantisation activations of the stock route in bfloat16
(off, as in the JAX package).  The JAX package runs its 1x1 kernel only when
asked (``use_pallas``); here it is the default.

Usage::

    eng = Int8ResNet.from_model(model)   # a models.ResNet
    eng.calibrate(batches)               # static activation scales
    logits = eng(images)                 # (N, H, W, 3) float32, NHWC
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .._dtype import full_float32
from .._layout import as_tensor
from ..ops.kernels import int8_matmul as _mm
from ..ops.kernels.int8_transformer import quantize_weight

__all__ = ["Int8ResNet"]

BN_EPS = 1e-5
CONV1X1_ROUTES = ("kernel", "stock")


def _s2d2_kernel(qw: torch.Tensor) -> torch.Tensor:
    """A 7x7 stride-2 pad-3 HWIO kernel as the equivalent 4x4 stride-1
    pad-(2, 1) kernel over the 2x2 space-to-depth input:
    ``k2[a, b, (dy * 2 + dx) * C + c, o] = w[2a + dy - 1, 2b + dx - 1, c, o]``
    (zero out of range), a permutation of the int8 weights."""
    kh, kw, cin, cout = qw.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expects a 7x7 kernel, got {(kh, kw)}")
    k2 = torch.zeros((4, 4, 4 * cin, cout), dtype=qw.dtype, device=qw.device)
    for a in range(4):
        for b in range(4):
            for dy in range(2):
                for dx in range(2):
                    ky, kx = 2 * a + dy - 1, 2 * b + dx - 1
                    if 0 <= ky < 7 and 0 <= kx < 7:
                        ch = (dy * 2 + dx) * cin
                        k2[a, b, ch:ch + cin] = qw[ky, kx]
    return k2


def _s2d2(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def _conv_i8(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Tuple[int, int], groups: int) -> torch.Tensor:
    """The exact int32 convolution of int8 NHWC ``x`` with an int8 HWIO ``w``,
    ``pads`` = (before, after) on both spatial axes: patches by
    ``Tensor.unfold``, products by ``int8_matmul.int_mm``, one a group."""
    kh, kw, ci, co = w.shape
    if pads != (0, 0):
        x = F.pad(x, (0, 0, pads[0], pads[1], pads[0], pads[1]))
    n = x.shape[0]
    if (kh, kw) == (1, 1):
        x = x[:, ::stride, ::stride]
        ho, wo = x.shape[1:3]
        patches = x.reshape(n * ho * wo, groups, ci)
    else:
        p = x.unfold(1, kh, stride).unfold(2, kw, stride)  # (n, ho, wo, C, kh, kw)
        ho, wo = p.shape[1:3]
        patches = p.reshape(n, ho, wo, groups, ci, kh, kw).permute(0, 1, 2, 3, 5, 6, 4).reshape(
            n * ho * wo, groups, kh * kw * ci)
    wg = w.reshape(kh, kw, ci, groups, co // groups).permute(3, 0, 1, 2, 4).reshape(groups, kh * kw * ci, -1)
    acc = torch.cat([_mm.int_mm(patches[:, g], wg[g]) for g in range(groups)], dim=1)
    return acc.reshape(n, ho, wo, co)


def _maxpool(x: torch.Tensor, pad_value: float) -> torch.Tensor:
    """3x3 stride-2 max pool of NHWC ``x`` padded by 1 with ``pad_value``, in x's dtype."""
    x = F.pad(x, (0, 0, 1, 1, 1, 1), value=pad_value)
    return x.unfold(1, 3, 2).unfold(2, 3, 2).amax(dim=(-2, -1))


class _ConvSpec:
    """One folded convolution: int8 HWIO kernel, its scales, the batch norm's bias."""

    def __init__(self, conv, bn):
        s = bn.weight.detach().float() / torch.sqrt(bn.running_var.detach().float() + BN_EPS)
        hwio = conv.weight.detach().float().permute(2, 3, 1, 0)
        self.kernel_f = (hwio * s).contiguous()  # the calibration graph's
        self.qw, self.w_scale = quantize_weight(self.kernel_f)
        self.bias = bn.bias.detach().float() - bn.running_mean.detach().float() * s
        self.stride, self.pad, self.groups = conv.stride[0], conv.padding[0], conv.groups
        if conv.dilation != (1, 1) or conv.stride[0] != conv.stride[1] or conv.padding[0] != conv.padding[1]:
            raise NotImplementedError("the int8 engine takes square strides and paddings and no dilation")
        kh, kw, ci, co = self.qw.shape
        self.is_1x1 = (kh, kw) == (1, 1) and self.pad == 0 and self.groups == 1
        # the kernel's (Cin, Cout) operand, stored transposed as it reads it
        self.qw_mat = self.qw.reshape(ci, co).t().contiguous().t() if self.is_1x1 else None
        self.qw_s2d2 = (_s2d2_kernel(self.qw) if (kh, kw) == (7, 7) and self.stride == 2 and self.pad == 3
                        else None)


class Int8ResNet:
    """See the module docstring.  Built by :meth:`from_model`."""

    def __init__(self, convs: Dict[str, _ConvSpec], fc_weight: torch.Tensor, fc_bias: torch.Tensor,
                 topology: List[Tuple[str, List[str], bool]], conv1x1: Optional[str] = None,
                 use_s2d2_stem: bool = True):
        if conv1x1 not in (None, *CONV1X1_ROUTES):
            raise ValueError(f"conv1x1 is None or one of {CONV1X1_ROUTES}, got {conv1x1!r}")
        self.convs = convs
        self.fc_kernel = fc_weight.detach().float().t().contiguous()  # (in, out)
        self.fc_bias = fc_bias.detach().float().clone()
        self.fc_qw, self.fc_w_scale = quantize_weight(self.fc_kernel)
        self.topology = topology  # [(block name, conv names, has a downsample)]
        self.scales: Optional[Dict[str, torch.Tensor]] = None
        self.conv1x1 = conv1x1
        self.use_s2d2_stem = use_s2d2_stem
        self.bf16_epilogue = False

    @staticmethod
    def from_model(model, conv1x1: Optional[str] = None, use_s2d2_stem: bool = True) -> "Int8ResNet":
        """The engine of a ``models.ResNet`` (basic or bottleneck blocks, grouped
        or not), on its device.  Blocks and sites are named as in the JAX
        engine: ``layer{i}_{j}``, its convolutions ``/c0``, ``/c1``, ``/c2``."""
        if model.fc is None:
            raise ValueError("the int8 engine classifies: the model needs its fc")
        convs = {"stem": _ConvSpec(model.conv1, model.bn1)}
        topology = []
        for i in range(1, 5):
            for j, block in enumerate(getattr(model, f"layer{i}")):
                name = f"layer{i}_{j}"
                pairs = [(block.conv1, block.bn1), (block.conv2, block.bn2)]
                if hasattr(block, "conv3"):
                    pairs.append((block.conv3, block.bn3))
                names = []
                for k, (conv, bn) in enumerate(pairs):
                    names.append(f"{name}/c{k}")
                    convs[names[-1]] = _ConvSpec(conv, bn)
                if block.downsample is not None:
                    convs[f"{name}/down"] = _ConvSpec(block.downsample[0], block.downsample[1])
                topology.append((name, names, block.downsample is not None))
        return Int8ResNet(convs, model.fc.weight, model.fc.bias, topology, conv1x1, use_s2d2_stem)

    # ------------------------------------------------------------ the graph

    def _requant(self, f: torch.Tensor, site: str) -> torch.Tensor:
        return _mm.quantize_i8(f.float(), 1.0 / self.scales[site])

    def _takes_kernel(self, spec: _ConvSpec, q: torch.Tensor) -> bool:
        if not spec.is_1x1 or self.conv1x1 == "stock":
            return False
        return self.conv1x1 == "kernel" or _mm.kernel_takes(q.shape[-1])

    def _conv1x1(self, q: torch.Tensor, spec: _ConvSpec, in_scale: torch.Tensor, site: str, relu: bool):
        """A 1x1 convolution through the requantising kernel: int8 in, int8 out."""
        if spec.stride > 1:
            q = q[:, ::spec.stride, ::spec.stride]
        n, h, w, cin = q.shape
        out = _mm.int8_matmul_requant(q.reshape(-1, cin), spec.qw_mat, in_scale * spec.w_scale, spec.bias,
                                      out_scale=self.scales[site], relu=relu)
        return out.reshape(n, h, w, -1)

    def _conv(self, q: torch.Tensor, spec: _ConvSpec, in_scale: torch.Tensor) -> torch.Tensor:
        """The stock route's float32 epilogue tensor ``acc * (in_scale * w_scale) + bias``."""
        if (self.use_s2d2_stem and spec.qw_s2d2 is not None and spec.groups == 1
                and q.shape[1] % 2 == 0 and q.shape[2] % 2 == 0):
            acc = _conv_i8(_s2d2(q), spec.qw_s2d2, 1, (2, 1), 1)
        else:
            acc = _conv_i8(q, spec.qw, spec.stride, (spec.pad, spec.pad), spec.groups)
        out = acc.float() * (in_scale * spec.w_scale) + spec.bias
        return out.to(torch.bfloat16) if self.bf16_epilogue else out

    def _forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        sc = self.scales
        q, s = self._requant(x, "in"), sc["in"]
        q, s = self._requant(torch.relu(self._conv(q, self.convs["stem"], s)), "stem"), sc["stem"]
        q = _maxpool(q, -128)
        for name, names, has_down in self.topology:
            q_in, s_in = q, s
            for i, cname in enumerate(names):
                spec = self.convs[cname]
                inner = i < len(names) - 1
                # the block's last convolution requantises to the residual add's scale, before any ReLU
                site = cname if inner else f"{name}/main"
                if self._takes_kernel(spec, q):
                    q = self._conv1x1(q, spec, s, site, relu=inner)
                else:
                    f = self._conv(q, spec, s)
                    q = self._requant(torch.relu(f) if inner else f, site)
                s = sc[site]
            qm, sm = q, s
            if has_down:
                dspec = self.convs[f"{name}/down"]
                if self._takes_kernel(dspec, q_in):
                    qd = self._conv1x1(q_in, dspec, s_in, f"{name}/ds", relu=False)
                else:
                    qd = self._requant(self._conv(q_in, dspec, s_in), f"{name}/ds")
                sd = sc[f"{name}/ds"]
            else:
                qd, sd = q_in, s_in
            q = self._requant(torch.relu(qm.float() * sm + qd.float() * sd), name)
            s = sc[name]
        feat = (q.float() * s).mean(dim=(1, 2))
        acc = _mm.int_mm(self._requant(feat, "fc"), self.fc_qw)
        return acc.float() * (sc["fc"] * self.fc_w_scale) + self.fc_bias

    def _forward_float(self, x: torch.Tensor, sites: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The batch-norm-folded float32 graph, recording max |x| at every requantisation site."""

        def record(f, site):
            sites[site] = f.abs().max()
            return f

        def conv(f, spec):
            w = spec.kernel_f.permute(3, 2, 0, 1)  # OIHW
            out = F.conv2d(f.permute(0, 3, 1, 2), w, None, spec.stride, spec.pad, 1, spec.groups)
            return out.permute(0, 2, 3, 1) + spec.bias

        f = record(x, "in")
        f = record(torch.relu(conv(f, self.convs["stem"])), "stem")
        f = _maxpool(f, -float("inf"))
        for name, names, has_down in self.topology:
            f_in = f
            for i, cname in enumerate(names):
                inner = i < len(names) - 1
                f = conv(f, self.convs[cname])
                f = record(torch.relu(f) if inner else f, cname if inner else f"{name}/main")
            ident = record(conv(f_in, self.convs[f"{name}/down"]), f"{name}/ds") if has_down else f_in
            f = record(torch.relu(f + ident), name)
        feat = record(f.mean(dim=(1, 2)), "fc")
        return feat @ self.fc_kernel + self.fc_bias

    def _float_graph(self, x) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        sites: Dict[str, torch.Tensor] = {}
        with torch.no_grad(), full_float32():
            return self._forward_float(as_tensor(x).float(), sites), sites

    # -------------------------------------------------------------- public

    def set_scales(self, scales: Dict[str, torch.Tensor]) -> "Int8ResNet":
        """Take ``scales`` ({site: float32 scalar})."""
        self.scales = {k: v.float().reshape(()) for k, v in scales.items()}
        return self

    def calibrate(self, batches: Sequence) -> "Int8ResNet":
        """Max |x| at every requantisation site over ``batches``; scales max(amax, 1e-8) / 127."""
        amax: Dict[str, float] = {}
        device = self.fc_bias.device
        for b in batches:
            for k, v in self._float_graph(b)[1].items():
                amax[k] = max(amax.get(k, 0.0), float(v))
        return self.set_scales({k: torch.tensor(max(v, 1e-8) / 127.0, dtype=torch.float32, device=device)
                                for k, v in amax.items()})

    def float_reference(self, x) -> torch.Tensor:
        """The batch-norm-folded float32 forward of the same graph (the oracle)."""
        return self._float_graph(x)[0]

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        if self.scales is None:
            raise RuntimeError("call .calibrate(batches) before int8 inference")
        with full_float32():
            return self._forward_int8(as_tensor(x).float())
