"""Swin Transformer, v1 and v2 (reference
``torchvision/models/swin_transformer.py``): shifted-window attention with a
relative position bias, patch merging between the stages.

Counterpart of the JAX package's ``models/swin.py``: serving
(``forward(x)``, under ``no_grad``) and training (``forward(x, train=True,
generator=g)``, with stochastic depth drawn from ``g``).  Input is NHWC,
parameters are float32 under torchvision's ``state_dict`` keys (``features.0.{0,2}``, blocks
``features.{2i+1}.{j}.{norm1,attn.qkv,attn.proj,norm2,mlp.0,mlp.3}`` with
``attn.relative_position_bias_table`` (v1) or ``attn.logit_scale`` and
``attn.cpb_mlp.{0,2}`` (v2), merging ``features.{2i}.{reduction,norm}``,
``norm``, ``head``), and ``dtype`` (float32 or bfloat16) is the compute dtype
of activations and weights.  The reference's two index buffers
(``relative_position_index``, ``relative_coords_table``) are constants here and
not part of the ``state_dict``: load a torchvision checkpoint with
``strict=False``.

Window partition is reshape and transpose only, the cyclic shift is
``torch.roll``.  The window never shrinks: a map is padded up to window
multiples, and a dim whose padded size equals the window gets shift 0.

Each block's attention and MLP sub-blocks go through one of these routes,
chosen with ``attention=`` and ``mlp=`` (the counterparts of the JAX module's
``FUSED_ATTENTION`` and ``FUSED_MLP`` switches):

* ``attention="block"``: ``kernels.window_attention_block``, the whole
  sub-block; on a map that needs padding it raises (the kernel normalises
  raw windows, so padded ones are not its input);
* ``mlp="block"``: ``kernels.mlp_block`` (``post_norm`` for v2, ``ln_count``
  for the channel-padded variant), the whole sub-block;
* ``"plain"``: stock PyTorch operators only, the oracle of the other routes;
* ``None``: what the JAX package would run for the same configuration and
  batch, by a copy of its rules (``attn_fusable``, ``mlp_fusable``; a map
  that needs padding takes the plain attention route; under training a block
  is fused only where its stochastic depth is 0), where the kernel takes
  the widths: attention needs a head dim of 32 and at most 64 tokens a window
  (``swin_attention.kernel_takes``), the MLP a C in ``MLP_DIMS``
  (``transformer_block.mlp_kernel_takes``); else the plain route, by shape.

A kernel route launches its kernel on CUDA tensors, or raises where the
kernel does not take the widths (or, under training, where the block's
stochastic depth is above 0: the kernels have no branch to drop), and runs
the kernel's plain twin on CPU tensors; no route gives way to another.  What
a block derives from its parameters (the gathered (heads, S, S) bias, v2's
16·sigmoid of the position MLP, (in, out) weight copies in the compute
dtype, v2's zeroed key bias) is built once and rebuilt when a parameter
changes when serving, and inside the graph at every call under training
(``layers.Packed``).  Block ``i`` of ``total`` drops its two branches with
probability ``sd_prob · i / max(total − 1, 1)``; the draws come from
``generator`` in block order, the attention branch's before the MLP's, and
only in blocks whose probability is above 0, so two routes of one seeded
model drop the same rows.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._dtype import full_float32
from .._layout import as_tensor
from ..ops.kernels.swin_attention import kernel_takes as window_kernel_takes
from ..ops.kernels.swin_attention import window_attention_block
from ..ops.kernels.transformer_block import mlp_block, mlp_kernel_takes
from ._api import register_model
from .layers import MaskedLayerNorm, Packed, PatchifyDense, StochasticDepth, layer_norm, lecun_normal_

__all__ = ["SwinTransformer", "SwinBlock", "WindowAttention", "PatchMerging", "attn_fusable", "mlp_fusable",
           "swin_t", "swin_s", "swin_b", "swin_v2_t", "swin_v2_s", "swin_v2_b"]

ATTENTION_ROUTES = ("block", "plain")
MLP_ROUTES = ("block", "plain")
LN_EPS = 1e-5


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(windows: torch.Tensor, ws: int, n: int, h: int, w: int) -> torch.Tensor:
    x = windows.reshape(n, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, -1)


def _shift_mask(ph: int, pw: int, ws: int, shift_h: int, shift_w: int) -> torch.Tensor:
    """(nW, ws*ws, ws*ws) additive attention mask for the wrapped windows of
    a cyclic shift (reference ``swin_transformer.py:165-176``): -100 between
    tokens of different regions, 0 elsewhere."""
    img_mask = np.zeros((1, ph, pw, 1), np.float32)
    cnt = 0
    h_slices = (slice(0, -ws), slice(-ws, -shift_h), slice(-shift_h, None)) if shift_h else (slice(0, None),)
    w_slices = (slice(0, -ws), slice(-ws, -shift_w), slice(-shift_w, None)) if shift_w else (slice(0, None),)
    for hs in h_slices:
        for wsl in w_slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = _window_partition(torch.from_numpy(img_mask), ws)[..., 0]  # (nW, ws*ws)
    return torch.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)


def _relative_position_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _log_cpb_coords(ws: int) -> np.ndarray:
    """Log-spaced continuous relative coordinates (Swin v2, reference
    ``swin_transformer.py:ShiftedWindowAttentionV2``)."""
    rel = np.arange(-(ws - 1), ws, dtype=np.float32)
    ry, rx = np.meshgrid(rel, rel, indexing="ij")
    coords = np.stack([ry, rx], -1) / (ws - 1) * 8.0 if ws > 1 else np.zeros((1, 1, 2), np.float32)
    return (np.sign(coords) * np.log2(np.abs(coords) + 1.0) / 3.0).astype(np.float32)


def pick_group(nw_total: int, nw_img: int, heads: int, masked: bool) -> int:
    """The JAX package's window group of one grid step of its kernel; it
    enters that package's memory rule (``attn_fusable``) and nothing else here."""
    for g in range(min(32, max(96 // heads, 1)), 0, -1):
        if nw_total % g:
            continue
        if masked and not (nw_img % g == 0 or g % nw_img == 0):
            continue
        return g
    return 1


def attn_fusable(c: int, heads: int, ws: int, n: int, nw_img: int, shifted: bool, itemsize: int) -> bool:
    """The JAX package's rule for its fused window attention kernel on an
    unpadded map: weights, bias, a group of windows and one QKV product within
    12.5 MB.  Kept as the routing rule so that one configuration runs the
    counterpart kernels in both packages; it measures nothing of the card."""
    nsq = ws * ws
    group = pick_group(n * nw_img, nw_img, heads, shifted)
    return c % 8 == 0 and (4 * c * c * itemsize + heads * nsq * nsq * 4 + 2 * group * nsq * c * (4 + itemsize)
                           + nsq * 3 * c * 4) <= 12_500_000


def mlp_fusable(c: int, dh: int, itemsize: int) -> bool:
    """The JAX package's rule for its fused MLP kernel in a Swin block."""
    return c % 8 == 0 and (2 * c * dh * itemsize <= 10_000_000 or dh % 256 == 0)


def _make_norm(channels: int, real: int) -> nn.Module:
    """LayerNorm over ``channels``, masked to the first ``real`` where they differ."""
    if real and real != channels:
        return MaskedLayerNorm(channels, real, eps=LN_EPS)
    return nn.LayerNorm(channels, eps=LN_EPS)


class WindowAttention(nn.Module):
    """Window attention under the reference's parameter names (``qkv``,
    ``proj``, and ``relative_position_bias_table`` or ``logit_scale`` +
    ``cpb_mlp``).  ``forward`` is the plain route; ``constants`` gives the
    fused kernel its operands."""

    def __init__(self, dim: int, num_heads: int, window_size: int, v2: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.dim, self.num_heads, self.window_size, self.v2, self.dtype = dim, num_heads, window_size, v2, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if v2:
            self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
            self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(), nn.Linear(512, num_heads, bias=False))
            self.register_buffer("coords", torch.from_numpy(_log_cpb_coords(window_size).reshape(-1, 2)),
                                 persistent=False)
        else:
            self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("index", torch.from_numpy(_relative_position_index(window_size).reshape(-1)),
                             persistent=False)
        self._packed = Packed()

    def _build(self):
        n, c = self.window_size ** 2, self.dim
        dt = self.dtype
        b_qkv = self.qkv.bias
        if self.v2:  # the reference zeroes the key bias at use
            b_qkv = torch.cat([b_qkv[:c], torch.zeros_like(b_qkv[c:2 * c]), b_qkv[2 * c:]])
            fc1, fc2 = self.cpb_mlp[0], self.cpb_mlp[2]
            hidden = torch.relu(F.linear(self.coords.to(dt), fc1.weight.to(dt), fc1.bias.to(dt)))
            table = F.linear(hidden, fc2.weight.to(dt))
            bias = 16.0 * torch.sigmoid(table[self.index].reshape(n, n, self.num_heads).permute(2, 0, 1))
            logit_scale = self.logit_scale.reshape(self.num_heads).float()
        else:
            bias = self.relative_position_bias_table[self.index].reshape(n, n, self.num_heads).permute(2, 0, 1)
            logit_scale = None
        return (self.qkv.weight.to(dt).t().contiguous(), b_qkv, self.proj.weight.to(dt).t().contiguous(),
                bias.float().contiguous(), logit_scale)

    def constants(self):
        """(w_qkv (C, 3C), b_qkv with v2's key bias zeroed, w_o (C, C),
        rel_bias (heads, S, S) float32, logit_scale (heads,) or None): cached
        when serving, built in the graph under training (``Packed.get``), so
        that the bias table, v2's position MLP and logit scale get their
        gradients (none for the key bias, nor for a logit scale above ln 100,
        as in JAX)."""
        return self._packed.get(self._build, self.dtype, *self.parameters())

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape  # (windows, ws*ws, C)
        nh, hd, dt = self.num_heads, c // self.num_heads, self.dtype
        w_qkv, b_qkv, w_o, bias, logit_scale = self.constants()
        qkv = x.to(dt) @ w_qkv + b_qkv.to(dt)
        q, k, v = (a.reshape(b, n, nh, hd) for a in qkv.split(c, dim=-1))
        if self.v2:
            qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-6)
            kn = k / torch.linalg.vector_norm(k, dim=-1, keepdim=True).clamp_min(1e-6)
            attn = torch.einsum("bnhd,bmhd->bhnm", qn, kn).float()
            attn = attn * torch.exp(logit_scale.clamp_max(math.log(100.0))).reshape(1, nh, 1, 1)
        else:
            attn = torch.einsum("bnhd,bmhd->bhnm", q * hd ** -0.5, k).float()
        attn = attn + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(b, nh, n, n)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        return out @ w_o + self.proj.bias.to(dt)


class SwinBlock(nn.Module):
    """One Swin block under the reference's parameter names (``norm1``,
    ``attn``, ``norm2``, ``mlp.0``, ``mlp.3``).  ``real_dim`` is the number of
    real channels when ``dim`` is zero-padded (the channel-padded variant):
    LayerNorm statistics cover them alone and the MLP's hidden size follows
    them."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int, mlp_ratio: float = 4.0,
                 sd_prob: float = 0.0, v2: bool = False, dtype: torch.dtype = torch.float32, real_dim: int = 0,
                 attention: Optional[str] = None, mlp: Optional[str] = None):
        super().__init__()
        if attention not in (None, *ATTENTION_ROUTES) or mlp not in (None, *MLP_ROUTES):
            raise ValueError(f"attention is None or one of {ATTENTION_ROUTES}, mlp None or one of {MLP_ROUTES}; "
                             f"got {attention!r} and {mlp!r}")
        self.dim, self.num_heads, self.window_size, self.shift, self.v2 = dim, num_heads, window_size, shift, v2
        self.dtype, self.real_dim = dtype, real_dim
        self.attention_route, self.mlp_route = attention, mlp
        self.mlp_dim = int((real_dim or dim) * mlp_ratio)
        self.norm1 = _make_norm(dim, real_dim)
        self.attn = WindowAttention(dim, num_heads, window_size, v2, dtype)
        self.norm2 = _make_norm(dim, real_dim)
        # indices 1, 2 and 4 hold the reference's GELU and Dropouts, so that the two products are mlp.0 and mlp.3
        self.mlp = nn.Sequential(nn.Linear(dim, self.mlp_dim), nn.GELU(), nn.Identity(),
                                 nn.Linear(self.mlp_dim, dim), nn.Identity())
        self.stochastic_depth = StochasticDepth(sd_prob, "row")
        self._packed = Packed()
        self._masks: Dict[tuple, torch.Tensor] = {}

    def geometry(self, h: int, w: int) -> Tuple[int, int, int, int]:
        """(padded height, padded width, shift along h, shift along w) on an (h, w) map."""
        ws = self.window_size
        ph, pw = (h + ws - 1) // ws * ws, (w + ws - 1) // ws * ws
        return ph, pw, self.shift if ws < ph else 0, self.shift if ws < pw else 0

    def routes(self, n: int, h: int, w: int, train: bool = False) -> Tuple[str, str]:
        """(attention route, mlp route) for (``n``, ``h``, ``w``, dim) input,
        serving or under training (``train``), where JAX fuses a sub-block only
        if the block's stochastic depth is 0 (``models/swin.py:265``, ``:322``)."""
        ws, c = self.window_size, self.dim
        ph, pw, shift_h, shift_w = self.geometry(h, w)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        attention, mlp = self.attention_route, self.mlp_route
        padded = (ph, pw) != (h, w)
        drops = train and self.stochastic_depth.p > 0.0
        if attention is None:
            fits = (not drops and not padded and window_kernel_takes(c, self.num_heads, ws * ws)
                    and attn_fusable(c, self.num_heads, ws, n, (ph // ws) * (pw // ws), shift_h + shift_w > 0,
                                     itemsize))
            attention = "block" if fits else "plain"
        elif attention == "block" and padded:
            raise ValueError(f'attention="block" takes maps of whole windows; a {h}x{w} map in windows of {ws} '
                             f'needs padding (use attention=None or "plain")')
        if mlp is None:
            fits = not drops and mlp_fusable(c, self.mlp_dim, itemsize) and mlp_kernel_takes(c, self.mlp_dim)
            mlp = "block" if fits else "plain"
        if drops and "block" in (attention, mlp):
            raise ValueError(f"a block route has no branch to drop: under training at stochastic depth "
                             f"{self.stochastic_depth.p} use attention and mlp None or \"plain\"")
        return attention, mlp

    def _mask(self, ph: int, pw: int, shift_h: int, shift_w: int, device) -> torch.Tensor:
        key = (ph, pw, shift_h, shift_w, str(device))
        if key not in self._masks:
            self._masks[key] = _shift_mask(ph, pw, self.window_size, shift_h, shift_w).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        n, h, w, c = x.shape
        ws = self.window_size
        ph, pw, shift_h, shift_w = self.geometry(h, w)
        shifted = shift_h + shift_w > 0
        attention, mlp = self.routes(n, h, w, train)
        ln_count = self.real_dim if self.real_dim != c else 0
        mask = self._mask(ph, pw, shift_h, shift_w, x.device) if shifted else None

        if attention == "block":
            w_qkv, b_qkv, w_o, bias, logit_scale = self.attn.constants()
            y = torch.roll(x, (-shift_h, -shift_w), dims=(1, 2)) if shifted else x
            out = window_attention_block(
                _window_partition(y, ws), self.norm1.weight, self.norm1.bias, w_qkv, b_qkv, w_o, self.attn.proj.bias,
                bias, mask, logit_scale, self.num_heads, float(c // self.num_heads) ** -0.5, LN_EPS, self.v2,
                (ph // ws) * (pw // ws), ln_count)
            y = _window_reverse(out, ws, n, ph, pw)
            x = torch.roll(y, (shift_h, shift_w), dims=(1, 2)) if shifted else y
        else:
            # v2 normalises the branch output, v1 its input
            y = x if self.v2 else layer_norm(x, self.norm1, self.dtype)
            if (ph, pw) != (h, w):
                y = F.pad(y, (0, 0, 0, pw - w, 0, ph - h))
            if shifted:
                y = torch.roll(y, (-shift_h, -shift_w), dims=(1, 2))
            y = _window_reverse(self.attn(_window_partition(y, ws), mask), ws, n, ph, pw)
            if shifted:
                y = torch.roll(y, (shift_h, shift_w), dims=(1, 2))
            y = y[:, :h, :w, :]
            if self.v2:
                y = layer_norm(y, self.norm1, self.dtype)
            x = x + self.stochastic_depth(y, train, generator)

        fc1, fc2 = self.mlp[0], self.mlp[3]
        if mlp == "block":
            w1, w2 = self._packed.transposed(self.dtype, fc1.weight, fc2.weight)
            out = mlp_block(x.reshape(-1, c), self.norm2.weight, self.norm2.bias, w1, fc1.bias, w2, fc2.bias, LN_EPS,
                            self.v2, ln_count)
            return out.reshape(x.shape)
        y = x if self.v2 else layer_norm(x, self.norm2, self.dtype)
        y = F.gelu(F.linear(y, fc1.weight.to(self.dtype), fc1.bias.to(self.dtype)))
        y = F.linear(y, fc2.weight.to(self.dtype), fc2.bias.to(self.dtype))
        if self.v2:
            y = layer_norm(y, self.norm2, self.dtype)
        return x + self.stochastic_depth(y, train, generator)


class PatchMerging(nn.Module):
    """(reference ``swin_transformer.py:PatchMerging`` / ``PatchMergingV2``):
    v1 normalises the 4C concat before the reduction, v2 the 2C output after
    it.  ``real_in``/``real_out`` are the real channels of a zero-padded
    layout (the LayerNorm over the concat covers 4 · ``real_in``)."""

    def __init__(self, dim_in: int, dim_out: int, v2: bool = False, dtype: torch.dtype = torch.float32,
                 real_in: int = 0, real_out: int = 0):
        super().__init__()
        self.v2, self.dtype = v2, dtype
        self.reduction = nn.Linear(4 * dim_in, dim_out, bias=False)
        if v2:
            self.norm = _make_norm(dim_out, real_out)
        else:
            self.norm = _make_norm(4 * dim_in, 4 * real_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        if h % 2 or w % 2:  # the reference pads odd maps before merging
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            n, h, w, c = x.shape
        # channel order of the reference's concat x0..x3 = [(h even, w even), (h odd, w even), (h even, w odd), (h odd, w odd)]
        x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5).reshape(n, h // 2, w // 2, 4 * c)
        weight = self.reduction.weight.to(self.dtype)
        if self.v2:
            return layer_norm(F.linear(x.to(self.dtype), weight), self.norm, self.dtype)
        return F.linear(layer_norm(x, self.norm, self.dtype), weight)


class SwinTransformer(nn.Module):
    """(reference ``swin_transformer.py:SwinTransformer``) for NHWC images
    whose sides are multiples of 4.  ``pad_channels`` rounds every stage's
    channels up to a multiple of 128 with the head dim kept (see
    ``models/swin_padded.py``).  ``forward`` takes a tensor on the parameters'
    device, or a numpy array, which goes to the card."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7, sd_prob: float = 0.2,
                 num_classes: int = 1000, v2: bool = False, dtype: torch.dtype = torch.float32,
                 pad_channels: bool = False, in_channels: int = 3, attention: Optional[str] = None,
                 mlp: Optional[str] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype is float32 or bfloat16, got {dtype}")
        if len(depths) != len(num_heads) or embed_dim % num_heads[0]:
            raise ValueError("depths and num_heads name the same stages, and embed_dim is a multiple of num_heads[0]")
        self.embed_dim, self.depths, self.num_heads = embed_dim, tuple(depths), tuple(num_heads)
        self.window_size, self.v2, self.dtype, self.pad_channels = window_size, v2, dtype, pad_channels

        def pdim(real: int) -> int:
            return -(-real // 128) * 128 if pad_channels else real

        real = embed_dim
        stages = [nn.Sequential(PatchifyDense(in_channels, pdim(real), (4, 4), dtype), nn.Identity(),
                                _make_norm(pdim(real), real))]
        total, bid = sum(depths), 0
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            if stage > 0:
                real_prev, real = real, real * 2
                padded = pdim(real_prev) != real_prev or pdim(real) != real
                stages.append(PatchMerging(pdim(real_prev), pdim(real), v2, dtype, real_prev if padded else 0, real))
            dim, hd = pdim(real), real // heads
            blocks = []
            for blk in range(depth):
                blocks.append(SwinBlock(dim, dim // hd, window_size, 0 if blk % 2 == 0 else window_size // 2,
                                        sd_prob=sd_prob * bid / max(total - 1, 1), v2=v2, dtype=dtype,
                                        real_dim=real if dim != real else 0, attention=attention, mlp=mlp))
                bid += 1
            stages.append(nn.Sequential(*blocks))
        self.features = nn.Sequential(*stages)
        self.norm = nn.LayerNorm(pdim(real), eps=LN_EPS)
        self.head = nn.Linear(pdim(real), num_classes)
        self.reset_parameters(generator)
        self.eval()

    def blocks(self):
        """Every ``SwinBlock``, in order."""
        return [m for m in self.features.modules() if isinstance(m, SwinBlock)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX module's initialisers (variance-scaling normal products,
        zero biases, N(0, 0.02²) bias tables, ln 10 logit scales) drawn from
        ``generator``; not the JAX package's values for the same seed."""
        for module in self.modules():
            if isinstance(module, PatchifyDense):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.Linear):
                lecun_normal_(module.weight, module.in_features, generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, WindowAttention) and not module.v2:
                table = module.relative_position_bias_table
                with torch.no_grad():
                    table.copy_(0.02 * torch.randn(table.shape, generator=generator,
                                                   device=generator.device if generator is not None else "cpu"))

    def routes(self, n: int, h: int, w: int, train: bool = False):
        """[(attention route, mlp route)] of every block for ``n`` images of (``h``, ``w``), serving or under
        training (``train``)."""
        h, w = h // 4, w // 4
        out = []
        for i, stage in enumerate(self.features):
            if i == 0:
                continue
            if isinstance(stage, PatchMerging):
                h, w = (h + 1) // 2, (w + 1) // 2
            else:
                out += [block.routes(n, h, w, train) for block in stage]
        return out

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of NHWC images ``x``.  Serving (``train=False``) runs under
        ``no_grad``; ``train=True`` records the graph for a backward and draws
        the stochastic depth of each block from ``generator`` (on ``x``'s
        device; torch's default generator without one)."""
        if not train:
            with torch.no_grad():
                return self._forward(x, False, None)
        return self._forward(x, True, generator)

    def _forward(self, x, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        x = as_tensor(x)
        with full_float32():
            stem = self.features[0]
            x = layer_norm(stem[0](x), stem[2], self.dtype)
            for stage in self.features[1:]:
                if isinstance(stage, PatchMerging):
                    x = stage(x)
                else:
                    for block in stage:
                        x = block(x, train, generator)
            x = layer_norm(x, self.norm, self.dtype).mean(dim=(1, 2))
            return F.linear(x, self.head.weight.to(self.dtype), self.head.bias.to(self.dtype))


def _make(name: str, dim: int, depths, heads, sd: float, v2: bool = False, window: int = 7):
    def build(*, num_classes: int = 1000, dtype: torch.dtype = torch.float32, device=None, sd_prob: float = sd,
              **kwargs):
        model = SwinTransformer(dim, depths, heads, window, sd_prob, num_classes, v2, dtype, **kwargs)
        return model.to("cuda" if device is None else device)

    build.__name__ = name
    build.__doc__ = (f"{name}: ``dtype`` float32 or bfloat16, ``generator`` seeds the parameters, ``device`` "
                     f"defaults to the first CUDA card, ``sd_prob`` (default {sd}) is the stochastic depth of the "
                     "last block; other keywords go to ``SwinTransformer``.")
    return register_model(name)(build)


swin_t = _make("swin_t", 96, (2, 2, 6, 2), (3, 6, 12, 24), 0.2)
swin_s = _make("swin_s", 96, (2, 2, 18, 2), (3, 6, 12, 24), 0.3)
swin_b = _make("swin_b", 128, (2, 2, 18, 2), (4, 8, 16, 32), 0.5)
# v2: cosine attention, post-norm, log-spaced continuous position bias, window 8 (reference swin_v2_*)
swin_v2_t = _make("swin_v2_t", 96, (2, 2, 6, 2), (3, 6, 12, 24), 0.2, v2=True, window=8)
swin_v2_s = _make("swin_v2_s", 96, (2, 2, 18, 2), (3, 6, 12, 24), 0.3, v2=True, window=8)
swin_v2_b = _make("swin_v2_b", 128, (2, 2, 18, 2), (4, 8, 16, 32), 0.5, v2=True, window=8)
