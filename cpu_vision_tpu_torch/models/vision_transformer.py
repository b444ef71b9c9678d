"""Vision Transformer (reference ``torchvision/models/vision_transformer.py``):
patchify, class token, learned position embeddings, pre-LN encoder.

Counterpart of the JAX package's ``models/vision_transformer.py``.  Input is
NHWC, parameters are float32 under torchvision's ``state_dict`` keys, and
``dtype`` (float32 or bfloat16) is the compute dtype of activations and
weights.  ``forward(x)`` serves under ``no_grad``; ``forward(x, train=True,
generator=g)`` builds the autograd graph and applies dropout with masks drawn
from ``g``: the kernels' backward recomputes their twins (``ops.kernels._grad``).

Each encoder layer's attention and MLP sub-blocks go through one of these
routes, chosen with ``attention=`` and ``mlp=`` (the counterparts of the JAX
module's ``FUSED_ATTENTION`` and ``FUSED_MLP`` switches):

* ``attention="block"``: ``kernels.attention_block``, the whole sub-block;
* ``attention="flash"``: LayerNorm and the QKV and output projections as
  stock operators around ``kernels.flash_mha`` (``FusedMHA``);
* ``mlp="block"``: ``kernels.mlp_block``, the whole sub-block;
* ``"plain"``: stock PyTorch operators only, the oracle of the other routes;
* ``None``: what the JAX package would run for the same configuration, by a
  copy of its rule: ``attention_block`` when its working set would fit the
  TPU's fast memory (``attn_fits_vmem``), else ``flash_mha``; ``mlp_block``
  when the widths are aligned (``mlp_fits_vmem``), else stock operators.  So
  ViT-B/16 runs ``attention_block`` in bfloat16 and ``flash_mha`` in float32,
  as it does there.  Where the kernel the rule picks does not take the
  widths (a head dim outside ``HEAD_DIMS``, a D outside ``MLP_DIMS``), the
  sub-block takes the next route that does, down to ``"plain"``: a decision by
  shape, the same on either device.  Under training with dropout the rule is
  the JAX module's too: the fused blocks only when ``dropout`` and
  ``attention_dropout`` are 0, ``flash_mha`` only when ``attention_dropout``
  is, else ``"plain"`` with dropout.

A kernel route asked for by name launches its kernel on CUDA tensors, or
raises where the kernel does not take the widths or a dropout it cannot apply,
and runs the kernel's plain twin on CPU tensors; no route gives way to another.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._dtype import full_float32
from .._layout import as_tensor
from ..ops.kernels.flash_attention import HEAD_DIMS, flash_mha
from ..ops.kernels.transformer_block import attention_block, attention_kernel_takes, mlp_block, mlp_kernel_takes
from ._api import register_model
from .layers import Packed, PatchifyDense, dropout, layer_norm, lecun_normal_

__all__ = ["VisionTransformer", "EncoderBlock", "FusedMHA", "attn_fits_vmem", "mlp_fits_vmem",
           "vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32", "vit_h_14"]

ATTENTION_ROUTES = ("block", "flash", "plain")
MLP_ROUTES = ("block", "plain")
LN_EPS = 1e-6


def attn_fits_vmem(d: int, s: int, itemsize: int) -> bool:
    """The JAX package's rule for its fused attention kernel: QKV and output
    weights, the (S, 3D) QKV product (float32 and cast) and the (S, S) scores
    within 12.5 MB.  Kept as the routing rule so that one configuration runs
    the counterpart kernels in both packages; it measures nothing of the card."""
    return 4 * d * d * itemsize + s * 3 * d * (4 + itemsize) + s * s * 4 <= 12_500_000


def mlp_fits_vmem(d: int, mlp_dim: int) -> bool:
    """The JAX package's rule for its fused MLP kernel: aligned widths."""
    return d % 128 == 0 and mlp_dim % 256 == 0


class FusedMHA(nn.Module):
    """Self-attention with one fused (D → 3D) QKV product around
    ``kernels.flash_mha``.  Parameters are ``torch.nn.MultiheadAttention``'s:
    ``in_proj_weight`` (3D, D) with rows [q; k; v], each head-major,
    ``in_proj_bias`` and ``out_proj``; the (D, 3D) [q | k | v] matrix the
    product uses is built from them once (``packed``)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self._packed = Packed()

    def packed(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_qkv (D, 3D), w_o (D, D)) in the compute dtype."""
        return self._packed.transposed(self.dtype, self.in_proj_weight, self.out_proj.weight)

    def forward(self, x: torch.Tensor, plain: bool = False, attention_dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``plain`` takes stock operators around the softmax, which the
        attention weights' dropout (``attention_dropout``, masks from
        ``generator``) needs; else ``flash_mha``."""
        n, s, d = x.shape
        nh, hd = self.num_heads, d // self.num_heads
        w_qkv, w_o = self.packed()
        qkv = x.to(self.dtype) @ w_qkv + self.in_proj_bias.to(self.dtype)
        q, k, v = (a.reshape(n, s, nh, hd) for a in qkv.split(d, dim=-1))
        if plain:
            scores = torch.einsum("nqhd,nkhd->nhqk", q / math.sqrt(hd), k)
            weights = dropout(torch.softmax(scores.float(), dim=-1).to(self.dtype), attention_dropout, generator)
            o = torch.einsum("nhqk,nkhd->nqhd", weights, v)
        else:
            if attention_dropout:
                raise ValueError("flash_mha applies no attention dropout")
            o = flash_mha(q.contiguous(), k.contiguous(), v.contiguous(), 1.0 / math.sqrt(hd)).permute(0, 2, 1, 3)
        return o.reshape(n, s, d) @ w_o + self.out_proj.bias.to(self.dtype)


class EncoderBlock(nn.Module):
    """One pre-LN encoder layer under torchvision's parameter names
    (``ln_1``, ``self_attention``, ``ln_2``, ``mlp.0``, ``mlp.3``)."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_dim: int, dtype: torch.dtype = torch.float32,
                 attention: Optional[str] = None, mlp: Optional[str] = None, dropout: float = 0.0,
                 attention_dropout: float = 0.0):
        super().__init__()
        if attention not in (None, *ATTENTION_ROUTES) or mlp not in (None, *MLP_ROUTES):
            raise ValueError(f"attention is None or one of {ATTENTION_ROUTES}, mlp None or one of {MLP_ROUTES}; "
                             f"got {attention!r} and {mlp!r}")
        self.num_heads, self.mlp_dim, self.dtype = num_heads, mlp_dim, dtype
        self.attention_route, self.mlp_route = attention, mlp
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.ln_1 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.self_attention = FusedMHA(hidden_dim, num_heads, dtype)
        self.ln_2 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        # indices 1 and 2 hold the reference's GELU and Dropout, so that the
        # two products are mlp.0 and mlp.3
        self.mlp = nn.Sequential(nn.Linear(hidden_dim, mlp_dim), nn.GELU(), nn.Identity(),
                                 nn.Linear(mlp_dim, hidden_dim))
        self._packed = Packed()

    def routes(self, d: int, s: int, train: bool = False) -> Tuple[str, str]:
        """(attention route, mlp route) for (N, ``s``, ``d``) input, serving or
        under training (``train``), where dropout rules out the fused blocks."""
        attention, mlp = self.attention_route, self.mlp_route
        drop, attn_drop = (self.dropout, self.attention_dropout) if train else (0.0, 0.0)
        if attention is None:
            itemsize = torch.empty((), dtype=self.dtype).element_size()
            attention = "block" if attn_fits_vmem(d, s, itemsize) and not (drop or attn_drop) else "flash"
            if attention == "block" and not attention_kernel_takes(d, self.num_heads):
                attention = "flash"
            if attention == "flash" and (d // self.num_heads not in HEAD_DIMS or attn_drop):
                attention = "plain"
        if mlp is None:
            fits = mlp_fits_vmem(d, self.mlp_dim) and mlp_kernel_takes(d, self.mlp_dim)
            mlp = "block" if fits and not drop else "plain"
        if (attention == "block" and (drop or attn_drop)) or (attention == "flash" and attn_drop) or \
                (mlp == "block" and drop):
            raise ValueError(f"the {attention!r} attention and {mlp!r} mlp routes cannot apply dropout "
                             f"{drop} and attention dropout {attn_drop}")
        return attention, mlp

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n, s, d = x.shape
        attention, mlp = self.routes(d, s, train)
        drop, attn_drop = (self.dropout, self.attention_dropout) if train else (0.0, 0.0)
        sa = self.self_attention
        if attention == "block":
            w_qkv, w_o = sa.packed()
            x = attention_block(x, self.ln_1.weight, self.ln_1.bias, w_qkv, sa.in_proj_bias, w_o, sa.out_proj.bias,
                                self.num_heads, 1.0 / math.sqrt(d // self.num_heads), LN_EPS)
        else:
            h = sa(layer_norm(x, self.ln_1, self.dtype), attention == "plain", attn_drop, generator)
            x = x + dropout(h, drop, generator)

        fc1, fc2 = self.mlp[0], self.mlp[3]
        if mlp == "block":
            w1, w2 = self._packed.transposed(self.dtype, fc1.weight, fc2.weight)
            return mlp_block(x.reshape(n * s, d), self.ln_2.weight, self.ln_2.bias, w1, fc1.bias, w2, fc2.bias,
                             LN_EPS).reshape(n, s, d)
        h = layer_norm(x, self.ln_2, self.dtype)
        h = dropout(F.gelu(F.linear(h, fc1.weight.to(self.dtype), fc1.bias.to(self.dtype))), drop, generator)
        h = F.linear(h, fc2.weight.to(self.dtype), fc2.bias.to(self.dtype))
        return x + dropout(h, drop, generator)


class Encoder(nn.Module):
    def __init__(self, seq_length: int, num_layers: int, num_heads: int, hidden_dim: int, mlp_dim: int, dtype,
                 attention, mlp, dropout, attention_dropout):
        super().__init__()
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length, hidden_dim))
        self.layers = nn.Sequential(OrderedDict(
            (f"encoder_layer_{i}", EncoderBlock(num_heads, hidden_dim, mlp_dim, dtype, attention, mlp, dropout,
                                                attention_dropout))
            for i in range(num_layers)))
        self.ln = nn.LayerNorm(hidden_dim, eps=LN_EPS)


class VisionTransformer(nn.Module):
    """ViT for square ``image_size`` NHWC images.  ``forward`` takes a tensor
    on the parameters' device, or a numpy array, which goes to the card."""

    def __init__(self, patch_size: int, num_layers: int, num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, image_size: int = 224, in_channels: int = 3,
                 attention: Optional[str] = None, mlp: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype is float32 or bfloat16, got {dtype}")
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} not divisible by patch size {patch_size}")
        self.patch_size, self.image_size, self.hidden_dim, self.dtype = patch_size, image_size, hidden_dim, dtype
        self.dropout, self.attention_dropout = dropout, attention_dropout
        self.conv_proj = PatchifyDense(in_channels, hidden_dim, (patch_size, patch_size), dtype)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        seq_length = (image_size // patch_size) ** 2 + 1
        self.encoder = Encoder(seq_length, num_layers, num_heads, hidden_dim, mlp_dim, dtype, attention, mlp, dropout,
                               attention_dropout)
        self.heads = nn.Sequential(OrderedDict(head=nn.Linear(hidden_dim, num_classes)))
        self.reset_parameters(generator)
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX module's initialisers (variance-scaling normal products,
        zero biases, N(0, 0.02²) position embeddings, zero class token) drawn
        from ``generator``; not the JAX package's values for the same seed."""
        d = self.hidden_dim
        lecun_normal_(self.conv_proj.weight, self.conv_proj.weight[0].numel(), generator)
        pos = self.encoder.pos_embedding
        with torch.no_grad():
            pos.copy_(0.02 * torch.randn(pos.shape, generator=generator,
                                         device=generator.device if generator is not None else "cpu"))
        for block in self.encoder.layers:
            lecun_normal_(block.self_attention.in_proj_weight, d, generator)
            for linear in (block.self_attention.out_proj, block.mlp[0], block.mlp[3]):
                lecun_normal_(linear.weight, linear.in_features, generator)
                nn.init.zeros_(linear.bias)
        lecun_normal_(self.heads.head.weight, d, generator)
        nn.init.zeros_(self.heads.head.bias)

    def routes(self, train: bool = False) -> Tuple[str, str]:
        """(attention route, mlp route) the encoder layers take, serving or under training."""
        return self.encoder.layers[0].routes(self.hidden_dim, self.encoder.pos_embedding.shape[1], train)

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of NHWC images ``x``.  Serving (``train=False``) runs under
        ``no_grad``; ``train=True`` records the graph for a backward and draws
        the dropout masks from ``generator``."""
        if not train:
            with torch.no_grad():
                return self._forward(x, False, None)
        return self._forward(x, True, generator)

    def _forward(self, x, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        x = as_tensor(x)
        n, h, w, _ = x.shape
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(f"expects {self.image_size}x{self.image_size} images, got {(h, w)}")
        with full_float32():
            x = self.conv_proj(x).reshape(n, -1, self.hidden_dim)  # (N, S - 1, D)
            x = torch.cat([self.class_token.to(x.dtype).expand(n, -1, -1), x], dim=1)
            x = x + self.encoder.pos_embedding.to(x.dtype)
            x = dropout(x, self.dropout if train else 0.0, generator)
            for layer in self.encoder.layers:
                x = layer(x, train, generator)
            x = layer_norm(x[:, 0], self.encoder.ln, self.dtype)
            head = self.heads.head
            return F.linear(x, head.weight.to(self.dtype), head.bias.to(self.dtype))


def _make(name: str, patch: int, layers: int, heads: int, hidden: int, mlp_dim: int):
    def build(*, num_classes: int = 1000, dtype: torch.dtype = torch.float32, device=None, **kwargs):
        model = VisionTransformer(patch, layers, heads, hidden, mlp_dim, num_classes=num_classes, dtype=dtype,
                                  **kwargs)
        return model.to("cuda" if device is None else device)

    build.__name__ = name
    build.__doc__ = (f"{name}: ``dtype`` float32 or bfloat16, ``generator`` seeds the parameters, ``device`` "
                       "defaults to the first CUDA card; other keywords go to ``VisionTransformer``.")
    return register_model(name)(build)


vit_b_16 = _make("vit_b_16", 16, 12, 12, 768, 3072)
vit_b_32 = _make("vit_b_32", 32, 12, 12, 768, 3072)
vit_l_16 = _make("vit_l_16", 16, 24, 16, 1024, 4096)
vit_l_32 = _make("vit_l_32", 32, 24, 16, 1024, 4096)
vit_h_14 = _make("vit_h_14", 14, 32, 16, 1280, 5120)
