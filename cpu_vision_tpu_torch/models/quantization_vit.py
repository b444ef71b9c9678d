"""Post-training int8 serving of the Vision Transformer: ``Int8ViT``.

Counterpart of the JAX package's ``models/quantization_vit.py``.  Weights are
per-output-channel symmetric int8; activations are quantised to static
per-channel scales inside the int8 kernels (``ops.kernels.mlp_block_int8`` and
``attention_block_int8``) at four sites a layer: after each LayerNorm, after
the gelu and before the output projection.  Each activation scale is folded
into the rows of the weight it multiplies, so the per-channel ranges cost the
product nothing.  LayerNorm, softmax and gelu stay float32.  The patch
embedding runs in bfloat16 (``layers.PatchifyDense``), the activations
between the sub-blocks are bfloat16, and the classifier is a float32
LayerNorm (eps 1e-6) and the float32 head.

``calibrate(batches)`` runs the float graph of the same layers (products of
bfloat16 values summed in float32, as the bf16 fused path) over the batches
and records each site's per-channel max |x|; scales are max(amax, 1e-8) / 127.
``__call__`` raises before calibration.  ``models.int8_scales_from_numpy``
sets the scales of a calibration made elsewhere (the JAX engine's).

``routes()`` says what each layer's two sub-blocks run: ``"kernel"`` (the
wrapper, which launches its kernel on CUDA tensors and runs the plain twin on
CPU tensors) or ``"plain"`` (the twin).  With ``route=None`` (the default) a
sub-block takes its kernel where the kernel takes the widths
(``int8_transformer.attention_kernel_takes`` / ``mlp_kernel_takes``) and the
twin elsewhere, a decision by shape; ``"kernel"`` and ``"plain"`` force one.

Usage::

    eng = Int8ViT.from_model(model)      # a models.VisionTransformer
    eng.calibrate(batches)               # static activation scales
    logits = eng(images)                 # (N, H, W, 3) float32, NHWC
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .._dtype import full_float32
from .._layout import as_tensor
from ..ops.kernels import int8_transformer as _i8
from ..ops.kernels.transformer_block import _gelu_f32, _ln_f32
from .layers import PatchifyDense

__all__ = ["Int8ViT"]

LN_EPS = 1e-6
ROUTES = ("kernel", "plain")
SITES = ("attn_in", "attn_out", "mlp_in", "mlp_gelu")


def _int8_weight(w: torch.Tensor, a: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_weight(w * a[:, None])`` (``w`` alone without ``a``), the int8
    matrix stored transposed, as the kernels read it, and seen as (in, out)."""
    q, scale = _i8.quantize_weight(w if a is None else w * a[:, None])
    return q.t().contiguous().t(), scale


class _Layer:
    """One encoder layer's float32 parameters and int8 weights."""

    def __init__(self, block):
        def f32(t):
            return t.detach().float().clone()

        sa = block.self_attention
        self.g0, self.b0 = f32(block.ln_1.weight), f32(block.ln_1.bias)
        self.w_qkv, self.b_qkv = f32(sa.in_proj_weight).t().contiguous(), f32(sa.in_proj_bias)  # (D, 3D) [q | k | v]
        self.w_o, self.b_o = f32(sa.out_proj.weight).t().contiguous(), f32(sa.out_proj.bias)
        self.g1, self.b1ln = f32(block.ln_2.weight), f32(block.ln_2.bias)
        self.w1, self.b1 = f32(block.mlp[0].weight).t().contiguous(), f32(block.mlp[0].bias)
        self.w2, self.b2 = f32(block.mlp[3].weight).t().contiguous(), f32(block.mlp[3].bias)
        self.quantize({})

    def quantize(self, scales: Dict[str, torch.Tensor]) -> None:
        """Int8 weights with the activation scales ``scales[site]`` folded into their rows."""
        self.qw_qkv, self.s_qkv = _int8_weight(self.w_qkv, scales.get("attn_in"))
        self.qw_o, self.s_o = _int8_weight(self.w_o, scales.get("attn_out"))
        self.qw1, self.s1 = _int8_weight(self.w1, scales.get("mlp_in"))
        self.qw2, self.s2 = _int8_weight(self.w2, scales.get("mlp_gelu"))


def _bf16_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of both rounded to bfloat16, summed in float32."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


class Int8ViT:
    """See the module docstring.  Built by :meth:`from_model`."""

    def __init__(self, model, route: Optional[str] = None):
        if route not in (None, *ROUTES):
            raise ValueError(f"route is None or one of {ROUTES}, got {route!r}")
        self.route = route
        self.d = model.hidden_dim
        block0 = model.encoder.layers[0]
        self.heads, self.mlp_dim = block0.num_heads, block0.mlp_dim
        conv = model.conv_proj
        self.embed = PatchifyDense(conv.weight.shape[1], self.d, conv.patch, torch.bfloat16).to(conv.weight.device)
        self.embed.load_state_dict(conv.state_dict())
        self.embed.requires_grad_(False)
        self.cls = model.class_token.detach().float().clone()
        self.pos = model.encoder.pos_embedding.detach().float().clone()
        self.layers: List[_Layer] = [_Layer(b) for b in model.encoder.layers]
        ln, head = model.encoder.ln, model.heads.head
        self.ln_f = (ln.weight.detach().float().clone(), ln.bias.detach().float().clone())
        self.head = (head.weight.detach().float().clone(), head.bias.detach().float().clone())
        self.scales: Optional[Dict[str, torch.Tensor]] = None

    @staticmethod
    def from_model(model, route: Optional[str] = None) -> "Int8ViT":
        """The engine of a ``models.VisionTransformer``: its weights quantised, on its device."""
        return Int8ViT(model, route)

    # ------------------------------------------------------------ the graph

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        x = self.embed(x).reshape(n, -1, self.d)
        cls = self.cls.to(x.dtype).expand(n, 1, self.d)
        return (torch.cat([cls, x], dim=1) + self.pos.to(x.dtype)).to(torch.bfloat16)

    def _classify(self, x: torch.Tensor) -> torch.Tensor:
        h = F.layer_norm(x[:, 0].float(), (self.d,), *self.ln_f, LN_EPS)
        return F.linear(h, *self.head)

    def _layer_float(self, x: torch.Tensor, ly: _Layer, i: int, sites: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The float twin of a layer's two int8 sub-blocks (calibration and the
        oracle): products of bfloat16 values in float32, sites recorded in float32."""
        n, s, d = x.shape
        hd = d // self.heads

        def record(f, site):
            sites[f"L{i}/{site}"] = f.reshape(-1, f.shape[-1]).abs().amax(dim=0)

        x32 = x.float()
        h32 = _ln_f32(x32, ly.g0, ly.b0, LN_EPS)
        record(h32, "attn_in")
        qkv = (_bf16_dot(h32.reshape(-1, d), ly.w_qkv) + ly.b_qkv).reshape(n, s, 3 * d).to(torch.bfloat16)
        q, k, v = (t.reshape(n, s, self.heads, hd).float() for t in qkv.split(d, dim=-1))
        scores = torch.einsum("nqhd,nkhd->nhqk", q, k) / float(hd) ** 0.5
        p = torch.softmax(scores, dim=-1).to(torch.bfloat16)
        o = torch.einsum("nhqk,nkhd->nqhd", p.float(), v).reshape(n, s, d)
        record(o, "attn_out")
        x32 = x32 + (_bf16_dot(o.reshape(-1, d), ly.w_o) + ly.b_o).reshape(n, s, d)
        h32 = _ln_f32(x32, ly.g1, ly.b1ln, LN_EPS)
        record(h32, "mlp_in")
        f = _gelu_f32(_bf16_dot(h32.reshape(-1, d), ly.w1) + ly.b1)
        record(f, "mlp_gelu")
        x32 = x32 + (_bf16_dot(f, ly.w2) + ly.b2).reshape(n, s, d)
        return x32.to(torch.bfloat16)

    def _float_graph(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        sites: Dict[str, torch.Tensor] = {}
        with torch.no_grad(), full_float32():
            x = self._embed(as_tensor(x))
            for i, ly in enumerate(self.layers):
                x = self._layer_float(x, ly, i, sites)
            return self._classify(x), sites

    def routes(self) -> Tuple[str, str]:
        """(attention route, mlp route) of every layer: ``"kernel"`` or ``"plain"``."""
        if self.route is not None:
            return self.route, self.route
        return ("kernel" if _i8.attention_kernel_takes(self.d, self.heads) else "plain",
                "kernel" if _i8.mlp_kernel_takes(self.d, self.mlp_dim) else "plain")

    def _layer_int8(self, x: torch.Tensor, ly: _Layer, i: int, routes: Tuple[str, str]) -> torch.Tensor:
        n, s, d = x.shape
        sc = self.scales
        attention = _i8.attention_block_int8 if routes[0] == "kernel" else _i8.attention_block_int8_plain
        mlp = _i8.mlp_block_int8 if routes[1] == "kernel" else _i8.mlp_block_int8_plain
        x = attention(x, ly.g0, ly.b0, ly.qw_qkv, ly.s_qkv, ly.b_qkv, ly.qw_o, ly.s_o, ly.b_o, sc[f"L{i}/attn_in"],
                      sc[f"L{i}/attn_out"], self.heads, 1.0 / float(d // self.heads) ** 0.5, LN_EPS)
        out = mlp(x.reshape(n * s, d), ly.g1, ly.b1ln, ly.qw1, ly.s1, ly.b1, ly.qw2, ly.s2, ly.b2,
                  sc[f"L{i}/mlp_in"], sc[f"L{i}/mlp_gelu"], LN_EPS)
        return out.reshape(n, s, d)

    # -------------------------------------------------------------- public

    def set_scales(self, scales: Dict[str, torch.Tensor]) -> "Int8ViT":
        """Take ``scales`` ({"L{i}/{site}": (C,) float32}) and re-quantise every
        weight with them folded into its rows."""
        self.scales = {k: v.float() for k, v in scales.items()}
        for i, ly in enumerate(self.layers):
            ly.quantize({site: self.scales[f"L{i}/{site}"] for site in SITES})
        return self

    def calibrate(self, batches: Sequence) -> "Int8ViT":
        """Per-channel max |x| at every site over ``batches``; scales max(amax, 1e-8) / 127."""
        amax: Dict[str, torch.Tensor] = {}
        for b in batches:
            for k, v in self._float_graph(b)[1].items():
                amax[k] = torch.maximum(amax[k], v) if k in amax else v
        return self.set_scales({k: torch.clamp_min(v, 1e-8) / 127.0 for k, v in amax.items()})

    def float_reference(self, x) -> torch.Tensor:
        """The float graph's logits (the oracle of the int8 forward)."""
        return self._float_graph(x)[0]

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        if self.scales is None:
            raise RuntimeError("call .calibrate(batches) before int8 inference")
        routes = self.routes()
        with full_float32():
            x = self._embed(as_tensor(x))
            for i, ly in enumerate(self.layers):
                x = self._layer_int8(x, ly, i, routes)
            return self._classify(x)
