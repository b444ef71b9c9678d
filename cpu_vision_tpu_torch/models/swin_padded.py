"""Channel-padded Swin-T: the model function and the converter of native weights.

Counterpart of the JAX package's ``models/swin_padded.py``.
``SwinTransformer(pad_channels=True)`` rounds each stage's channels up to a
multiple of 128 with the head dim kept (96 → 128 with 4 heads, 192 → 256 with
8; 384 and 768 stay), masked LayerNorms normalise over the real channels, and
``pad_swin_state_dict`` zero-pads native weights so that the padded lanes
carry exact zeros through every layer: the padded model computes the same
function as the native one.  It is the configuration that runs ``ln_count`` in
``kernels.window_attention_block`` and ``kernels.mlp_block``.

``swin_t_padded`` draws a native Swin-T's parameters from ``generator`` and
pads them, so the zero-lane invariant holds from the start and not only
after a converted checkpoint is loaded.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch

from ._api import register_model
from .swin import SwinTransformer

__all__ = ["swin_t_padded", "pad_swin_state_dict"]

_SWIN_T = dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size=7, sd_prob=0.2)


def _pad_to(a: torch.Tensor, shape: Sequence[int], fill: float = 0.0) -> torch.Tensor:
    out = torch.full(tuple(shape), fill, dtype=a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def pad_swin_state_dict(state_dict: Mapping[str, torch.Tensor], embed_dim: int = 96,
                        depths: Sequence[int] = (2, 2, 6, 2), heads: Sequence[int] = (3, 6, 12, 24),
                        v2: bool = False) -> Dict[str, torch.Tensor]:
    """A native Swin ``state_dict`` in the ``pad_channels=True`` layout.

    Every channel-indexed axis is zero-padded; qkv weights and biases are
    remapped by section (q | k | v each head-major, the native heads in the
    leading head slots); LayerNorm weights and biases pad with zeros so that
    padded lanes stay zero after every normalisation; v2's logit scales pad
    with ln 10.  Final norm and head keep their native size.
    """
    hd = embed_dim // heads[0]
    reals = [embed_dim * 2 ** s for s in range(len(depths))]
    pads = [-(-r // 128) * 128 for r in reals]
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        value = value.detach().cpu()
        parts = key.split(".")
        if parts[0] != "features":
            out[key] = value.clone()
            continue
        index, rest = int(parts[1]), ".".join(parts[2:])
        if index == 0:  # patch embedding and its norm
            out[key] = _pad_to(value, (pads[0], *value.shape[1:]))
        elif index % 2 == 1:  # the blocks of stage (index - 1) / 2
            s = (index - 1) // 2
            cr, cp, hp = reals[s], pads[s], pads[s] // hd
            name = rest.split(".", 1)[1]
            if cr == cp:
                out[key] = value.clone()
            elif name.startswith(("norm1.", "norm2.")) or name in ("mlp.3.bias", "attn.proj.bias"):
                out[key] = _pad_to(value, (cp,))
            elif name == "mlp.0.weight":  # (dh, cr) -> (dh, cp)
                out[key] = _pad_to(value, (value.shape[0], cp))
            elif name == "mlp.3.weight":  # (cr, dh) -> (cp, dh)
                out[key] = _pad_to(value, (cp, value.shape[1]))
            elif name == "attn.qkv.weight":  # (3 cr, cr): the q, k and v sections padded one by one
                out[key] = _pad_to(value.reshape(3, cr, cr), (3, cp, cp)).reshape(3 * cp, cp)
            elif name == "attn.qkv.bias":
                out[key] = _pad_to(value.reshape(3, cr), (3, cp)).reshape(3 * cp)
            elif name == "attn.proj.weight":
                out[key] = _pad_to(value, (cp, cp))
            elif name == "attn.relative_position_bias_table":
                out[key] = _pad_to(value, (value.shape[0], hp))
            elif name == "attn.logit_scale":
                out[key] = _pad_to(value, (hp, 1, 1), math.log(10.0))
            elif name == "attn.cpb_mlp.2.weight":  # (heads, 512)
                out[key] = _pad_to(value, (hp, value.shape[1]))
            else:  # mlp.0.bias, attn.cpb_mlp.0: independent of the channels
                out[key] = value.clone()
        else:  # patch merging into stage index / 2
            s = index // 2
            pr, pp, orr, op = reals[s - 1], pads[s - 1], reals[s], pads[s]
            if pr == pp and orr == op:
                out[key] = value.clone()
            elif rest.startswith("norm."):
                if v2:  # LayerNorm over the 2C output
                    out[key] = _pad_to(value, (op,))
                else:   # LayerNorm over the 4C concat: four groups of pr channels
                    out[key] = _pad_to(value.reshape(4, pr), (4, pp)).reshape(4 * pp)
            else:  # reduction.weight (orr, 4 pr) -> (op, 4 pp)
                out[key] = _pad_to(value.reshape(orr, 4, pr), (op, 4, pp)).reshape(op, 4 * pp)
    return out


@register_model("swin_t_padded")
def swin_t_padded(*, num_classes: int = 1000, dtype: torch.dtype = torch.float32, device=None,
                  generator: Optional[torch.Generator] = None, sd_prob: float = _SWIN_T["sd_prob"],
                  **kwargs) -> SwinTransformer:
    """Swin-T with channels padded to multiples of 128: ``dtype`` float32 or
    bfloat16, ``generator`` seeds a native Swin-T whose parameters are padded,
    ``device`` defaults to the first CUDA card, ``sd_prob`` is the stochastic
    depth of the last block; other keywords go to ``SwinTransformer``."""
    cfg = {**_SWIN_T, "sd_prob": sd_prob}
    native = SwinTransformer(**cfg, num_classes=num_classes, generator=generator)
    model = SwinTransformer(**cfg, num_classes=num_classes, dtype=dtype, pad_channels=True, **kwargs)
    model.load_state_dict(pad_swin_state_dict(native.state_dict()))
    return model.to("cuda" if device is None else device)
