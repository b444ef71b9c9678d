"""Carriers of the JAX package's parameters into the port's models.

``vit_state_dict_from_numpy`` and ``resnet_state_dict_from_numpy`` turn the
flax variable trees of the JAX package's ``VisionTransformer`` and ``ResNet``,
given as nested dicts of numpy arrays, into ``state_dict``s under
torchvision's keys, which the port's models load.  They are the inverses of
the JAX package's ``models.torch_weights.vit_from_torch`` and
``resnet_from_torch``, and extend what ``ops.cnn_params_from_numpy`` began:

* HWIO convolution kernel → (O, I, kH, kW) ``weight``;
* (I, O) dense kernel → (O, I) ``weight``;
* flax attention's query/key/value kernels (D, H, hd) → the packed
  ``in_proj_weight`` (3D, D), its out kernel (H, hd, D) → ``out_proj.weight``;
* batch-norm scale/bias → ``weight``/``bias``, batch_stats mean/var →
  ``running_mean``/``running_var`` (``num_batches_tracked`` is 0).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = ["vit_state_dict_from_numpy", "resnet_state_dict_from_numpy"]

StateDict = Dict[str, torch.Tensor]


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _conv(kernel: Any) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _dense(sd: StateDict, prefix: str, leaf: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(leaf["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(leaf["bias"])


def _norm(sd: StateDict, prefix: str, leaf: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(leaf["scale"])
    sd[f"{prefix}.bias"] = _t(leaf["bias"])


def vit_state_dict_from_numpy(params: Mapping[str, Any], num_layers: int, num_heads: int) -> StateDict:
    """The flax variables of the JAX package's ``VisionTransformer``
    (``{"params": ...}`` or the params tree itself) as a ``state_dict`` of the
    port's ``VisionTransformer``."""
    p = params.get("params", params)
    d = np.asarray(p["class_token"]).shape[-1]
    if d % num_heads:
        raise ValueError(f"hidden dim {d} is not a multiple of num_heads {num_heads}")
    sd: StateDict = {
        "conv_proj.weight": _conv(p["Conv_0"]["kernel"]),
        "conv_proj.bias": _t(p["Conv_0"]["bias"]),
        "class_token": _t(p["class_token"]),
        "encoder.pos_embedding": _t(p["pos_embedding"]),
    }
    for i in range(num_layers):
        layer = p[f"encoder_{i}"]
        t = f"encoder.layers.encoder_layer_{i}"
        mha = layer["MultiHeadDotProductAttention_0"]
        _norm(sd, f"{t}.ln_1", layer["LayerNorm_0"])
        qkv = [mha[name] for name in ("query", "key", "value")]
        sd[f"{t}.self_attention.in_proj_weight"] = _t(
            np.concatenate([np.asarray(leaf["kernel"]).reshape(d, d).T for leaf in qkv], axis=0))
        sd[f"{t}.self_attention.in_proj_bias"] = _t(
            np.concatenate([np.asarray(leaf["bias"]).reshape(d) for leaf in qkv]))
        sd[f"{t}.self_attention.out_proj.weight"] = _t(np.asarray(mha["out"]["kernel"]).reshape(d, d).T)
        sd[f"{t}.self_attention.out_proj.bias"] = _t(mha["out"]["bias"])
        _norm(sd, f"{t}.ln_2", layer["LayerNorm_1"])
        _dense(sd, f"{t}.mlp.0", layer["Dense_0"])
        _dense(sd, f"{t}.mlp.3", layer["Dense_1"])
    _norm(sd, "encoder.ln", p["LayerNorm_0"])
    _dense(sd, "heads.head", p["Dense_0"])
    return sd


def _batch_norm(sd: StateDict, prefix: str, leaf: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    _norm(sd, prefix, leaf)
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def resnet_state_dict_from_numpy(variables: Mapping[str, Any], layers: Sequence[int], bottleneck: bool) -> StateDict:
    """The flax variables ``{"params": ..., "batch_stats": ...}`` of the JAX
    package's ``ResNet`` as a ``state_dict`` of the port's ``ResNet``.
    ``layers`` e.g. (3, 4, 6, 3); ``bottleneck`` names the block type."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {"conv1.weight": _conv(p["Conv_0"]["kernel"])}
    _batch_norm(sd, "bn1", p["BatchNorm_0"], s["BatchNorm_0"])
    n_convs = 3 if bottleneck else 2
    for stage, n_blocks in enumerate(layers, start=1):
        for blk in range(n_blocks):
            bp, bs = p[f"layer{stage}_{blk}"], s[f"layer{stage}_{blk}"]
            t = f"layer{stage}.{blk}"
            for ci in range(n_convs):
                sd[f"{t}.conv{ci + 1}.weight"] = _conv(bp[f"Conv_{ci}"]["kernel"])
                _batch_norm(sd, f"{t}.bn{ci + 1}", bp[f"BatchNorm_{ci}"], bs[f"BatchNorm_{ci}"])
            if f"Conv_{n_convs}" in bp:
                sd[f"{t}.downsample.0.weight"] = _conv(bp[f"Conv_{n_convs}"]["kernel"])
                _batch_norm(sd, f"{t}.downsample.1", bp[f"BatchNorm_{n_convs}"], bs[f"BatchNorm_{n_convs}"])
    _dense(sd, "fc", p["Dense_0"])
    return sd
