"""Carriers of the JAX package's parameters into the port's models.

``vit_state_dict_from_numpy``, ``resnet_state_dict_from_numpy``,
``swin_state_dict_from_numpy``, ``convnext_state_dict_from_numpy`` and
``faster_rcnn_state_dict_from_numpy`` turn the flax variable trees of the JAX
package's ``VisionTransformer``, ``ResNet``, ``SwinTransformer``, ``ConvNeXt``
and ``FasterRCNN``, given as nested dicts of numpy arrays, into
``state_dict``s under torchvision's keys, which the port's models load.  They
are the inverses of the JAX package's ``models.torch_weights``
``vit_from_torch``, ``resnet_from_torch``, ``swin_from_torch``,
``convnext_from_torch`` and ``faster_rcnn_from_torch``, and extend what
``ops.cnn_params_from_numpy`` began:

* HWIO convolution kernel → (O, I, kH, kW) ``weight``;
* (I, O) dense kernel → (O, I) ``weight``;
* flax attention's query/key/value kernels (D, H, hd) → the packed
  ``in_proj_weight`` (3D, D), its out kernel (H, hd, D) → ``out_proj.weight``;
* batch-norm scale/bias → ``weight``/``bias``, batch_stats mean/var →
  ``running_mean``/``running_var`` (``num_batches_tracked`` is 0);
* a dense kernel over a flattened HWC map → torchvision's ``weight`` over
  the CHW flattening (Faster R-CNN's ``fc6``).

``int8_scales_from_numpy`` carries the calibrated ``scales`` of the JAX
package's ``Int8ViT`` or ``Int8ResNet`` into the port's engine of the same
model (the weights cross as above).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = ["vit_state_dict_from_numpy", "resnet_state_dict_from_numpy", "swin_state_dict_from_numpy",
           "convnext_state_dict_from_numpy", "faster_rcnn_state_dict_from_numpy", "int8_scales_from_numpy"]

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
    if "Dense_0" in p:  # a detector's body has no classifier
        _dense(sd, "fc", p["Dense_0"])
    return sd


def swin_state_dict_from_numpy(params: Mapping[str, Any], depths: Sequence[int] = (2, 2, 6, 2)) -> StateDict:
    """The flax variables of the JAX package's ``SwinTransformer``, v1 or v2
    (``{"params": ...}`` or the params tree itself), as a ``state_dict`` of the
    port's ``SwinTransformer``.  A block with a ``logit_scale`` is a v2 block."""
    p = params.get("params", params)
    sd: StateDict = {"features.0.0.weight": _conv(p["Conv_0"]["kernel"]), "features.0.0.bias": _t(p["Conv_0"]["bias"])}
    _norm(sd, "features.0.2", p["LayerNorm_0"])
    bid = 0
    for stage, depth in enumerate(depths):
        if stage > 0:
            merging = p[f"PatchMerging_{stage - 1}"]
            _norm(sd, f"features.{2 * stage}.norm", merging["LayerNorm_0"])
            sd[f"features.{2 * stage}.reduction.weight"] = _t(np.asarray(merging["Dense_0"]["kernel"]).T)
        for blk in range(depth):
            block = p[f"SwinBlock_{bid}"]
            attn = block["WindowAttention_0"]
            t = f"features.{2 * stage + 1}.{blk}"
            _norm(sd, f"{t}.norm1", block["LayerNorm_0"])
            _dense(sd, f"{t}.attn.qkv", attn["qkv"])
            _dense(sd, f"{t}.attn.proj", attn["proj"])
            if "logit_scale" in attn:
                sd[f"{t}.attn.logit_scale"] = _t(attn["logit_scale"])
                _dense(sd, f"{t}.attn.cpb_mlp.0", attn["cpb_fc1"])
                sd[f"{t}.attn.cpb_mlp.2.weight"] = _t(np.asarray(attn["cpb_fc2"]["kernel"]).T)
            else:
                sd[f"{t}.attn.relative_position_bias_table"] = _t(attn["relative_position_bias_table"])
            _norm(sd, f"{t}.norm2", block["LayerNorm_1"])
            _dense(sd, f"{t}.mlp.0", block["Dense_0"])
            _dense(sd, f"{t}.mlp.3", block["Dense_1"])
            bid += 1
    _norm(sd, "norm", p["LayerNorm_1"])
    _dense(sd, "head", p["Dense_0"])
    return sd


def convnext_state_dict_from_numpy(params: Mapping[str, Any]) -> StateDict:
    """The flax variables of the JAX package's ``ConvNeXt`` (``{"params": ...}``
    or the params tree itself) as a ``state_dict`` of the port's ``ConvNeXt``.
    The stages' depths are read off the tree: a stage ends where the channel
    count of the blocks changes."""
    p = params.get("params", params)
    sd: StateDict = {"features.0.0.weight": _conv(p["Conv_0"]["kernel"]), "features.0.0.bias": _t(p["Conv_0"]["bias"])}
    _norm(sd, "features.0.1", p["LayerNorm_0"])
    n_blocks = sum(1 for key in p if key.startswith("CNBlock_"))
    stage, index, width = 0, 0, None
    for bi in range(n_blocks):
        block = p[f"CNBlock_{bi}"]
        dim = np.asarray(block["layer_scale"]).shape[0]
        if width is not None and dim != width:  # the downsampling layer before the next stage
            stage, index = stage + 1, 0
            _norm(sd, f"features.{2 * stage}.0", p[f"LayerNorm_{stage}"])
            sd[f"features.{2 * stage}.1.weight"] = _conv(p[f"Conv_{stage}"]["kernel"])
            sd[f"features.{2 * stage}.1.bias"] = _t(p[f"Conv_{stage}"]["bias"])
        width = dim
        t = f"features.{2 * stage + 1}.{index}"
        sd[f"{t}.block.0.weight"] = _conv(block["Conv_0"]["kernel"])
        sd[f"{t}.block.0.bias"] = _t(block["Conv_0"]["bias"])
        _norm(sd, f"{t}.block.2", block["LayerNorm_0"])
        _dense(sd, f"{t}.block.3", block["Dense_0"])
        _dense(sd, f"{t}.block.5", block["Dense_1"])
        sd[f"{t}.layer_scale"] = _t(np.asarray(block["layer_scale"]).reshape(dim, 1, 1))
        index += 1
    _norm(sd, "classifier.0", p[f"LayerNorm_{stage + 1}"])
    _dense(sd, "classifier.2", p["Dense_0"])
    return sd


def _dense_from_hwc(sd: StateDict, prefix: str, leaf: Mapping[str, Any], c: int, h: int, w: int) -> None:
    """A dense kernel (H*W*C, O) over a flattened HWC map as torchvision's
    (O, C*H*W) ``weight`` over the CHW flattening."""
    kernel = np.asarray(leaf["kernel"])
    sd[f"{prefix}.weight"] = _t(kernel.T.reshape(-1, h, w, c).transpose(0, 3, 1, 2).reshape(kernel.shape[1], -1))
    sd[f"{prefix}.bias"] = _t(leaf["bias"])


def _conv_bias(sd: StateDict, prefix: str, leaf: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _conv(leaf["kernel"])
    sd[f"{prefix}.bias"] = _t(leaf["bias"])


FASTER_RCNN_ARCHS = ("fasterrcnn_resnet50_fpn", "fasterrcnn_resnet50_fpn_v2")


def faster_rcnn_state_dict_from_numpy(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                                      arch: str = "fasterrcnn_resnet50_fpn") -> StateDict:
    """The flax variables of the JAX package's ``FasterRCNN`` (ResNet-50 FPN,
    ``arch`` v1 or v2) as a ``state_dict`` of the port's ``FasterRCNN``."""
    if arch not in FASTER_RCNN_ARCHS:
        raise ValueError(f"arch must be one of {FASTER_RCNN_ARCHS}, got {arch!r}")
    v2 = arch.endswith("_v2")
    bb_p, bb_s = params["backbone"], batch_stats["backbone"]
    body = resnet_state_dict_from_numpy({"params": bb_p["backbone"], "batch_stats": bb_s["backbone"]},
                                        (3, 4, 6, 3), True)
    sd: StateDict = {f"backbone.body.{k}": v for k, v in body.items()}
    fpn_p = bb_p["FeaturePyramidNetwork_0"]
    fpn_s = bb_s.get("FeaturePyramidNetwork_0", {})
    for i, name in enumerate(("layer1", "layer2", "layer3", "layer4")):
        for tset, oset in (("inner_blocks", "inner"), ("layer_blocks", "layer")):
            t = f"backbone.fpn.{tset}.{i}"
            if v2:
                sd[f"{t}.0.weight"] = _conv(fpn_p[f"{oset}_{name}"]["kernel"])
                _batch_norm(sd, f"{t}.1", fpn_p[f"{oset}_bn_{name}"], fpn_s[f"{oset}_bn_{name}"])
            else:
                _conv_bias(sd, f"{t}.0", fpn_p[f"{oset}_{name}"])
    head = params["rpn"]["head"]
    _conv_bias(sd, "rpn.head.conv.0.0", head["conv"])
    if v2:
        _conv_bias(sd, "rpn.head.conv.1.0", head["conv1"])
    _conv_bias(sd, "rpn.head.cls_logits", head["cls_logits"])
    _conv_bias(sd, "rpn.head.bbox_pred", head["bbox_pred"])
    box_p = params["roi_heads"]["box_head"]
    if v2:
        box_s = batch_stats["roi_heads"]["box_head"]
        for i in range(4):
            sd[f"roi_heads.box_head.{i}.0.weight"] = _conv(box_p[f"Conv_{i}"]["kernel"])
            _batch_norm(sd, f"roi_heads.box_head.{i}.1", box_p[f"BatchNorm_{i}"], box_s[f"BatchNorm_{i}"])
        _dense_from_hwc(sd, "roi_heads.box_head.5", box_p["Dense_0"], 256, 7, 7)
    else:
        _dense_from_hwc(sd, "roi_heads.box_head.fc6", box_p["Dense_0"], 256, 7, 7)
        _dense(sd, "roi_heads.box_head.fc7", box_p["Dense_1"])
    pred = params["roi_heads"]["predictor"]
    _dense(sd, "roi_heads.box_predictor.cls_score", pred["Dense_0"])
    _dense(sd, "roi_heads.box_predictor.bbox_pred", pred["Dense_1"])
    return sd


def int8_scales_from_numpy(engine, scales: Mapping[str, Any]):
    """Set the activation scales of the port's ``Int8ViT`` or ``Int8ResNet``
    from the JAX engine's calibrated ``scales`` dict, given as numpy arrays
    (per-channel vectors for the ViT, scalars for the ResNet; the same site
    names), on the engine's device.  An ``Int8ViT`` re-quantises its weights
    with the scales folded into their rows, as its ``calibrate`` does.
    Returns the engine."""
    device = engine.fc_bias.device if hasattr(engine, "fc_bias") else engine.pos.device
    return engine.set_scales({k: _t(v).to(device) for k, v in scales.items()})
