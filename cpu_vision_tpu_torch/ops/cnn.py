"""``cnn_forward`` — the LeNet-style CNN forward op (PyTorch).

Counterpart of the JAX package's ``ops/cnn.py``: a pure-functional
conv→ReLU→pool→FC network.  Parameters are an explicit nested dict
(``{"conv0": {"w", "b"}, ..., "fc1": {...}, "fc2": {...}}``) with the JAX
package's layouts: HWIO conv weights, NHWC images, FC weights as
(in, out) with the flatten in NHWC order.  Each conv stage runs through
``kernels.conv3x3_relu_pool``; on the card that is the hand-written fused
kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .._layout import as_tensor
from .kernels.conv_block import conv3x3_relu_pool

__all__ = ["cnn_init", "cnn_forward", "cnn_params_from_numpy"]

Params = Dict[str, Dict[str, torch.Tensor]]


def cnn_init(
    generator: torch.Generator,
    input_hw: Tuple[int, int] = (28, 28),
    in_channels: int = 1,
    conv_channels: Sequence[int] = (32, 64),
    hidden: int = 128,
    num_classes: int = 10,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Params:
    """Initialise LeNet-style parameters (He-normal weights, zero biases)
    from ``generator``, on ``device`` (default: the first CUDA card).  The
    values are drawn on the generator's device, so a seed gives the same
    parameters wherever they end up; they are not the JAX package's for
    the same seed."""
    device = "cuda" if device is None else device

    def he(shape: Tuple[int, ...], fan_in: int) -> torch.Tensor:
        draw = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
        return (draw * math.sqrt(2.0 / fan_in)).to(device)

    params: Params = {}
    c_in = in_channels
    h, w = input_hw
    for i, c_out in enumerate(conv_channels):
        params[f"conv{i}"] = {"w": he((3, 3, c_in, c_out), 3 * 3 * c_in),
                              "b": torch.zeros(c_out, dtype=dtype, device=device)}
        c_in = c_out
        h, w = h // 2, w // 2
    flat = h * w * c_in
    params["fc1"] = {"w": he((flat, hidden), flat), "b": torch.zeros(hidden, dtype=dtype, device=device)}
    params["fc2"] = {"w": he((hidden, num_classes), hidden),
                     "b": torch.zeros(num_classes, dtype=dtype, device=device)}
    return params


def cnn_params_from_numpy(params: Mapping[str, Mapping[str, Any]], device=None) -> Params:
    """Carry the JAX package's ``cnn_init`` parameters, given as nested dicts
    of numpy arrays, into the port: same keys and layouts, float32 tensors
    on ``device`` (default: the first CUDA card)."""
    device = "cuda" if device is None else device
    return {
        layer: {name: torch.from_numpy(np.array(value, np.float32)).to(device) for name, value in leaves.items()}
        for layer, leaves in params.items()
    }


def cnn_forward(params: Params, images, backend: Optional[str] = None) -> torch.Tensor:
    """Forward pass: [conv3x3 same -> ReLU -> maxpool2] per conv layer, then
    flatten -> FC -> ReLU -> FC logits.  ``images`` is NHWC float32.

    ``backend`` selects the conv stage's route in
    ``kernels.conv3x3_relu_pool`` ("kernel", "plain", "stock"; None: the
    fused kernel on the card, its twin on the CPU).  A stage whose input has
    an odd height or width takes the "stock" route whatever ``backend``
    says: the fused stage is defined for even sizes only, and the stock
    operators floor as VALID pooling does.
    """
    x = as_tensor(images)
    i = 0
    while f"conv{i}" in params:
        p = params[f"conv{i}"]
        even = x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
        x = conv3x3_relu_pool(x, p["w"], p["b"], backend if even else "stock")
        i += 1
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]
