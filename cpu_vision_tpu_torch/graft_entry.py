"""Entry point of the port's flagship model, the counterpart of the JAX
package's ``__graft_entry__.entry``.

``entry()`` returns ``(forward, (model, images))``: ResNet-50 in float32 with
parameters drawn from seed 0, and four 224x224 RGB images drawn from numpy
seed 0, both on the first CUDA card (``device="cpu"`` keeps them on the CPU).
``forward(model, images)`` gives the (4, 1000) logits.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entry"]


def entry(device=None):
    """(fn, example_args): the single-card forward step of ResNet-50."""
    from . import models

    device = "cuda" if device is None else device
    model = models.resnet50(generator=torch.Generator().manual_seed(0), device=device)

    def forward(model, images):
        return model(images, train=False)

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((4, 224, 224, 3), dtype=np.float32)).to(device)
    return forward, (model, images)
