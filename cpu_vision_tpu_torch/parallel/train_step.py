"""A training step on one device (PyTorch).

Counterpart of the JAX package's ``parallel/train_step.py:make_train_step``
(:56-82) without the mesh: ``loss_fn(model, batch) -> (loss, aux)`` is
differentiated and the model's parameters are updated in place by a
``torch.optim`` optimizer, where the JAX step returns new parameters and
optimizer state.  ``optax.sgd(lr, momentum=m)`` is ``torch.optim.SGD(lr=lr,
momentum=m)`` (dampening 0, no Nesterov): ``v ← m·v + g``, ``p ← p − lr·v``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from .._dtype import full_float32

__all__ = ["make_train_step"]


def make_train_step(loss_fn: Callable[[nn.Module, Any], Tuple[torch.Tensor, Any]],
                    optimizer: Optional[torch.optim.Optimizer] = None):
    """Build ``step(model, batch) -> (loss, aux)``: gradients of ``loss_fn``'s
    scalar loss, then one update of ``model``'s parameters in place.

    ``optimizer`` is one the caller built over ``model``'s parameters (say
    ``torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)``), and it
    holds any state, such as momentum; ``None`` is plain SGD with lr 0.01, as
    in the JAX package, which keeps no state.  A step raises if ``optimizer``
    does not hold every parameter of its model that requires a gradient.  The
    forward and the backward run float32 products and convolutions in full
    float32 (no TF32; a bfloat16 kernel's recomputed backward lets TF32
    multiply its bfloat16 values, ``ops.kernels._grad``).  The loss comes back
    detached.
    """
    held = set() if optimizer is None else {id(p) for group in optimizer.param_groups for p in group["params"]}

    def step(model: nn.Module, batch) -> Tuple[torch.Tensor, Any]:
        if optimizer is None:
            opt = torch.optim.SGD(model.parameters(), lr=0.01)
        elif all(id(p) in held for p in model.parameters() if p.requires_grad):
            opt = optimizer
        else:
            raise ValueError("the optimizer does not hold every trainable parameter of this model")
        model.zero_grad(set_to_none=True)
        with full_float32():
            loss, aux = loss_fn(model, batch)
            loss.backward()
        opt.step()
        return loss.detach(), aux

    return step
