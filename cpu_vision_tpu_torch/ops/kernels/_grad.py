"""Gradients of the kernels: forward by the kernel, backward by recomputing
the plain twin.

Counterpart of the JAX package's ``custom_vjp``s around its Pallas kernels
(``ops/pallas/transformer_block.py:_bwd``/``_attn_bwd``,
``flash_attention.py:_bwd``): the forward saves only its inputs, and the
backward runs the plain math again under autograd and differentiates it.
Nothing of the forward's intermediates is kept, and under ``no_grad`` (or
when no input asks for a gradient) nothing is saved at all.  The backward's
products take the twin's compute dtype: full float32 for a float32 twin; for
a bfloat16 one, TF32 tensor cores, which multiply bfloat16 values exactly and
round a float32 cotangent to 10 mantissa bits (the bfloat16 routes round it
to 7).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..._dtype import float32_products

__all__ = ["recompute_backward"]


class _RecomputeBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, twin, dtype, *args):
        ctx.twin, ctx.dtype = twin, dtype
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.args = [None if i in ctx.tensor_at else a for i, a in enumerate(args)]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad):
        args = list(ctx.args)
        wanted = []
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(ctx.needs_input_grad[3 + i])
            if ctx.needs_input_grad[3 + i]:
                wanted.append(i)
        with torch.enable_grad(), float32_products(ctx.dtype):
            out = ctx.twin(*args)
            grads = torch.autograd.grad(out, [args[i] for i in wanted], grad, allow_unused=True)
        by_position = dict(zip(wanted, grads))
        return (None, None, None, *(by_position.get(i) for i in range(len(args))))


def recompute_backward(kernel: Callable, twin: Callable, *args, dtype: torch.dtype):
    """``kernel(*args)``, differentiable: the gradient of each tensor in
    ``args`` is that of ``twin(*args)`` (the same function in plain operators,
    whose products take operands of ``dtype`` and sum in float32), recomputed
    from the saved inputs in the backward.  Each gradient comes back in its
    input's dtype.  Without grad mode, or when no tensor of ``args`` requires
    a gradient, this is ``kernel(*args)`` and nothing is saved."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return _RecomputeBackward.apply(kernel, twin, dtype, *args)
    return kernel(*args)
