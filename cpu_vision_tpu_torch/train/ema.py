"""Model EMA (PyTorch).

Counterpart of the JAX package's ``train/ema.py`` (the reference's
``references/classification/utils.py:ExponentialMovingAverage``).
"""

from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn

__all__ = ["ExponentialMovingAverage"]


class ExponentialMovingAverage:
    """``ema = decay · ema + (1 − decay) · params`` at every ``update``.

    ``model_or_params`` is a module, whose floating-point parameters and
    buffers by name are tracked, or a dict of tensors by name; the average
    starts as a detached copy of them.  ``update`` takes the same kind of
    argument.
    """

    def __init__(self, model_or_params: Union[nn.Module, Dict[str, torch.Tensor]], decay: float = 0.999):
        self.decay = decay
        self.params = {k: v.detach().clone() for k, v in self._tensors(model_or_params).items()}

    @staticmethod
    def _tensors(model_or_params) -> Dict[str, torch.Tensor]:
        if isinstance(model_or_params, nn.Module):
            return {k: v for k, v in model_or_params.state_dict().items() if v.dtype.is_floating_point}
        return dict(model_or_params)

    @torch.no_grad()
    def update(self, model_or_params: Union[nn.Module, Dict[str, torch.Tensor]]) -> None:
        new = self._tensors(model_or_params)
        if new.keys() != self.params.keys():
            raise ValueError("update takes the tensors the average was made of")
        d = self.decay
        self.params = {k: d * e + (1.0 - d) * new[k].detach() for k, e in self.params.items()}

    def state_dict(self) -> dict:
        return {"decay": self.decay, "params": self.params}
