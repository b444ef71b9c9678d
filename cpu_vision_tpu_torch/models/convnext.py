"""ConvNeXt family (reference ``torchvision/models/convnext.py``): a block is
a 7×7 depthwise convolution, LayerNorm, a 4× MLP with a per-channel layer
scale and a residual; a patchify stem; LayerNorm + 2×2 downsampling between
the stages.

Counterpart of the JAX package's ``models/convnext.py``: serving
(``forward(x)``, under ``no_grad``) and training (``forward(x, train=True,
generator=g)``, with stochastic depth drawn from ``g``).  Input is NHWC,
parameters are float32 under torchvision's ``state_dict`` keys (``features.0.{0,1}``,
``features.{s}.{j}.block.{0,2,3,5}`` and ``.layer_scale`` (C, 1, 1),
downsampling ``features.{s}.{0,1}``, ``classifier.{0,2}``), and ``dtype``
(float32 or bfloat16) is the compute dtype of activations and weights.

Routes of each block, chosen with ``mlp=`` and ``depthwise=``:

* ``mlp="block"``: ``kernels.cn_mlp_block``, everything after the depthwise
  convolution (LayerNorm, both products, gelu, layer scale, residual) in one
  kernel; ``"plain"``: stock PyTorch operators, its oracle, with the block's
  stochastic depth on the branch; ``None``: the JAX package's rule
  (``models/convnext.py:32``), the fused kernel when serving, and under
  training wherever the block's stochastic depth is 0 (block ``i`` of
  ``total`` drops its branch with probability
  ``sd_prob · i / max(total − 1, 1)``), the plain tail elsewhere.  Under
  training ``"block"`` raises on a block whose stochastic depth is above 0.
* ``depthwise="kernel"``: ``kernels.depthwise_conv2d``; ``"stock"``:
  ``F.conv2d(groups=C)``; ``None``: the JAX package's rule, where its
  depthwise kernel is opt-in, so stock.

The 4×4/4 stem and the 2×2/2 downsampling convolutions read each input
element once; they run as space-to-depth and one stock matrix product
(``PatchifyDense``), as the JAX package leaves them to its compiler.  A
kernel route launches its kernel on CUDA tensors, or raises where the kernel
does not take the widths, and runs the kernel's plain twin on CPU tensors; no
route gives way to another.  The stochastic depth of the blocks that drop
is drawn from ``generator`` in block order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._dtype import full_float32
from .._layout import as_tensor
from ..ops.kernels.transformer_block import cn_mlp_block
from ._api import register_model
from .layers import DepthwiseConv, Packed, PatchifyDense, StochasticDepth, layer_norm, lecun_normal_

__all__ = ["ConvNeXt", "CNBlock", "convnext_tiny", "convnext_small", "convnext_base", "convnext_large"]

MLP_ROUTES = ("block", "plain")
LN_EPS = 1e-6


class CNBlock(nn.Module):
    """(reference ``convnext.py:CNBlock``) on NHWC maps.  ``block`` keeps the
    reference's indices: 0 the depthwise convolution, 2 the LayerNorm, 3 and 5
    the two products (1, 4 and 6 hold its permutes and GELU)."""

    def __init__(self, dim: int, layer_scale: float, sd_prob: float, dtype: torch.dtype = torch.float32,
                 mlp: Optional[str] = None, depthwise: Optional[str] = None):
        super().__init__()
        if mlp not in (None, *MLP_ROUTES):
            raise ValueError(f"mlp is None or one of {MLP_ROUTES}, got {mlp!r}")
        self.dim, self.dtype, self.mlp_route = dim, dtype, mlp
        self.block = nn.Sequential(
            DepthwiseConv(dim, (7, 7), padding=[(3, 3), (3, 3)], dtype=dtype, backend=depthwise),
            nn.Identity(), nn.LayerNorm(dim, eps=LN_EPS), nn.Linear(dim, 4 * dim), nn.GELU(),
            nn.Linear(4 * dim, dim), nn.Identity())
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), float(layer_scale)))
        self.stochastic_depth = StochasticDepth(sd_prob, "row")
        self._packed = Packed()

    def route(self, train: bool = False) -> str:
        """The tail's route, serving or under training (``train``)."""
        drops = train and self.stochastic_depth.p > 0.0
        if self.mlp_route is None:
            return "plain" if drops else "block"
        if drops and self.mlp_route == "block":
            raise ValueError(f'mlp="block" has no branch to drop: under training at stochastic depth '
                             f'{self.stochastic_depth.p} use mlp=None or "plain"')
        return self.mlp_route

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        c = self.dim
        out = self.block[0](x)
        ln, fc1, fc2 = self.block[2], self.block[3], self.block[5]
        scale = self.layer_scale.reshape(c)
        if self.route(train) == "block":
            w1, w2 = self._packed.transposed(self.dtype, fc1.weight, fc2.weight)
            fused = cn_mlp_block(out.reshape(-1, c), x.reshape(-1, c), ln.weight, ln.bias, w1, fc1.bias, w2,
                                 fc2.bias, scale, LN_EPS)
            return fused.reshape(x.shape)
        out = layer_norm(out, ln, self.dtype)
        out = F.gelu(F.linear(out, fc1.weight.to(self.dtype), fc1.bias.to(self.dtype)))
        out = F.linear(out, fc2.weight.to(self.dtype), fc2.bias.to(self.dtype))
        return x + self.stochastic_depth(out * scale.to(self.dtype), train, generator)


class ConvNeXt(nn.Module):
    """ConvNeXt for NHWC images whose sides are multiples of 4.  ``forward``
    takes a tensor on the parameters' device, or a numpy array, which goes to
    the card."""

    def __init__(self, block_dims: Sequence[int], block_depths: Sequence[int], sd_prob: float = 0.1,
                 layer_scale: float = 1e-6, num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                 in_channels: int = 3, mlp: Optional[str] = None, depthwise: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype is float32 or bfloat16, got {dtype}")
        if len(block_dims) != len(block_depths) or not block_dims:
            raise ValueError("block_dims and block_depths name the same stages")
        self.block_dims, self.block_depths, self.dtype = tuple(block_dims), tuple(block_depths), dtype
        total = sum(block_depths)
        stages = [nn.Sequential(PatchifyDense(in_channels, block_dims[0], (4, 4), dtype),
                                nn.LayerNorm(block_dims[0], eps=LN_EPS))]
        bid = 0
        for stage, (dim, depth) in enumerate(zip(block_dims, block_depths)):
            if stage > 0:
                prev = block_dims[stage - 1]
                stages.append(nn.Sequential(nn.LayerNorm(prev, eps=LN_EPS), PatchifyDense(prev, dim, (2, 2), dtype)))
            blocks = []
            for _ in range(depth):
                blocks.append(CNBlock(dim, layer_scale, sd_prob * bid / max(total - 1.0, 1.0), dtype, mlp, depthwise))
                bid += 1
            stages.append(nn.Sequential(*blocks))
        self.features = nn.Sequential(*stages)
        last = block_dims[-1]
        self.classifier = nn.Sequential(nn.LayerNorm(last, eps=LN_EPS), nn.Identity(), nn.Linear(last, num_classes))
        self.reset_parameters(generator)
        self.eval()

    def blocks(self):
        """Every ``CNBlock``, in order."""
        return [m for m in self.features.modules() if isinstance(m, CNBlock)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX module's initialisers (variance-scaling normal products and
        convolutions, zero biases; the layer scale keeps its constant) drawn
        from ``generator``; not the JAX package's values for the same seed."""
        for module in self.modules():
            if isinstance(module, (PatchifyDense, DepthwiseConv)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                nn.init.zeros_(module.bias)
            elif isinstance(module, nn.Linear):
                lecun_normal_(module.weight, module.in_features, generator)
                nn.init.zeros_(module.bias)

    def routes(self, train: bool = False) -> List[Tuple[str, str]]:
        """[(mlp route, depthwise route)] of every block, serving or under training (``train``)."""
        return [(block.route(train), "kernel" if block.block[0].backend == "kernel" else "stock")
                for block in self.blocks()]

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits of NHWC images ``x``.  Serving (``train=False``) runs under
        ``no_grad``; ``train=True`` records the graph for a backward and draws
        the stochastic depth of each block from ``generator`` (on ``x``'s
        device; torch's default generator without one)."""
        if not train:
            with torch.no_grad():
                return self._forward(x, False, None)
        return self._forward(x, True, generator)

    def _forward(self, x, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        x = as_tensor(x)
        with full_float32():
            for i, stage in enumerate(self.features):
                if i == 0:
                    x = layer_norm(stage[0](x), stage[1], self.dtype)
                elif i % 2 == 0:  # LayerNorm, then the 2x2/2 convolution (VALID: an odd last row or column is dropped)
                    x = layer_norm(x, stage[0], self.dtype)
                    x = stage[1](x[:, : x.shape[1] // 2 * 2, : x.shape[2] // 2 * 2])
                else:
                    for block in stage:
                        x = block(x, train, generator)
            x = layer_norm(x.mean(dim=(1, 2)), self.classifier[0], self.dtype)
            head = self.classifier[2]
            return F.linear(x, head.weight.to(self.dtype), head.bias.to(self.dtype))


def _make(name: str, dims: Sequence[int], depths: Sequence[int], sd: float):
    def build(*, num_classes: int = 1000, dtype: torch.dtype = torch.float32, device=None, sd_prob: float = sd,
              **kwargs):
        model = ConvNeXt(dims, depths, sd_prob, num_classes=num_classes, dtype=dtype, **kwargs)
        return model.to("cuda" if device is None else device)

    build.__name__ = name
    build.__doc__ = (f"{name}: ``dtype`` float32 or bfloat16, ``generator`` seeds the parameters, ``device`` "
                     f"defaults to the first CUDA card, ``sd_prob`` (default {sd}) is the stochastic depth of the "
                     "last block; other keywords go to ``ConvNeXt``.")
    return register_model(name)(build)


convnext_tiny = _make("convnext_tiny", (96, 192, 384, 768), (3, 3, 9, 3), 0.1)
convnext_small = _make("convnext_small", (96, 192, 384, 768), (3, 3, 27, 3), 0.4)
convnext_base = _make("convnext_base", (128, 256, 512, 1024), (3, 3, 27, 3), 0.5)
convnext_large = _make("convnext_large", (192, 384, 768, 1536), (3, 3, 27, 3), 0.5)
