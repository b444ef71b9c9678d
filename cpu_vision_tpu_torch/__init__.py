"""cpu_vision_tpu_torch — the PyTorch/CUDA port of ``cpu_vision_tpu``.

Same public functions, semantics and module layout as the JAX package,
on PyTorch tensors, with the fused stencil pipelines, the CNN's fused conv
stage and the transformer encoder's attention and MLP sub-blocks as
hand-written CUDA kernels for Hopper (``ops/kernels``, sources in
``csrc/``).  Images are
channels-last (HW / HWC / NHWC).  A tensor is computed on its own device;
any other input (a numpy array) goes to the first CUDA card.

Subpackages
-----------
``ops``   color, filters (blur, Sobel, ...), Canny and Harris, resize,
          pyramids, warps, the small CNN, boxes and NMS, RoIAlign, the
          pointwise convolution (``conv1x1``, its weight gradient a kernel),
          and the fused kernels in ``ops.kernels``
``models``  the model registry (``get_model``), the Vision Transformers,
          Swin and ConvNeXt on the transformer kernels, the ResNet family
          on stock operators, Faster R-CNN (``models.detection``, its NMS
          on the ``nms_sorted`` kernel), and the carriers of the JAX
          package's parameters
``parallel``  ``make_train_step``: one training step on one device (ViT,
          ResNet, Swin, ConvNeXt and the CNN)
``train``  metrics (``MetricLogger``, ``accuracy``), the model EMA and
          checkpoints on ``torch.save``
``graft_entry``  ``entry()``: the ResNet-50 forward step
"""

__version__ = "0.1.0"

from . import _dtype, _layout, graft_entry, models, ops, parallel, train  # noqa: F401
from ._dtype import to_dtype  # noqa: F401
