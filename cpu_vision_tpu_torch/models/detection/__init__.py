"""Detection models and their building blocks (counterpart of the JAX
package's ``models/detection``): Faster R-CNN ResNet-50 FPN v1 and v2,
serving, with ``detect`` as the entry point.  RetinaNet, FCOS, SSD, Mask and
Keypoint R-CNN, the MobileNet backbones and training are not ported yet."""

from ._utils import BoxCoder  # noqa: F401
from .anchor_utils import AnchorGenerator  # noqa: F401
from .backbone_utils import BackboneWithFPN, FeaturePyramidNetwork, LastLevelMaxPool  # noqa: F401
from .faster_rcnn import FasterRCNN, fasterrcnn_resnet50_fpn, fasterrcnn_resnet50_fpn_v2  # noqa: F401
from .generalized_rcnn import detect  # noqa: F401
from .roi_heads import FastRCNNConvFCHead, FastRCNNPredictor, RoIHeads, TwoMLPHead  # noqa: F401
from .rpn import RegionProposalNetwork, RPNHead  # noqa: F401
from .transform import GeneralizedRCNNTransform  # noqa: F401
