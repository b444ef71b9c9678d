"""End-to-end detection serving (counterpart of the JAX package's
``models/detection/generalized_rcnn.py``; reference
``torchvision/models/detection/generalized_rcnn.py:15`` + ``transform.py:257``):
images of any sizes -> normalised fixed canvas -> detector -> detections in
each image's own coordinates.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from .transform import GeneralizedRCNNTransform

__all__ = ["detect"]


def detect(model, images: Sequence, transform: GeneralizedRCNNTransform = None) -> List[Dict[str, Any]]:
    """Run an R-CNN ``model`` (one that returns the padded detections dict)
    over a list of HWC float images of any sizes (numpy arrays go to the
    card).  The port's modules hold their parameters, so there is no
    ``variables`` argument; the JAX package's branch for models that return
    raw head outputs (RetinaNet, FCOS, SSD) waits for those models.  Returns
    one dict an image, boxes in the image's own coordinates, with its scores,
    labels and valid flags.
    """
    transform = transform or GeneralizedRCNNTransform(min_size=320, max_size=640)
    batch, _, scales = transform(list(images))
    dets = model(batch)
    results = []
    for i in range(batch.shape[0]):
        entry = {k: v[i] for k, v in dets.items() if k != "boxes"}
        entry["boxes"] = transform.postprocess_boxes(dets["boxes"][i], scales, i)
        results.append(entry)
    return results
