"""The port's Faster R-CNN ResNet-50 FPN, v1 and v2
(``cpu_vision_tpu_torch.models.detection``), against the JAX package's, with
the port's parameters carried into the JAX model by ``faster_rcnn_from_torch``
and back by ``faster_rcnn_state_dict_from_numpy``.

Full width (FPN 256, ``fc6`` 256·7·7 → 1024) and depth, with the small
settings of ``tests/test_faster_rcnn.py`` (5 classes, 200 / 64 proposals, 10
detections) on two unequal images on a 128x128 canvas, on the CPU.  The JAX
model is never initialised nor run eagerly: one jitted apply a variant
returns every stage's output.  Batch-norm statistics and scales and every
bias are randomised, so that no default value hides a mapping error.

Stage by stage, each fed the JAX model's own inputs to that stage:
* FPN features and head outputs within 1e-4·(1 + |ref|) (convolutions sum in
  another order on each side);
* the proposal filter and the postprocess fed the same head outputs: which
  scores survive (NMS, ``min_size``, the score threshold) exactly, boxes within
  1e-5·(1 + |ref|), scores within 1e-6;
* end to end through ``detect``: labels and valid flags exactly, boxes within
  1e-4·(1 + |ref|), on a seed whose every decision (top-k boundaries, IoUs
  against the NMS thresholds, FPN levels, the score threshold) stands further
  from its threshold than the two sides differ, which the test checks.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.models import detection as jdet
from cpu_vision_tpu.models import torch_weights
from cpu_vision_tpu.models.detection._utils import BoxCoder as JBoxCoder
from cpu_vision_tpu.models.detection.anchor_utils import AnchorGenerator as JAnchorGenerator
from cpu_vision_tpu_torch import models
from cpu_vision_tpu_torch.models import detection as det
from cpu_vision_tpu_torch.ops.boxes import box_iou, clip_boxes_to_image, nms, top_k
from cpu_vision_tpu_torch.ops.kernels.nms import nms_sorted_plain

CFG = dict(num_classes=5, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=64, max_detections=10)
ARCH = {"v1": "fasterrcnn_resnet50_fpn", "v2": "fasterrcnn_resnet50_fpn_v2"}
IMAGE_SIZES = ((100, 80), (64, 120))
TRANSFORM = dict(min_size=96, max_size=128)  # a 128x128 canvas
# Seeds of the randomised states and images whose decisions all clear the noise
# (seed 0 puts a kept RPN pair of v2 within 6e-6 of the 0.7 IoU threshold,
# against a difference of 9e-5 between the two runs' IoUs there)
SEED = {"v1": 0, "v2": 2}


def _randomised_state(rng, model):
    sd = model.state_dict()
    for key, value in sd.items():
        shape = tuple(value.shape)
        if key.endswith("running_var"):
            value.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32)))
        elif key.endswith("num_batches_tracked"):
            continue
        elif key.endswith(("running_mean", "bias")):
            value.copy_(torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32)))
        elif value.ndim == 1:  # batch-norm scales
            value.copy_(torch.from_numpy((1.0 + rng.normal(0, 0.2, shape)).astype(np.float32)))
    return sd


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _intermediates(mod, x):
    """The JAX ``FasterRCNN.__call__`` with every stage's output kept."""
    image_size = (x.shape[1], x.shape[2])
    feats = mod.backbone(x)
    props, prop_scores, (obj, deltas, _) = mod.rpn(feats, image_size)
    cl, bd = mod.roi_heads(feats[:-1], props, image_size)
    dets = mod.roi_heads.postprocess(cl, bd, props, image_size)
    return dict(feats=feats, props=props, prop_scores=prop_scores, obj=obj, deltas=deltas, cl=cl, bd=bd, dets=dets)


@pytest.fixture(scope="module", params=["v1", "v2"])
def stages(request):
    variant = request.param
    rng = np.random.default_rng(SEED[variant])
    model = models.get_model(ARCH[variant], device="cpu", generator=torch.Generator().manual_seed(0), **CFG)
    sd = _randomised_state(rng, model)
    variables = torch_weights.faster_rcnn_from_torch(sd, ARCH[variant])
    jmodel = jdet.FasterRCNN(variant=variant, **CFG)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, method=_intermediates))
    images = [rng.random((h, w, 3), dtype=np.float32) for h, w in IMAGE_SIZES]
    batch, _, _ = jdet.GeneralizedRCNNTransform(**TRANSFORM)([jnp.asarray(i) for i in images])
    out = _numpy_tree(apply(variables, batch))
    return SimpleNamespace(variant=variant, model=model, state=sd, variables=variables, apply=apply, images=images,
                           batch=np.asarray(batch), out=out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _within(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref) / (1 + np.abs(ref))
    assert float(err.max()) <= tol, float(err.max())


def _split_levels(flat, feats, per_location=3):
    sizes = [f.shape[1] * f.shape[2] * per_location for f in feats]
    return list(torch.split(flat, sizes, dim=1))


def test_carrier_round_trip(stages):
    arch = ARCH[stages.variant]
    tree = _numpy_tree(stages.variables)
    back = models.faster_rcnn_state_dict_from_numpy(tree["params"], tree["batch_stats"], arch)
    assert set(back) == set(stages.state)
    for key, value in stages.state.items():
        assert torch.equal(back[key], value), key
    again = _numpy_tree(torch_weights.faster_rcnn_from_torch(back, arch))
    flat, flat_again = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(again)
    assert len(flat) == len(flat_again) and all(np.array_equal(a, b) for a, b in zip(flat, flat_again))


def test_state_dict_keys_are_torchvisions(stages):
    keys = set(stages.state)
    common = {"backbone.body.conv1.weight", "backbone.body.layer4.2.bn3.running_var",
              "backbone.fpn.inner_blocks.3.0.weight", "backbone.fpn.layer_blocks.0.0.weight",
              "rpn.head.conv.0.0.weight", "rpn.head.conv.0.0.bias", "rpn.head.cls_logits.weight",
              "rpn.head.bbox_pred.bias", "roi_heads.box_predictor.cls_score.weight",
              "roi_heads.box_predictor.bbox_pred.bias"}
    if stages.variant == "v1":
        extra = {"backbone.fpn.inner_blocks.0.0.bias", "roi_heads.box_head.fc6.weight", "roi_heads.box_head.fc7.bias"}
    else:
        extra = {"backbone.fpn.inner_blocks.0.1.running_mean", "rpn.head.conv.1.0.weight",
                 "roi_heads.box_head.3.1.weight", "roi_heads.box_head.5.weight"}
    assert common | extra <= keys
    assert not any(k.startswith("backbone.body.fc") for k in keys)


def test_features_match(stages):
    feats = stages.model.backbone(_t(stages.batch))
    assert len(feats) == 5 and [tuple(f.shape) for f in feats] == [tuple(f.shape) for f in stages.out["feats"]]
    for got, ref in zip(feats, stages.out["feats"]):
        _within(got, ref, 1e-4)


def test_rpn_head_matches(stages):
    feats = [_t(f) for f in stages.out["feats"]]
    logits, deltas = stages.model.rpn.head(feats)
    _within(torch.cat(logits, 1), stages.out["obj"], 1e-4)
    _within(torch.cat(deltas, 1), stages.out["deltas"], 1e-4)


def test_anchors_match_jax():
    shapes = [(32, 32), (16, 16), (8, 8), (4, 4), (2, 2)]
    sizes, ratios = ((32,), (64,), (128,), (256,), (512,)), ((0.5, 1.0, 2.0),) * 5
    got = det.AnchorGenerator(sizes, ratios)((128, 128), shapes)
    ref = JAnchorGenerator(sizes, ratios)((128, 128), shapes)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    odd = det.AnchorGenerator(((16, 40), (99,)), ((0.5, 1.0), (1.3,)))((97, 131), [(25, 33), (7, 9)])
    odd_ref = JAnchorGenerator(((16, 40), (99,)), ((0.5, 1.0), (1.3,)))((97, 131), [(25, 33), (7, 9)])
    for a, b in zip(odd, odd_ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_box_coder_matches_jax(rng):
    ctr, wh = rng.random((300, 2)) * 100, rng.random((300, 2)) * 50 + 0.5
    anchors = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    deltas = rng.normal(0, 1.5, (300, 4)).astype(np.float32)
    deltas[:5, 2:] = 6.0  # past bbox_xform_clip
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        coder, jcoder = det.BoxCoder(weights), JBoxCoder(weights)
        decoded = coder.decode(_t(deltas), _t(anchors))
        _within(decoded, jcoder.decode(jnp.asarray(deltas), jnp.asarray(anchors)), 1e-6)
        _within(coder.encode(decoded, _t(anchors)), jcoder.encode(jnp.asarray(decoded.numpy()), jnp.asarray(anchors)),
                1e-6)
    with pytest.raises(ValueError):
        det.AnchorGenerator(((32,),), ((0.5,), (1.0,)))


def test_proposal_filter_fed_the_same_head_outputs(stages):
    out, rpn = stages.out, stages.model.rpn
    feats = [_t(f) for f in out["feats"]]
    anchors = rpn.anchors((128, 128), feats)
    props, scores = rpn.filter_proposals(_split_levels(_t(out["obj"]), feats), _split_levels(_t(out["deltas"]), feats),
                                         anchors, (128, 128))
    np.testing.assert_array_equal(scores.numpy() == 0, out["prop_scores"] == 0)
    _within(props, out["props"], 1e-5)
    np.testing.assert_allclose(scores.numpy(), out["prop_scores"], atol=1e-6)


def test_roi_heads_fed_the_same_proposals(stages):
    feats = [_t(f) for f in stages.out["feats"][:-1]]
    cl, bd = stages.model.roi_heads(feats, _t(stages.out["props"]), (128, 128))
    _within(cl, stages.out["cl"], 1e-4)
    _within(bd, stages.out["bd"], 1e-4)


def test_postprocess_fed_the_same_head_outputs(stages):
    out = stages.out
    dets = stages.model.roi_heads.postprocess(_t(out["cl"]), _t(out["bd"]), _t(out["props"]), (128, 128))
    ref = out["dets"]
    np.testing.assert_array_equal(dets["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(dets["labels"].numpy(), ref["labels"])
    assert 0 < int(dets["valid"].sum()) <= dets["valid"].numel()
    _within(dets["boxes"], ref["boxes"], 1e-5)
    np.testing.assert_allclose(dets["scores"].numpy(), ref["scores"], atol=1e-6)


def _gap_at(x, k):
    """Least gap, over the leading dims, between the k-th and (k+1)-th largest entries."""
    if x.shape[-1] <= k:
        return np.inf
    s = -np.sort(-x.astype(np.float64), axis=-1)
    return float((s[..., k - 1] - s[..., k]).min())


def _nms_decisions(boxes_j, boxes_p, scores_j, scores_p, thr, classes=None):
    """The NMS decisions of each problem that matter, on the JAX run's
    candidates: the IoU of every kept box with every later box (of its
    class), and the score order of every pair above the threshold.  Returns
    (least |IoU - thr|, most |IoU_port - IoU_jax|, least score gap of a
    suppressing pair, most |score_port - score_jax|) over those pairs."""
    iou_margin, iou_noise, order_margin = np.inf, 0.0, np.inf
    for p in range(boxes_j.shape[0]):
        order = np.argsort(-scores_j[p], kind="stable")
        bj, bp = _t(boxes_j[p][order]).double(), _t(boxes_p[p][order]).double()
        keep = nms_sorted_plain(_t(boxes_j[p][order]), thr).numpy()
        iou_j, iou_p = box_iou(bj, bj).numpy(), box_iou(bp, bp).numpy()
        pairs = keep[:, None] & np.triu(np.ones_like(iou_j, bool), 1) & (iou_j > 0)
        if classes is not None:
            pairs &= classes[p][order][:, None] == classes[p][order][None, :]
        if pairs.any():
            iou_margin = min(iou_margin, float(np.abs(iou_j[pairs] - thr).min()))
            iou_noise = max(iou_noise, float(np.abs(iou_p[pairs] - iou_j[pairs]).max()))
        sup = pairs & (iou_j > thr)
        s = scores_j[p][order].astype(np.float64)
        if sup.any():
            order_margin = min(order_margin, float(np.abs(s[:, None] - s[None, :])[sup].min()))
    return iou_margin, iou_noise, order_margin, float(np.abs(scores_p - scores_j).max())


def _rpn_candidates(rpn, logits, deltas, anchors, picks=None):
    """Each level's top-k anchors (``picks``, or the logits' own), decoded and
    clipped, with their scores: the proposal filter's candidates."""
    picks = picks or [top_k(lg, min(rpn.pre_nms_top_n, lg.shape[1]))[1] for lg in logits]
    boxes, scores = [], []
    for lg, dl, anc, idx in zip(logits, deltas, anchors, picks):
        b = clip_boxes_to_image(rpn.coder.decode(torch.take_along_dim(dl, idx[..., None], dim=1), anc[idx]), (128, 128))
        ok = (b[..., 2] - b[..., 0] >= rpn.min_size) & (b[..., 3] - b[..., 1] >= rpn.min_size)
        boxes.append(b.numpy())
        scores.append(torch.where(ok, torch.sigmoid(torch.take_along_dim(lg, idx, dim=1)), 0.0).numpy())
    return picks, boxes, scores


def _decision_margins(stages):
    """{decision: (least distance of the JAX run's decisions from their
    threshold, most difference between the port's and the JAX run's inputs
    to them)}, the port run end to end from the same batch."""
    out, model = stages.out, stages.model
    rpn, heads = model.rpn, model.roi_heads
    feats_p = model.backbone(_t(stages.batch))
    logits_p, deltas_p = rpn.head(feats_p)
    props_p, _, _ = rpn(feats_p, (128, 128))
    cl_p, bd_p = heads(feats_p[:-1], props_p, (128, 128))
    feats = [_t(f) for f in out["feats"]]
    anchors = rpn.anchors((128, 128), feats)
    logits, deltas = _split_levels(_t(out["obj"]), feats), _split_levels(_t(out["deltas"]), feats)
    margins = {"rpn top-k": (min(_gap_at(lg.numpy(), rpn.pre_nms_top_n) for lg in logits),
                             float(np.abs(torch.cat(logits_p, 1).numpy() - out["obj"]).max()))}
    picks, cand_j, score_j = _rpn_candidates(rpn, logits, deltas, anchors)
    _, cand_p, score_p = _rpn_candidates(rpn, logits_p, deltas_p, anchors, picks)
    decisions = [_nms_decisions(bj, bp, sj, sp, rpn.nms_thresh) for bj, bp, sj, sp in zip(cand_j, cand_p, score_j, score_p)]
    margins["rpn nms iou"] = (min(d[0] for d in decisions), max(d[1] for d in decisions))
    margins["rpn nms order"] = (min(d[2] for d in decisions), max(d[3] for d in decisions))
    kept = np.concatenate([np.where(nms(_t(b), _t(s), rpn.nms_thresh).numpy(), s, 0) for b, s in zip(cand_j, score_j)], 1)
    margins["rpn post-nms top-k"] = (_gap_at(kept, rpn.post_nms_top_n), margins["rpn nms order"][1])

    def levels(props):
        props = props.reshape(-1, 4).astype(np.float64)
        return 4 + np.log2(np.sqrt((props[:, 2] - props[:, 0]) * (props[:, 3] - props[:, 1])) / 224 + 1e-6)

    lv, lv_p = levels(out["props"]), levels(props_p.numpy())
    inside = (lv > 2) & (lv < 6)  # outside, the level is clamped
    margins["fpn level"] = (float(np.abs(lv[inside] - np.round(lv[inside])).min()) if inside.any() else np.inf,
                            float(np.abs(lv_p - lv).max()))

    def postprocess_candidates(cl, bd, props):
        scores = torch.softmax(_t(cl).double(), -1)[..., 1:].reshape(cl.shape[0], -1).numpy()
        boxes = clip_boxes_to_image(heads.coder.decode(_t(bd)[:, :, 1:], _t(props)[:, :, None]), (128, 128))
        return scores, boxes.reshape(cl.shape[0], -1, 4).numpy()

    s_j, b_j = postprocess_candidates(out["cl"], out["bd"], out["props"])
    s_p, b_p = postprocess_candidates(cl_p.numpy(), bd_p.numpy(), props_p.numpy())
    margins["score threshold"] = (float(np.abs(s_j - heads.score_thresh).min()), float(np.abs(s_p - s_j).max()))
    alive = s_j > heads.score_thresh
    classes = np.tile(np.arange(heads.num_classes - 1), out["props"].shape[1])
    decisions = [_nms_decisions(b_j[i][alive[i]][None], b_p[i][alive[i]][None], s_j[i][alive[i]][None],
                                s_p[i][alive[i]][None], heads.nms_thresh, classes[alive[i]][None])
                 for i in range(len(alive))]
    margins["postprocess nms iou"] = (min(d[0] for d in decisions), max(d[1] for d in decisions))
    margins["postprocess nms order"] = (min(d[2] for d in decisions), max(d[3] for d in decisions))
    margins["final top-k"] = (float(np.diff(-out["dets"]["scores"], axis=-1).min()), margins["score threshold"][1])
    return margins


def test_detect_end_to_end(stages):
    """``detect`` on two unequal images against the JAX package's ``detect``
    (its model applied through the same jitted function)."""
    class Jitted:
        def apply(self, variables, batch, train=False):
            return stages.apply(variables, batch)["dets"]

    transform = det.GeneralizedRCNNTransform(**TRANSFORM)
    got = det.detect(stages.model, [torch.from_numpy(i) for i in stages.images], transform)
    ref = jdet.detect(Jitted(), stages.variables, [jnp.asarray(i) for i in stages.images],
                      jdet.GeneralizedRCNNTransform(**TRANSFORM))
    # every decision of the seed stands further from its threshold than the two runs differ before it
    margins = _decision_margins(stages)
    assert all(margin > 2 * noise for margin, noise in margins.values()), margins
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["valid"].numpy(), np.asarray(r["valid"]))
        np.testing.assert_array_equal(g["labels"].numpy(), np.asarray(r["labels"]))
        _within(g["boxes"], r["boxes"], 1e-4)
        np.testing.assert_allclose(g["scores"].numpy(), np.asarray(r["scores"]), atol=1e-5)
        assert int(g["valid"].sum()) > 0


def test_transform_matches_jax(rng):
    images = [rng.random((h, w, 3), dtype=np.float32) for h, w in ((100, 80), (64, 120), (128, 128))]
    boxes = [rng.random((3, 4)).astype(np.float32) * 60 for _ in images]
    for kw in (TRANSFORM, dict(TRANSFORM, size_bucket=None), dict(fixed_size=(96, 64))):
        batch, scaled, scales = det.GeneralizedRCNNTransform(**kw)([torch.from_numpy(i) for i in images],
                                                                  [torch.from_numpy(b) for b in boxes])
        ref, ref_scaled, ref_scales = jdet.GeneralizedRCNNTransform(**kw)([jnp.asarray(i) for i in images],
                                                                          [jnp.asarray(b) for b in boxes])
        assert scales == ref_scales
        _within(batch, ref, 1e-5)
        for got, want in zip(scaled, ref_scaled):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    box = _t(np.array([[10.0, 20.0, 30.0, 40.0]], np.float32))
    np.testing.assert_array_equal(det.GeneralizedRCNNTransform().postprocess_boxes(box, [(0.5, 2.0)], 0).numpy(),
                                  [[5.0, 40.0, 15.0, 80.0]])


def test_registry_and_refusals():
    assert models.list_models("fasterrcnn*") == ["fasterrcnn_resnet50_fpn", "fasterrcnn_resnet50_fpn_v2"]
    with pytest.raises(ValueError):
        det.FasterRCNN(variant="v3")
    with pytest.raises(TypeError):
        det.FasterRCNN(dtype=torch.float16)


def test_routes_on_the_cpu(stages):
    """The plain route gives the ``None`` route's detections on the CPU;
    the kernel route refuses CPU tensors."""
    x = _t(stages.batch)
    model = stages.model
    dets = model(x)
    model.set_nms("plain")
    try:
        plain = model(x)
        for k in dets:
            assert torch.equal(dets[k], plain[k]), k
        model.set_nms("kernel")
        with pytest.raises(ValueError, match="CUDA"):
            model(x)
        with pytest.raises(NotImplementedError):
            model(x, train=True)
    finally:
        model.set_nms(None)
