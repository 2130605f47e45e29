"""Pass 2 on the detection slots a request can fill.

Per-class NMS keeps ``n_keep = min(n_test_post_nms, max_detections)``
boxes of each foreground class, so only ``n_fg · n_keep`` of the ``d``
slots can ever hold a detection. Where that is fewer than ``d``, pass 2
runs the head on each image's first ``n_fg · n_keep + 1`` slots and the
last of them fills the padding slots after it: ``darknet_keypoint`` (the
viewer: one class, 10 kept, b1 at 256×320 under ``visualize``) computes 11
rows of 100, ``tiny_test`` (3 classes, 32 kept, b2 under ``evaluate``)
2·97 of 2·100, and ``tiny_test`` with 32 slots (3·32 ≥ 32) all of them,
on the path the head always took: no slice, no concatenation.

Each request goes through ``predict.eager``. Its masks or heatmaps equal
the head run on every one of the B·d slots within 1e-6 of max(1, max
|·|); its boxes, scores, labels and validity equal, in every bit, those of
the same request served on every slot; its padding slots equal one
another. The head receives the rows counted, and the tracer's
``head_rows`` counter counts them.
"""

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from maskrcnn_tpu_torch import config as cfg_lib  # noqa: E402
from maskrcnn_tpu_torch.bench import class_score_layer  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticRequests  # noqa: E402
from maskrcnn_tpu_torch.eval import predict as predict_mod  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.ops.levels import map_rois_to_fpn_levels  # noqa: E402
from maskrcnn_tpu_torch.utils import tracing  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-6
# case: (preset, batch, preset mode, max_detections, head rows an image)
CASES = {
    "darknet_keypoint": ("darknet_keypoint", 1, "visualize", 100, 11),
    "tiny_test": ("tiny_test", 2, "evaluate", 100, 97),
    "tiny_test-all_slots": ("tiny_test", 1, "evaluate", 32, 32),
}


def _cfg(case):
    preset, b, mode, d, _ = CASES[case]
    base = (cfg_lib.darknet_keypoint(n_keypoints=20) if preset == "darknet_keypoint"
            else cfg_lib.tiny_test())
    cfg = cfg_lib._rep(base, train=dict(batch_size=b), eval=dict(max_detections=d))
    return cfg_lib.use_preset(cfg, mode)


def _model(cfg, preset):
    """Class scores spread by 32 (and the viewer's one foreground class
    raised by 4), so that detections clear even the 0.7 threshold."""
    model = MaskRCNN(cfg, device="cpu", seed=0)
    layer = class_score_layer(model)
    with torch.no_grad():
        layer.weight.mul_(32.0)
        if preset == "darknet_keypoint":
            layer.bias[1] += 4.0
    return model


class Ops(TorchDispatchMode):
    """The ATen operations run while on, by name."""

    def __init__(self):
        super().__init__()
        self.names, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _serve(model, predict, req, rows_of=None):
    """One request through ``predict.eager`` with tracing on → (detections,
    pass 2's inputs, the rows the head received, the operations of pass 2
    outside the pool and the head, the tracer's counters). ``rows_of`` replaces
    :func:`predict_mod.head_rows`."""
    seen, rows, ops = {}, [], Ops()
    predict_masks = predict_mod.predict_masks
    head_mask, predict_mask = model.head_mask, model.head.predict_mask

    def pass2(*args):
        seen["args"] = args
        with ops:
            return predict_masks(*args)

    def pool_and_head(*args):
        ops.paused = True
        try:
            return head_mask(*args)
        finally:
            ops.paused = False

    def head(pooled, class_idx=None):
        rows.append(pooled.shape[0])
        return predict_mask(pooled, class_idx)

    tracing.reset()
    tracing.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(predict_mod, "predict_masks", pass2)
            mp.setattr(model, "head_mask", pool_and_head)
            mp.setattr(model.head, "predict_mask", head)
            if rows_of is not None:
                mp.setattr(predict_mod, "head_rows", rows_of)
            det = predict.eager(*req)
        counters = tracing.summary()["counters"]
    finally:
        tracing.disable()
        tracing.reset()
    return det, seen["args"], rows, ops.names, counters


@pytest.fixture(scope="module", params=list(CASES))
def served(request):
    case = request.param
    cfg = _cfg(case)
    model = _model(cfg, CASES[case][0])
    predict = predict_mod.make_predict_fn(cfg, model)
    req = tuple(SyntheticRequests(cfg, seed=3).batch(0))[:3]
    det, args, rows, ops, counters = _serve(model, predict, req)
    every_slot = _serve(model, predict, req, rows_of=lambda d, n_kept: d)[0]
    return dict(case=case, cfg=cfg, model=model, det=det, args=args, rows=rows,
                ops=ops, counters=counters, every_slot=every_slot)


def _head_on_every_slot(cfg, model, roi_feats, boxes, labels, levels):
    """Pass 2 as it was computed on all B·d slots: ``model.head_mask`` on
    every row → (B, d, ...) mask probabilities or heatmap logits."""
    b, d = boxes.shape[:2]
    flat = boxes.reshape(b * d, 4)
    levels = (levels.reshape(b * d) if cfg.eval.mask_levels == "pass1"
              else map_rois_to_fpn_levels(flat, 0, len(roi_feats) - 1))
    bi = predict_mod.image_index(b, d, boxes.device)
    with torch.inference_mode():
        if cfg.model.head == "fpn_keypoint":
            out = model.head_mask(roi_feats, flat, bi, levels)
        else:
            out = torch.sigmoid(model.head_mask(roi_feats, flat, bi, levels,
                                                labels.reshape(b * d)))
    return out.reshape(b, d, *out.shape[1:])


def test_served_slots_equal_the_head_on_every_slot(served):
    cfg, det, full = served["cfg"], served["det"], served["every_slot"]
    b, d = det.valid.shape
    assert det.valid.any()
    for name in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(getattr(det, name), getattr(full, name)), name
    out = det.heatmaps if cfg.model.head == "fpn_keypoint" else det.masks
    want = _head_on_every_slot(cfg, served["model"], *served["args"][2:6])
    assert out.shape == want.shape and out.shape[:2] == (b, d)
    scale = max(1.0, float(want.abs().max()))
    assert float((out - want).abs().max()) <= TOL * scale
    full_out = full.heatmaps if cfg.model.head == "fpn_keypoint" else full.masks
    assert float((out - full_out).abs().max()) <= TOL * scale
    n = CASES[served["case"]][4]
    if n < d:  # slot n-1 and every slot after it: the same padding
        assert not det.valid[:, n - 1:].any()
        assert torch.equal(out[:, n - 1:], out[:, n - 1:n].expand_as(out[:, n - 1:]))


def test_head_runs_on_the_rows_a_request_can_fill(served):
    """The head receives B·rows rows, and the ``head_rows`` counter counts
    them; a request whose slots can all fill takes no slice and no
    concatenation outside the pool and the head."""
    _, b, _, d, rows = CASES[served["case"]]
    assert served["rows"] == [b * rows]
    assert served["counters"]["head_rows"] == b * rows
    assert served["counters"]["detection_slots"] == b * d
    cut = {"slice", "cat"} & set(served["ops"])
    assert cut == (set() if rows == d else {"slice", "cat"}), served["ops"]
