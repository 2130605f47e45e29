"""Stage-by-stage probe of a trained checkpoint: where do detections die?
(counterpart of the JAX package's ``tools/diag_checkpoint.py``).

    python -m maskrcnn_tpu_torch.tools.diag_checkpoint --weight CKPT.pt \\
        [--preset fpn_mask] [--image-size 512x512] [--batch 2] [--seed 0] \\
        [--batch-index 0] [--set SECTION.KEY=VALUE ...] [--device cuda|cpu]

Loads a port checkpoint into the preset's model (on the GPU unless
``--device cpu``) and reports, on batch ``--batch-index`` of the synthetic
stream of ``--seed``, whether signal exists at each stage:

1. the train-path loss with the loaded weights (one step of a copy of the
   model: it should match the logged loss on the training stream);
2. the RPN's proposals at the test budgets: valid proposals per image and
   each GT box's best proposal IoU (is stage 1 blind?);
3. the box head's softmax over those proposals: the top foreground
   probability per image, how many ROIs pass 0.05, the mean background
   probability and the five strongest ROIs (has the classifier collapsed to
   background?);
4. predict: the detections above the score threshold, each with its best
   IoU against GT.

:func:`diagnose` returns the four stages as numbers; ``main`` prints them.
"""

from __future__ import annotations

import argparse
import copy


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weight", required=True, help="a port checkpoint (.pt)")
    p.add_argument("--preset", default="fpn_mask")
    p.add_argument("--image-size", default="512x512")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0, help="data stream seed")
    p.add_argument("--batch-index", type=int, default=0)
    p.add_argument("--set", action="append", default=[], metavar="SEC.KEY=V",
                   help="config override, e.g. --set model.n_fg_class=3")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; cpu on purpose)")
    return p.parse_args(argv)


def diagnose(cfg, model, batch, top: int = 5, max_dets: int = 8) -> dict:
    """The four stages on ``batch`` (a synthetic ``Batch`` of numpy arrays)
    with ``model``'s weights, which stay as they are → ``{"loss": {term:
    value}, "proposals": [per image], "box": [per image], "detections":
    [per image]}``."""
    import numpy as np
    import torch

    from maskrcnn_tpu_torch.eval.predict import make_predict_fn
    from maskrcnn_tpu_torch.models.maskrcnn import backbone_geometry, pyramid_shapes
    from maskrcnn_tpu_torch.models.rpn import anchors_for, generate_proposals
    from maskrcnn_tpu_torch.ops.boxes import box_iou
    from maskrcnn_tpu_torch.train.state import create_train_state
    from maskrcnn_tpu_torch.train.step import make_train_step

    hw = cfg.train.image_size
    dev = model.device
    b = batch.images.shape[0]
    out = {}

    # 1. the train path, on a copy of the model
    state = create_train_state(cfg, copy.deepcopy(model), seed=1)
    out["loss"] = {k: float(v) for k, v in make_train_step(cfg)(state, batch).items()}

    gts = [torch.as_tensor(batch.gt_boxes[i][batch.gt_valid[i]], device=dev)
           for i in range(b)]
    with torch.inference_mode():
        # 2. proposals at the test budgets
        feat_strides, _ = backbone_geometry(cfg)
        feat_shapes = pyramid_shapes(cfg, hw)
        anchors = torch.as_tensor(anchors_for(cfg, feat_shapes, feat_strides),
                                  device=dev)
        images = torch.as_tensor(batch.images, device=dev)
        features, rpn_locs, rpn_scores = model(images)
        props = generate_proposals(
            rpn_locs, rpn_scores, anchors,
            torch.as_tensor(batch.scale, device=dev),
            torch.as_tensor(batch.img_hw, device=dev),
            n_pre=cfg.proposals.n_test_pre_nms,
            n_post=cfg.proposals.n_test_post_nms,
            nms_thresh=cfg.proposals.nms_thresh,
            min_size=cfg.proposals.min_size, n_levels=len(feat_shapes))
        r = props.rois.shape[1]
        out["proposals"] = []
        for i in range(b):
            iou = box_iou(gts[i], props.rois[i]) * props.valid[i][None].float()
            out["proposals"].append({
                "valid": int(props.valid[i].sum()), "slots": r,
                "n_gt": len(gts[i]),
                "best_iou": iou.max(dim=1).values.cpu().numpy().tolist()})

        # 3. the box head's softmax over the proposals
        idx = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(r)
        _, scores = model.head_box(model.roi_features(features),
                                   props.rois.reshape(b * r, 4), idx,
                                   props.levels.reshape(b * r))
        probs = torch.softmax(scores, dim=-1).reshape(b, r, -1).cpu().numpy()
        valid = props.valid.cpu().numpy()
        out["box"] = []
        for i in range(b):
            p = probs[i][valid[i]]
            fg = p[:, 1:]
            if fg.size == 0:
                out["box"].append(None)
                continue
            best = fg.max(axis=1)
            order = np.argsort(-best, kind="stable")[:top]
            out["box"].append({
                "max_fg": float(fg.max()), "over_0.05": int((best > 0.05).sum()),
                "mean_bg": float(p[:, 0].mean()),
                "top": [(int(t), int(fg[t].argmax()), float(best[t])) for t in order]})

    # 4. predict
    det = make_predict_fn(cfg, model, image_size=hw)(
        batch.images, batch.img_hw, batch.scale)
    out["detections"] = []
    for i in range(b):
        v = det.valid[i]
        order = torch.argsort(-det.scores[i] * v, stable=True)[:max_dets]
        dets = []
        for k in order.tolist():
            if not v[k]:
                continue
            iou = box_iou(gts[i], det.boxes[i][k][None]).max() if len(gts[i]) else 0.0
            dets.append({"label": int(det.labels[i][k]),
                         "score": float(det.scores[i][k]), "best_iou": float(iou),
                         "box": det.boxes[i][k].cpu().numpy().tolist()})
        out["detections"].append({
            "n": int(v.sum()),
            "gt_labels": batch.gt_labels[i][batch.gt_valid[i]].tolist(),
            "top": dets})
    return out


def report(stages: dict) -> str:
    """The stages as the JAX tool prints them."""
    import numpy as np

    lines = ["[1] train loss with loaded weights: "
             + str({k: round(v, 4) for k, v in stages["loss"].items()})]
    for i, p in enumerate(stages["proposals"]):
        lines.append(f"[2] img {i}: {p['valid']} valid proposals / {p['slots']} "
                     f"slots; {p['n_gt']} GT")
        lines.append("    per-GT best proposal IoU: "
                     f"{np.round(p['best_iou'], 3).tolist()}")
    for i, bx in enumerate(stages["box"]):
        if bx is None:
            lines.append(f"[3] img {i}: NO valid proposals")
            continue
        lines.append(f"[3] img {i}: max fg prob {bx['max_fg']:.4f}; #rois with "
                     f"max-fg>0.05: {bx['over_0.05']}; mean bg prob "
                     f"{bx['mean_bg']:.4f}")
        for roi, cls, p in bx["top"]:
            lines.append(f"      roi{roi}: fg_cls={cls} p={p:.4f}")
    for i, d in enumerate(stages["detections"]):
        lines.append(f"[4] img {i}: {d['n']} detections; GT labels {d['gt_labels']}")
        for t in d["top"]:
            lines.append(f"      det: label={t['label']} score={t['score']:.4f} "
                         f"bestIoU={t['best_iou']:.3f} "
                         f"box={np.round(t['box'], 1).tolist()}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from maskrcnn_tpu_torch import config as cfg_lib
    from maskrcnn_tpu_torch.cli.train import prepare_device
    from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN

    h, w = (int(x) for x in args.image_size.split("x"))
    cfg = cfg_lib._rep(cfg_lib.PRESETS[args.preset](), train=dict(
        image_size=(h, w), image_buckets=None, batch_size=args.batch))
    cfg = cfg_lib.apply_overrides(cfg, args.set)
    device = prepare_device(args.device)
    model = MaskRCNN(cfg, device=device, seed=0)
    model.load_state_dict(torch.load(args.weight, map_location=device,
                                     weights_only=False)["model"])
    print(f"loaded {args.weight}")
    stages = diagnose(cfg, model, SyntheticDetectionData(cfg, seed=args.seed)
                      .batch(args.batch_index))
    print(report(stages))
    return stages


if __name__ == "__main__":
    main()
