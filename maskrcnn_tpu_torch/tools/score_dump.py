"""Score a COCO ``segm`` results file offline (counterpart of the JAX
package's ``tools/score_dump.py``).

    python -m maskrcnn_tpu_torch.tools.score_dump \\
        --ann DIR/annotations/instances_val.json --results results.json \\
        [--out report.json]

Reads the annotation file and a results file in pycocotools' ``loadRes``
format (``cli.evaluate --dump-results`` writes one), decodes every ground
truth (polygons or RLE) and every detection's RLE mask at its image's
size, and scores them with the port's COCO mask AP (``eval/coco_eval.py``,
crowd annotations as pycocotools treats them). Categories map to
contiguous labels in id order. Prints the report as JSON.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def score(ann: dict, results: list) -> dict:
    """COCO mask AP of ``results`` against the annotation dict ``ann``."""
    from maskrcnn_tpu_torch.data.coco import polygons_to_mask, rle_decode
    from maskrcnn_tpu_torch.eval.coco_eval import evaluate_coco

    cat_ids = sorted(c["id"] for c in ann["categories"])
    cat_to_contig = {c: i for i, c in enumerate(cat_ids)}
    img_info = {im["id"]: im for im in ann["images"]}
    img_ids = sorted(img_info)
    gt_by_img = {i: [] for i in img_ids}
    for a in ann["annotations"]:
        gt_by_img[a["image_id"]].append(a)
    dt_by_img = {i: [] for i in img_ids}
    for d in results:
        if d["image_id"] in dt_by_img:
            dt_by_img[d["image_id"]].append(d)

    pred_masks, pred_labels, pred_scores = [], [], []
    gt_masks, gt_labels, gt_crowd = [], [], []
    for iid in img_ids:
        shape = (img_info[iid]["height"], img_info[iid]["width"])
        gm, gl, gc = [], [], []
        for a in gt_by_img[iid]:
            seg = a["segmentation"]
            m = (rle_decode(seg) if isinstance(seg, dict)
                 else polygons_to_mask(seg, *shape))
            gm.append(m.astype(bool))
            gl.append(cat_to_contig[a["category_id"]])
            gc.append(bool(a.get("iscrowd", 0)))
        dm, dl, ds = [], [], []
        for d in dt_by_img[iid]:
            dm.append(rle_decode(d["segmentation"]).astype(bool))
            dl.append(cat_to_contig[d["category_id"]])
            ds.append(float(d["score"]))
        gt_masks.append(np.array(gm, bool) if gm else np.zeros((0, *shape), bool))
        gt_labels.append(np.array(gl, np.int32))
        gt_crowd.append(np.array(gc, bool))
        pred_masks.append(np.array(dm, bool) if dm else np.zeros((0, *shape), bool))
        pred_labels.append(np.array(dl, np.int32))
        pred_scores.append(np.array(ds, np.float32))

    rep = evaluate_coco(pred_masks, pred_labels, pred_scores, gt_masks,
                        gt_labels, len(cat_ids), gt_crowd=gt_crowd)
    return {k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
            for k, v in rep.items() if not isinstance(v, np.ndarray)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ann", required=True, help="COCO annotations json")
    p.add_argument("--results", required=True, help="segm results json")
    p.add_argument("--out", default=None, help="write the report here")
    args = p.parse_args(argv)
    with open(args.ann) as f:
        ann = json.load(f)
    with open(args.results) as f:
        results = json.load(f)
    rep = score(ann, results)
    print(json.dumps(rep, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    main()
