"""Evaluation CLI of the port (counterpart of the JAX package's
``cli/evaluate.py``): VOC mask mAP@0.5 and COCO mask AP, or OKS keypoint AP
for the keypoint head, of a checkpoint.

    python -m maskrcnn_tpu_torch.cli.evaluate --preset fpn_mask \\
        --weight runs/x/checkpoints/step_00001000.pt [--n-batches 16] \\
        [--label-file F] [--seed S] [--out report.json] \\
        [--dataset coco --coco-root DIR --coco-split S --category-filter A,B \\
         --buckets HxW,HxW --dump-results results.json] \\
        [--set SECTION.KEY=VALUE ...] [--device cuda|cpu]

``--weight`` loads parameters and buffers only. The batches are the train
CLI's held-out stream, seed ``--seed + 999``: synthetic, or a COCO loader
without flips on ``--coco-split`` (the training run's ``--eval-split``),
at the config's image size, buckets (``--buckets``) and batch size
(``--set train.image_size=512x512 --set train.batch_size=8``), so a run's
checkpoint scores here as its in-run evaluation did. Prints the report as
JSON (and writes it to ``--out``). ``--dump-results`` also writes a COCO
results file (``segm``, or ``keypoints`` for the keypoint head) over the
whole split in index order, in original image coordinates and the
annotation file's category ids.
"""

from __future__ import annotations

import argparse
import json

from maskrcnn_tpu_torch.cli.train import (
    build_config,
    category_filter,
    check_data_args,
    coco_label_names,
    parse_buckets,
    prepare_device,
)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="fpn_mask",
                   help="the training run's preset: fpn_mask, fpn_keypoint, "
                        "light_head, c4_res5, tiny_test or darknet_keypoint")
    p.add_argument("--weight", default=None,
                   help="checkpoint of the train CLI (parameters and buffers)")
    p.add_argument("--dataset", default="synthetic", choices=["synthetic", "coco"])
    p.add_argument("--coco-root", default=None,
                   help="COCO-format directory (--dataset coco)")
    p.add_argument("--coco-split", default="val2014")
    p.add_argument("--category-filter", default=None,
                   help="comma-separated COCO category names: keep the "
                        "images holding any of them")
    p.add_argument("--buckets", default=None,
                   help="comma-separated HxW static padding buckets "
                        "(train.image_buckets), as the training run had them")
    p.add_argument("--n-batches", type=int, default=16)
    p.add_argument("--label-file", default=None,
                   help="class names, one per line; sets model.n_fg_class "
                        "(default: data/label_coco.txt, none for the "
                        "keypoint head and tiny_test)")
    p.add_argument("--seed", type=int, default=0,
                   help="the training run's seed: the batches are its "
                        "held-out stream, seed + 999")
    p.add_argument("--out", default=None, help="write the report JSON here")
    p.add_argument("--set", action="append", default=[], metavar="SEC.KEY=V",
                   help="config override, applied last, e.g. --set "
                        "eval.mask_levels=refined")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; cpu on purpose)")
    p.add_argument("--dump-results", default=None, metavar="PATH",
                   help="also write a COCO results JSON (loadRes format) "
                        "over the whole --dataset coco split")
    args = p.parse_args(argv)
    check_data_args(p, args)
    if args.dump_results and args.dataset != "coco":
        p.error("--dump-results needs --dataset coco (real image and "
                "category ids)")

    from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData
    from maskrcnn_tpu_torch.eval.evaluator import (
        evaluate_dataset,
        evaluate_keypoint_dataset,
    )
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.checkpoint import load_params_only
    from maskrcnn_tpu_torch.train.state import create_train_state

    train = {"image_buckets": parse_buckets(args.buckets)} if args.buckets else None
    cfg, label_names = build_config(args.preset, args.label_file, args.set, train)
    device = prepare_device(args.device)
    state = create_train_state(cfg, MaskRCNN(cfg, device=device, seed=0))
    if args.weight:
        load_params_only(args.weight, state)
        print(f"loaded {args.weight}")
    if args.dataset == "coco":
        from maskrcnn_tpu_torch.data.coco import COCODetectionLoader

        loader = COCODetectionLoader(
            args.coco_root, args.coco_split, cfg, seed=args.seed + 999,
            flip=False, category_filter=category_filter(args.category_filter))
        label_names = coco_label_names(label_names, loader, cfg)
        batches = iter(loader)
    else:
        batches = iter(SyntheticDetectionData(cfg, seed=args.seed + 999))

    keypoint = cfg.model.head == "fpn_keypoint"
    predict_cache = {}  # one predict per bucket, shared with the export
    if keypoint:
        report = evaluate_keypoint_dataset(cfg, state.model, batches,
                                           args.n_batches,
                                           predict_cache=predict_cache)
    else:
        report = evaluate_dataset(cfg, state.model, batches, args.n_batches,
                                  label_names, predict_cache=predict_cache)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)

    if args.dump_results:
        from maskrcnn_tpu_torch.eval.export import (
            export_coco_keypoint_results,
            export_coco_results,
        )

        export = export_coco_keypoint_results if keypoint else export_coco_results
        n = export(cfg, state.model, loader, args.dump_results,
                   predict_cache=predict_cache)
        print(f"wrote {n} detections to {args.dump_results}")
    return report


if __name__ == "__main__":
    main()
