"""Evaluation CLI of the port (counterpart of the JAX package's
``cli/evaluate.py``): VOC mask mAP@0.5 and COCO mask AP of a checkpoint.

    python -m maskrcnn_tpu_torch.cli.evaluate --preset fpn_mask \\
        --weight runs/x/checkpoints/step_00001000.pt [--n-batches 16] \\
        [--label-file F] [--seed S] [--out report.json] \\
        [--set SECTION.KEY=VALUE ...] [--device cuda|cpu]

``--weight`` loads parameters and buffers only. The batches are the train
CLI's held-out synthetic stream (seed ``--seed + 999``) at the config's
image size and batch size (``--set train.image_size=512x512 --set
train.batch_size=8``), so a run's checkpoint scores here as its in-run
evaluation did. Prints the report as JSON (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json

from maskrcnn_tpu_torch.cli.train import build_config, prepare_device, reject_unported

UNPORTED = {"dump_results": "A.2 (the COCO results export needs the COCO loader)"}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="fpn_mask")
    p.add_argument("--weight", default=None,
                   help="checkpoint of the train CLI (parameters and buffers)")
    p.add_argument("--dataset", default="synthetic", choices=["synthetic", "coco"])
    p.add_argument("--n-batches", type=int, default=16)
    p.add_argument("--label-file", default=None,
                   help="class names, one per line; sets model.n_fg_class "
                        "(default: data/label_coco.txt)")
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
                   help="not ported yet")
    args = p.parse_args(argv)
    reject_unported(p, args, UNPORTED)

    from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData
    from maskrcnn_tpu_torch.eval.evaluator import evaluate_dataset
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.checkpoint import load_params_only
    from maskrcnn_tpu_torch.train.state import create_train_state

    cfg, label_names = build_config(args.preset, args.label_file, args.set)
    device = prepare_device(args.device)
    state = create_train_state(cfg, MaskRCNN(cfg, device=device, seed=0))
    if args.weight:
        load_params_only(args.weight, state)
        print(f"loaded {args.weight}")
    batches = iter(SyntheticDetectionData(cfg, seed=args.seed + 999))
    report = evaluate_dataset(cfg, state.model, batches, args.n_batches,
                              label_names)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
