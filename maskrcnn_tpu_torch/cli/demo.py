"""Detection and mask overlays from a checkpoint (counterpart of the JAX
package's ``cli/demo.py``).

    python -m maskrcnn_tpu_torch.cli.demo --preset tiny_test \\
        --weight runs/x/checkpoints/step_00000004.pt [--n 4] [--out DIR] \\
        [--score-thresh 0.5] [--seed 7] [--device cuda|cpu]

Runs the two-pass predict of the preset's model (parameters and buffers
from a checkpoint of the port's train CLI) on the seeded synthetic stream,
pastes each kept detection's mask at full resolution on the model's device
(``paste_masks``), and writes ``<out>/demo_NNN.png``: boxes, class and
score, and masks blended over the image, for the first ``--n`` images.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="tiny_test")
    p.add_argument("--weight", required=True,
                   help="checkpoint of the train CLI (parameters and buffers)")
    p.add_argument("--n", type=int, default=4, help="number of images")
    p.add_argument("--out", default="demo_out")
    p.add_argument("--score-thresh", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; cpu on purpose)")
    args = p.parse_args(argv)

    import cv2
    import numpy as np

    from maskrcnn_tpu_torch import config as cfg_lib
    from maskrcnn_tpu_torch.cli.train import prepare_device
    from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData
    from maskrcnn_tpu_torch.eval.postprocess import paste_masks
    from maskrcnn_tpu_torch.eval.predict import make_predict_fn
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.checkpoint import load_params_only
    from maskrcnn_tpu_torch.train.state import create_train_state
    from maskrcnn_tpu_torch.utils.vis import vis_detections

    cfg = cfg_lib.PRESETS[args.preset]()
    device = prepare_device(args.device)
    state = load_params_only(args.weight, create_train_state(
        cfg, MaskRCNN(cfg, device=device, seed=0), seed=1))
    predict = make_predict_fn(cfg, state.model)

    os.makedirs(args.out, exist_ok=True)
    data = SyntheticDetectionData(cfg, seed=args.seed)
    written = []
    for bi in range(8):
        batch = data.batch(bi)
        det = predict(batch.images, batch.img_hw, batch.scale)
        for i in range(batch.images.shape[0]):
            if len(written) >= args.n:
                break
            hw = (int(batch.img_hw[i][0]), int(batch.img_hw[i][1]))
            keep = det.valid[i] & (det.scores[i] >= args.score_thresh)
            masks = paste_masks(det.boxes[i], det.masks[i], keep, hw)
            keep = keep.cpu().numpy()
            img = np.asarray(batch.images[i][: hw[0], : hw[1]])
            if img.dtype != np.uint8:
                img = (img * 255).astype(np.uint8)
            img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
            canvas = vis_detections(
                img, det.boxes[i].cpu().numpy()[keep],
                det.labels[i].cpu().numpy()[keep],
                det.scores[i].cpu().numpy()[keep], masks.cpu().numpy(),
                thresh=0.0)
            path = os.path.join(args.out, f"demo_{len(written):03d}.png")
            cv2.imwrite(path, canvas)
            print(f"{path}: {int(keep.sum())} detections")
            written.append(path)
        if len(written) >= args.n:
            break
    return written


if __name__ == "__main__":
    main()
