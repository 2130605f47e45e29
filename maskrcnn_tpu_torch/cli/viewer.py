"""Depth-camera keypoint viewer (counterpart of the JAX package's
``cli/viewer.py``).

    python -m maskrcnn_tpu_torch.cli.viewer [--weight CKPT] \\
        [--image FRAME.npz|IMAGE [--benchmark N]] [--file REC.bag] \\
        [--n-keypoints 20] [--thresh 0.2] [--no-display] [--device cuda|cpu]

The ``darknet_keypoint`` model under the ``visualize`` preset (score 0.7)
on the GPU unless ``--device cpu``; ``--weight`` loads its parameters and
buffers from a checkpoint of the port's train CLI. A frame's depth (mm)
is normalised as (d − 1000) / 3000 into 3 channels in [0, 1], resized into
the preset's 256×320 canvas and predicted; boxes come back to the frame's
coordinates and each detection's keypoints are the argmax bins of its
heatmaps (``decode_keypoints``). ``--image`` runs one frame (a ``.npz``
with ``depth``, or an image file) and writes ``<stem>_keypoints.png`` with
the skeleton drawn; ``--benchmark N`` then runs the frame's work N more
times and prints the running (EMA) frames per second the camera loop
shows. Without ``--image`` it reads a RealSense camera (or a ``--file``
recording): a 640×360 depth stream cropped to 4:3. That needs
``pyrealsense2``; without it the viewer exits and names the module.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weight", default=None,
                   help="checkpoint of the train CLI (parameters and buffers)")
    p.add_argument("--file", default=None, help="RealSense .bag recording")
    p.add_argument("--image", default=None,
                   help="run on one .npz depth frame or image file instead of "
                        "a camera")
    p.add_argument("--n-keypoints", type=int, default=20)
    p.add_argument("--thresh", type=float, default=0.2)
    p.add_argument("--no-display", action="store_true")
    p.add_argument("--benchmark", type=int, default=0, metavar="N",
                   help="with --image: run the frame N more times and print "
                        "the EMA frames per second")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; cpu on purpose)")
    return p.parse_args(argv)


def normalize_depth(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth in mm → (H, W, 3) float32 in [0, 1]: (d − 1000) / 3000,
    clipped."""
    d = (depth.astype(np.float32) - 1000.0) / 3000.0
    d = np.clip(d, 0.0, 1.0)
    return np.stack([d, d, d], axis=-1)


def crop_16_9_to_4_3(img: np.ndarray) -> np.ndarray:
    """Centre-crop the width so that a 16:9 frame becomes 4:3."""
    h, w = img.shape[:2]
    target_w = h * 4 // 3
    off = max((w - target_w) // 2, 0)
    return img[:, off: off + target_w]


class Viewer:
    def __init__(self, args):
        from maskrcnn_tpu_torch import config as cfg_lib
        from maskrcnn_tpu_torch.cli.train import prepare_device
        from maskrcnn_tpu_torch.eval.postprocess import decode_keypoints
        from maskrcnn_tpu_torch.eval.predict import make_predict_fn
        from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
        from maskrcnn_tpu_torch.train.checkpoint import load_params_only
        from maskrcnn_tpu_torch.train.state import create_train_state

        self.cfg = cfg_lib.use_preset(
            cfg_lib.darknet_keypoint(n_keypoints=args.n_keypoints), "visualize")
        device = prepare_device(args.device)
        state = create_train_state(
            self.cfg, MaskRCNN(self.cfg, device=device, seed=0), seed=1)
        if args.weight:
            load_params_only(args.weight, state)
        self.model = state.model
        self.predict = make_predict_fn(self.cfg, self.model)
        self.decode_keypoints = decode_keypoints
        self.args = args
        self.fps_ema = None

    def infer_frame(self, rgbish: np.ndarray):
        """(H, W, 3) float in [0, 1] → (keypoints (N, K, 3) as (y, x,
        score), boxes (N, 4), scores (N,)) in the frame's coordinates."""
        import cv2

        bh, bw = self.cfg.train.image_size
        h0, w0 = rgbish.shape[:2]
        scale = min(bh / h0, bw / w0)
        nh, nw = int(h0 * scale), int(w0 * scale)
        canvas = np.zeros((bh, bw, 3), np.float32)
        canvas[:nh, :nw] = cv2.resize(rgbish, (nw, nh))
        det = self.predict(canvas[None], np.array([[nh, nw]], np.float32),
                           np.array([scale], np.float32))
        boxes = det.boxes[0].cpu().numpy() / scale
        valid = det.valid[0].cpu().numpy()
        kps = self.decode_keypoints(boxes, det.heatmaps[0].cpu().numpy(), valid)
        return kps, boxes[valid], det.scores[0].cpu().numpy()[valid]

    def tick(self, seconds: float) -> float:
        """Fold one frame's time into the EMA frames per second."""
        fps = 1.0 / max(seconds, 1e-6)
        self.fps_ema = fps if self.fps_ema is None else (
            0.1 * fps + 0.9 * self.fps_ema)
        return self.fps_ema

    def run_image(self, path: str) -> str:
        import cv2

        from maskrcnn_tpu_torch.utils.vis import vis_keypoints

        if path.endswith(".npz"):
            img = normalize_depth(np.load(path)["depth"])
        else:
            img = cv2.imread(path).astype(np.float32) / 255.0
        kps, boxes, _ = self.infer_frame(img)
        canvas = (img * 255).astype(np.uint8)
        for person in kps:
            canvas = vis_keypoints(canvas, person, thresh=self.args.thresh)
        out = os.path.splitext(path)[0] + "_keypoints.png"
        cv2.imwrite(out, canvas)
        print(f"detections: {len(boxes)}; wrote {out}")
        if self.args.benchmark:
            # the camera loop's work a frame (resize, predict, decode),
            # without the camera
            for _ in range(self.args.benchmark):
                t0 = time.time()
                self.infer_frame(img)
                self.tick(time.time() - t0)
            print(f"fps(EMA) over {self.args.benchmark} frames: "
                  f"{self.fps_ema:.2f}")
        return out

    def run_camera(self):
        try:
            import pyrealsense2 as rs
        except ImportError:
            raise SystemExit("pyrealsense2 not installed — camera mode "
                             "unavailable; use --image for file inference")
        import cv2

        from maskrcnn_tpu_torch.utils.vis import vis_keypoints

        pipeline = rs.pipeline()
        rs_cfg = rs.config()
        if self.args.file:
            rs_cfg.enable_device_from_file(self.args.file)
        rs_cfg.enable_stream(rs.stream.depth, 640, 360, rs.format.z16, 30)
        pipeline.start(rs_cfg)
        try:
            while True:
                t0 = time.time()
                frames = pipeline.wait_for_frames()
                depth = np.asanyarray(frames.get_depth_frame().get_data())
                img = normalize_depth(crop_16_9_to_4_3(depth))
                kps, _, _ = self.infer_frame(img)
                canvas = (img * 255).astype(np.uint8)
                for person in kps:
                    canvas = vis_keypoints(canvas, person,
                                           thresh=self.args.thresh)
                print(f"fps(EMA): {self.tick(time.time() - t0):.1f}", end="\r")
                if not self.args.no_display:
                    cv2.imshow("keypoints", canvas)
                    if cv2.waitKey(1) == 27:
                        break
        finally:
            pipeline.stop()


def main(argv=None):
    args = parse_args(argv)
    viewer = Viewer(args)
    if args.image:
        viewer.run_image(args.image)
    else:
        viewer.run_camera()


if __name__ == "__main__":
    main()
