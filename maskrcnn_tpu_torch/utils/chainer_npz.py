"""Chainer ``save_npz``-layout artifact emitter — the converter's test rig
(a copy of ``maskrcnn_tpu/utils/chainer_npz.py``, numpy only).

The reference's pretrained story rests on two artifact kinds this
environment cannot produce (no chainer package installable, no network —
see BASELINE.md "real-artifact blocker"):

- ``ResNet50Layers('auto')`` ImageNet weights
  (reference feature_pyramid_network.py:22),
- the published Light-Head checkpoint (reference README.md:57-62),

both serialized by ``chainer.serializers.save_npz``. This module is an
INDEPENDENT re-implementation of that serialization layout, written from
chainer's documented serializer semantics and the reference's model
definitions (not from ``convert_chainer.py``):

- one flat npz, keys are ``child/.../param`` link paths (DictionarySerializer
  with an empty root path),
- ``Convolution2D``: ``W`` (out, in, kh, kw) [+ ``b`` (out,)],
- ``Deconvolution2D``: ``W`` (in, out, kh, kw) [+ ``b``],
- ``Linear``: ``W`` (out, in) [+ ``b``],
- ``BatchNormalization``: params ``gamma``/``beta`` AND the persistent
  values ``avg_mean``/``avg_var``/``N`` (``N`` is an int32 scalar counter a
  real artifact always carries; converters must tolerate it),
- scalars land as 0-d arrays (numpy ``savez`` semantics).

Model structure emitted per architecture follows the reference sources:
``extractor`` (feature_pyramid_network.py:19-44 / c4_backbone.py:7-15 /
darknet.py:30-38), ``rpn`` (multilevel_region_proposal_network.py:84-88),
``head`` (fpn_roi_mask_head.py:24-49, fpn_roi_keypoint_head.py:26-51,
light_roi_mask_head.py:24-46, resnet_roi_mask_head.py:25-50).

Also usable as a CLI to write an artifact or print the key manifest, so
anyone WITH chainer can diff against a genuine ``save_npz`` dump:

    python -m maskrcnn_tpu_torch.utils.chainer_npz --head fpn out.npz
    python -m maskrcnn_tpu_torch.utils.chainer_npz --head fpn --manifest
"""

from __future__ import annotations

import numpy as np


class _Emitter:
    def __init__(self, rng: np.random.RandomState):
        self.rng = rng
        self.d: dict[str, np.ndarray] = {}

    def conv(self, name, o, i, kh, kw=None, bias=True):
        kw = kh if kw is None else kw
        self.d[f"{name}/W"] = (
            self.rng.randn(o, i, kh, kw) * 0.05).astype(np.float32)
        if bias:
            self.d[f"{name}/b"] = (
                self.rng.randn(o) * 0.01).astype(np.float32)

    def deconv(self, name, i, o, k):
        self.d[f"{name}/W"] = (
            self.rng.randn(i, o, k, k) * 0.05).astype(np.float32)
        self.d[f"{name}/b"] = (self.rng.randn(o) * 0.01).astype(np.float32)

    def linear(self, name, o, i):
        self.d[f"{name}/W"] = (
            self.rng.randn(o, i) * 0.05).astype(np.float32)
        self.d[f"{name}/b"] = (self.rng.randn(o) * 0.01).astype(np.float32)

    def bn(self, name, c):
        self.d[f"{name}/gamma"] = self.rng.rand(c).astype(np.float32) + 0.5
        self.d[f"{name}/beta"] = (
            self.rng.randn(c) * 0.1).astype(np.float32)
        # persistent values — serialized alongside params by save_npz
        self.d[f"{name}/avg_mean"] = (
            self.rng.randn(c) * 0.1).astype(np.float32)
        self.d[f"{name}/avg_var"] = self.rng.rand(c).astype(np.float32) + 0.5
        self.d[f"{name}/N"] = np.int32(0)

    def resnet50(self, prefix, with_res5=True, only_res5=False):
        """chainer ResNet50Layers (fc deleted): conv1/bn1 + res2..res5 of
        BuildingBlocks a, b1..bN with conv1..3/bn1..3 and the projection
        conv4/bn4 on block 'a'. ``only_res5`` emits just the res5 stage
        (the res5 head copies that block — resnet_roi_mask_head.py:25-29)."""
        stages = [("res2", 3, 64, 256), ("res3", 4, 128, 512),
                  ("res4", 6, 256, 1024), ("res5", 3, 512, 2048)]
        in_ch = 64
        if only_res5:
            stages = stages[3:]
            in_ch = 1024
        else:
            self.conv(f"{prefix}conv1", 64, 3, 7, bias=False)
            self.bn(f"{prefix}bn1", 64)
        for stage, n, mid, out in stages:
            if stage == "res5" and not with_res5 and not only_res5:
                break
            for i in range(n):
                cname = "a" if i == 0 else f"b{i}"
                cin = in_ch if i == 0 else out
                self.conv(f"{prefix}{stage}/{cname}/conv1", mid, cin, 1,
                          bias=False)
                self.bn(f"{prefix}{stage}/{cname}/bn1", mid)
                self.conv(f"{prefix}{stage}/{cname}/conv2", mid, mid, 3,
                          bias=False)
                self.bn(f"{prefix}{stage}/{cname}/bn2", mid)
                self.conv(f"{prefix}{stage}/{cname}/conv3", out, mid, 1,
                          bias=False)
                self.bn(f"{prefix}{stage}/{cname}/bn3", out)
            self.conv(f"{prefix}{stage}/a/conv4", out, in_ch, 1, bias=False)
            self.bn(f"{prefix}{stage}/a/bn4", out)
            in_ch = out


def emit_model_npz(backbone: str = "fpn", head: str = "fpn",
                   n_fg_class: int = 79, n_keypoints: int = 17,
                   n_mask_convs: int = 8, seed: int = 0
                   ) -> dict[str, np.ndarray]:
    """Emit the full ``save_npz(model.faster_rcnn)`` key set for a reference
    configuration (what ``snapshot_object`` writes, reference
    train.py:134-137)."""
    e = _Emitter(np.random.RandomState(seed))
    n_class = n_fg_class + 1

    # ---- extractor ----
    if backbone == "fpn":
        e.resnet50("extractor/resnet/")
        e.conv("extractor/toplayer", 256, 2048, 1)
        e.conv("extractor/lat_p4", 256, 1024, 1)
        e.conv("extractor/lat_p3", 256, 512, 1)
        e.conv("extractor/lat_p2", 256, 256, 1)
        e.conv("extractor/conv_p4", 256, 256, 3)
        e.conv("extractor/conv_p3", 256, 256, 3)
        e.conv("extractor/conv_p2", 256, 256, 3)
        e.conv("extractor/conv_p6", 256, 256, 1)
        n_anchor, rpn_in = 3, 256
    elif backbone == "c4":
        e.resnet50("extractor/", with_res5=False)
        n_anchor, rpn_in = 3, 1024
    elif backbone == "darknet":
        in_ch = 3
        for i, ch in enumerate((16, 32, 64, 128, 256)):
            e.conv(f"extractor/conv{i + 1}/c", ch, in_ch, 3)
            e.bn(f"extractor/conv{i + 1}/bn", ch)
            in_ch = ch
        n_anchor, rpn_in = 3, 256
    else:
        raise ValueError(backbone)

    # ---- rpn (shared conv + score/loc 1x1 heads) ----
    e.conv("rpn/conv", 256, rpn_in, 3)
    e.conv("rpn/score", n_anchor * 2, 256, 1)
    e.conv("rpn/loc", n_anchor * 4, 256, 1)

    # ---- head ----
    if head in ("fpn", "fpn_keypoint"):
        e.conv("head/conv1", 256, 256, 3)
        e.linear("head/fc1", 1024, 7 * 7 * 256)
        e.linear("head/fc2", 1024, 1024)
        e.linear("head/cls_loc", 4, 1024)
        e.linear("head/score", n_class, 1024)
        if head == "fpn":
            for i in range(1, 5):
                e.conv(f"head/mask{i}", 256, 256, 3)
            e.deconv("head/deconv1", 256, 256, 2)
            e.conv("head/conv2", n_class - 1, 256, 1)
        else:
            for i in range(n_mask_convs):
                e.conv(f"head/mask_convs/{i}", 256, 256, 3)
            e.deconv("head/deconv1", 256, 256, 2)
            e.conv("head/conv2", n_keypoints, 256, 1)
    elif head == "light":
        c_mid, c_out = 256, 490
        e.conv("head/conv_ul", c_mid, 1024, 15, 1)
        e.conv("head/conv_bl", c_out, c_mid, 1, 15)
        e.conv("head/conv_ur", c_mid, 1024, 1, 15)
        e.conv("head/conv_br", c_out, c_mid, 15, 1)
        e.linear("head/fc", 2048, 7 * 7 * c_out)
        e.linear("head/cls_loc", 4, 2048)
        e.linear("head/score", n_class, 2048)
        e.conv("head/conv2", c_out, c_out, 3)
        e.conv("head/conv3_", c_out, c_out, 3)
        e.conv("head/conv4", c_out, c_out, 3)
        e.deconv("head/deconv1_", c_out, n_class - 1, 2)
    elif head == "res5":
        e.resnet50("head/", only_res5=True)
        e.conv("head/conv1", 2048, 2048, 3)
        e.linear("head/cls_loc", n_class * 4, 2048)
        e.linear("head/score", n_class, 2048)
        e.deconv("head/deconv1", 2048, 256, 2)
        e.conv("head/conv2", n_class - 1, 256, 3)
    else:
        raise ValueError(head)
    return e.d


def save_model_npz(path: str, **kw) -> None:
    """Write with numpy ``savez`` — byte-layout equivalent of chainer's
    ``serializers.save_npz(path, model, compression=False)``."""
    np.savez(path, **emit_model_npz(**kw))


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out", nargs="?", default=None)
    p.add_argument("--backbone", default="fpn")
    p.add_argument("--head", default="fpn")
    p.add_argument("--n-fg-class", type=int, default=79)
    p.add_argument("--manifest", action="store_true",
                   help="print the key manifest instead of writing a file")
    args = p.parse_args()
    d = emit_model_npz(args.backbone, args.head, args.n_fg_class)
    if args.manifest or not args.out:
        for k in sorted(d):
            print(f"{k}\t{d[k].shape if d[k].ndim else 'scalar'}\t{d[k].dtype}")
    if args.out:
        np.savez(args.out, **d)
        print(f"wrote {len(d)} arrays to {args.out}")
