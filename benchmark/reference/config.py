"""One dataclass config with presets named after the reference configs.

Replaces the reference's argparse-duplicated flags + string-keyed constructor
branches (reference chainer_maskrcnn/model/maskrcnn.py:52-124, train.py:62-76)
with a single typed config (SURVEY §5 "Config / flag system" gap).

All shape-determining fields are static Python values so one config compiles
to one XLA program: image sizes are bucketed, proposal/ROI counts are fixed
slot counts with validity masks.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    base_size: float = 16.0
    # Per-level single scale, reference FPN: sizes/16 = [2,4,8,16,32]
    # (reference model/extractor/feature_pyramid_network.py:42-44).
    scales: tuple[float, ...] = (2.0, 4.0, 8.0, 16.0, 32.0)


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    """Proposal budgets (reference: chainercv ProposalCreator defaults,
    readable copy at reference utils/proposal_creator.py:53-69)."""

    nms_thresh: float = 0.7
    # Reference budgets: 12000/2000 train, 6000/300 test — the DEFAULT.
    # The round-2 A/B (BASELINE.md) measured the full budgets improving
    # early-training AP substantially (+0.19 mAP50 at 500 steps) over the
    # round-1 trimmed 2000/1000 for ~4% step cost (affordable via the
    # chunked exact NMS, ops/nms.py). Quality is the default; the `fast`
    # preset opts into the trimmed budgets for raw throughput.
    n_train_pre_nms: int = 12000
    n_train_post_nms: int = 2000
    n_test_pre_nms: int = 6000
    n_test_post_nms: int = 300
    min_size: float = 16.0


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """ProposalTargetCreator hyperparams
    (reference utils/proposal_target_creator.py:13-24)."""

    n_sample: int = 256
    pos_ratio: float = 0.25
    pos_iou_thresh: float = 0.5
    neg_iou_thresh_hi: float = 0.5
    neg_iou_thresh_lo: float = 0.0
    loc_normalize_mean: tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    loc_normalize_std: tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)


@dataclasses.dataclass(frozen=True)
class AnchorTargetConfig:
    """AnchorTargetCreator hyperparams (chainercv defaults, SURVEY §2c)."""

    n_sample: int = 256
    pos_iou_thresh: float = 0.7
    neg_iou_thresh: float = 0.3
    pos_ratio: float = 0.5


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone: Literal["fpn", "c4", "darknet"] = "fpn"
    head: Literal["fpn", "fpn_keypoint", "light", "res5"] = "fpn"
    # reference data/label_coco.txt carries 80 entries (the standard COCO
    # set, person..toothbrush; its last line is newline-unterminated so
    # `wc -l` reads 79 — the source of the round-1..3 "79 classes" error).
    # The reference's n_fg_class = len(f.readlines()) = 80 (train.py:92-93).
    n_fg_class: int = 80
    n_keypoints: int = 17
    n_mask_convs: int = 4  # keypoint head default 8 (train_keypoints.py:87)
    roi_size_box: int = 7
    roi_size_mask: int = 14
    mask_size: int = 28  # head-dependent: fpn 28, light/res5 14, keypoint 56
    fpn_channels: int = 256
    freeze_bn: bool = True
    # compute dtype for conv/matmul-heavy paths; params stay float32.
    dtype: str = "float32"
    # keypoint heatmap 2x upsample: "half_pixel" (jax.image.resize linear)
    # or "align_corners" (chainer F.resize_images exact — parity sweeps).
    kp_upsample: str = "half_pixel"
    # fused-path scatter accumulator dtype: float32 (exact) or bfloat16
    # (halves the zero/shift-bound kernel's traffic; XLA-scatter parity).
    roi_align_acc: str = "float32"
    # ROIAlign implementation: auto (region for FPN, gather single-level),
    # or force region / gather / pallas (the hand-written TPU kernel) /
    # fused (region forward + Pallas tile-accumulator scatter backward —
    # see ops/roi_align.py `_mlra_region_pair_fused`).
    roi_align: str = "auto"
    # rematerialize backbone activations in the backward pass — trades
    # FLOPs for HBM, unlocking larger per-chip batches.
    remat: bool = False
    # Space-to-depth stem conv for ResNet backbones: identical param tree
    # and numerics (up to bf16 rounding), ~3x faster on TPU (XLA pads the
    # direct conv's 3 input channels to the MXU lane width). Disable to A/B
    # against the direct 7x7/2 conv.
    stem_s2d: bool = True
    # Reproduce the reference Light-Head mask-branch bug (convs computed
    # then discarded, deconv on the raw pool — light_roi_mask_head.py:101-104).
    # Required to load the published reference checkpoint, whose deconv was
    # lazily initialized against the 490-ch pool.
    compat_mask_bug: bool = False

    @property
    def n_class(self) -> int:
        return self.n_fg_class + 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 2
    image_size: tuple[int, int] = (800, 1024)  # primary padded bucket (H, W)
    # optional extra static buckets: the data loader assigns each image to
    # the bucket minimizing padding waste (by aspect ratio) and emits
    # whole batches per bucket; the train loop keeps one compiled step per
    # bucket (SURVEY §5 "bucketed padded resolutions" — the reference eats
    # dynamic shapes instead). None → single-bucket (image_size only).
    image_buckets: tuple[tuple[int, int], ...] | None = None
    lr: float = 1e-3
    momentum: float = 0.9
    # dtype of the SGD momentum buffer; "bfloat16" halves optimizer-state
    # HBM traffic (params stay f32). None → f32.
    momentum_dtype: str | None = None
    weight_decay: float = 5e-4
    iterations: int = 200_000
    lr_decay_factor: float = 0.1
    # LR decays every N EPOCHS (reference ExponentialShift('lr', 0.1) with an
    # epoch trigger — train.py:140; keypoints every 3, train_keypoints.py:158).
    # The step period scales with batch_size so batch-8 training decays at the
    # same data-epoch points as the reference's batch-1 run.
    lr_decay_every_epochs: float = 2.0
    # images per epoch; the CLI overwrites this with len(dataset). Default is
    # COCO-2014-train-ish so the bs1 default period lands near the reference.
    epoch_size: int = 80_000
    # explicit step-period override; when set, epochs/epoch_size are ignored.
    lr_decay_every_iters: int | None = None

    @property
    def lr_decay_period(self) -> int:
        """LR decay period in optimizer steps (batch-size aware)."""
        if self.lr_decay_every_iters is not None:
            return self.lr_decay_every_iters
        return max(
            1,
            int(round(self.epoch_size * self.lr_decay_every_epochs
                      / self.batch_size)),
        )
    # gradient accumulation: split the batch into this many micro-batches
    # inside one optimizer step (lax.scan). With frozen BN the update is
    # mathematically identical to the full batch; peak activation memory
    # drops by the factor — the single-chip path for batch ≥ 32 at 800×1024
    # (the alternative is DP over more chips).
    grad_accum_steps: int = 1
    max_gt: int = 64  # padded GT slots per image
    gt_mask_size: int = 112  # GT masks stored at this res, ROIAligned to targets
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    score_thresh: float = 0.05  # use_preset('evaluate'), SURVEY §2c
    nms_thresh: float = 0.3
    max_detections: int = 100
    # mask pass-2 pooling levels: "pass1" = the levels of the pass-1 ROIs
    # that produced each detection (EXACT reference behavior —
    # maskrcnn.py:215-229 threads `levels` into predict_mask);
    # "refined" = recompute from the refined boxes. A/B in BASELINE.md.
    mask_levels: str = "pass1"


def use_preset(cfg: "Config", preset: str) -> "Config":
    """chainercv FasterRCNN.use_preset equivalent (SURVEY §2c):
    'evaluate' → score 0.05 / NMS 0.3; 'visualize' → score 0.7 / NMS 0.3."""
    if preset == "evaluate":
        ev = dict(score_thresh=0.05, nms_thresh=0.3)
    elif preset == "visualize":
        ev = dict(score_thresh=0.7, nms_thresh=0.3)
    else:
        raise ValueError(f"unknown preset {preset!r}")
    return _rep(cfg, eval=ev)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    anchors: AnchorConfig = AnchorConfig()
    proposals: ProposalConfig = ProposalConfig()
    sampler: SamplerConfig = SamplerConfig()
    anchor_targets: AnchorTargetConfig = AnchorTargetConfig()
    train: TrainConfig = TrainConfig()
    eval: EvalConfig = EvalConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _rep(cfg: Config, **sections) -> Config:
    out = cfg
    for name, changes in sections.items():
        out = dataclasses.replace(out, **{name: dataclasses.replace(getattr(out, name), **changes)})
    return out


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``SEC.KEY=VALUE`` strings (the CLIs' ``--set`` flag) — typed by
    the field's current value; tuples accept both ``,`` and ``x``
    separators (``train.image_size=512x512``)."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        section, _, field = key.partition(".")
        cur = getattr(getattr(cfg, section), field)  # raises on bad keys
        if isinstance(cur, bool):
            typed = val in ("True", "true", "1")
        elif isinstance(cur, tuple):
            typed = tuple(int(v) for v in val.replace("x", ",").split(",") if v)
        elif cur is None:
            # untyped (None-default) field: numbers should arrive as
            # numbers — lr_decay_every_iters="100000" reached the LR
            # schedule as a string and crashed `step // period` at trace
            typed = val
            for cast in (int, float):
                try:
                    typed = cast(val)
                    break
                except ValueError:
                    pass
        else:
            typed = type(cur)(val)
        cfg = _rep(cfg, **{section: {field: typed}})
    return cfg


# ---------------------------------------------------------------------------
# Presets mirroring the reference's runnable configurations (SURVEY §5).
# ---------------------------------------------------------------------------

def fpn_mask() -> Config:
    """FPN Mask R-CNN — reference `train.py --backbone fpn --head-arch fpn`."""
    # landscape + portrait buckets: COCO is ~2:1 landscape:portrait; a
    # single 800×1024 bucket wastes ~22% padded area on portrait images.
    return _rep(
        Config(),
        train=dict(image_buckets=((800, 1024), (1024, 800))),
    )


def fpn_keypoint() -> Config:
    """Keypoint R-CNN — reference train_keypoints.py (COCO person)."""
    cfg = Config()
    return _rep(
        cfg,
        model=dict(head="fpn_keypoint", n_fg_class=1, n_keypoints=17,
                   n_mask_convs=8, mask_size=56),
        # reference train_keypoints.py:158: lr ×0.1 every 3 epochs
        train=dict(lr_decay_every_epochs=3.0),
    )


def light_head() -> Config:
    """Light-Head R-CNN — reference `--head-arch light` (single level C4)."""
    cfg = Config()
    return _rep(
        cfg,
        model=dict(backbone="c4", head="light", mask_size=14),
        anchors=dict(scales=(8.0, 16.0, 32.0)),
    )


def c4_res5() -> Config:
    """C4 backbone + Res5 head — reference `--backbone c4 --head-arch res5`."""
    cfg = Config()
    return _rep(
        cfg,
        model=dict(backbone="c4", head="res5", mask_size=14),
        anchors=dict(scales=(8.0, 16.0, 32.0)),
    )


def darknet_keypoint(n_keypoints: int = 20) -> Config:
    """Darknet + keypoint head — reference viewer.py:17-18 (depth camera)."""
    cfg = Config()
    return _rep(
        cfg,
        model=dict(backbone="darknet", head="fpn_keypoint", n_fg_class=1,
                   n_keypoints=n_keypoints, n_mask_convs=2, mask_size=56),
        anchors=dict(scales=(4.0,)),  # anchor_sizes=[64] → 64/16
        proposals=dict(n_test_pre_nms=50, n_test_post_nms=10),  # maskrcnn.py:73-74
        train=dict(image_size=(256, 320), batch_size=8,
                   lr_decay_every_epochs=3.0),
    )


def parity() -> Config:
    """Alias of ``fpn_mask``: since round 3 the default preset already
    carries the reference's full proposal budgets (the round-2 A/B showed
    they win on AP — BASELINE.md). Kept for CLI/docs continuity."""
    return fpn_mask()


def fast() -> Config:
    """FPN Mask R-CNN with TRIMMED proposal budgets (2000/1000 train,
    1000/300 test) — the round-1 throughput configuration. ~4% faster per
    step than the reference budgets at a measured early-training quality
    cost (−0.19 mAP50 at 500 synthetic steps, BASELINE.md round-2 A/B).
    Opt-in; the default preset keeps reference-budget quality."""
    return _rep(
        fpn_mask(),
        proposals=dict(n_train_pre_nms=2000, n_train_post_nms=1000,
                       n_test_pre_nms=1000, n_test_post_nms=300),
    )


# Tiny config for tests/smoke: darknet + fpn mask head on small images.
def tiny_test() -> Config:
    cfg = Config()
    return _rep(
        cfg,
        model=dict(backbone="darknet", head="fpn", n_fg_class=3,
                   fpn_channels=64, mask_size=28),
        anchors=dict(scales=(4.0,)),
        proposals=dict(n_train_pre_nms=512, n_train_post_nms=64,
                       n_test_pre_nms=256, n_test_post_nms=32),
        sampler=dict(n_sample=32),
        anchor_targets=dict(n_sample=64),
        train=dict(batch_size=2, image_size=(128, 160), max_gt=8,
                   gt_mask_size=56,
                   # smoke runs use tiny datasets where epoch-aware decay
                   # would collapse the LR within steps; pin a long period
                   lr_decay_every_iters=10_000),
    )


PRESETS = {
    "fpn_mask": fpn_mask,
    "parity": parity,
    "fast": fast,
    "fpn_keypoint": fpn_keypoint,
    "light_head": light_head,
    "c4_res5": c4_res5,
    "darknet_keypoint": darknet_keypoint,
    "tiny_test": tiny_test,
}
