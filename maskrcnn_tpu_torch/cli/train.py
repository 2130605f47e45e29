"""Training CLI of the port (counterpart of the JAX package's ``cli/train.py``).

    python -m maskrcnn_tpu_torch.cli.train --preset fpn_mask --out runs/x \\
        [--iterations N] [--batch-size B] [--image-size HxW] [--lr LR] \\
        [--resume | --weight CKPT] [--snapshot-every N] [--log-every N] \\
        [--eval-every N --eval-batches N] [--label-file F] [--seed S] \\
        [--dataset synthetic|coco|depth --coco-root DIR --coco-split S \\
         --eval-split S --category-filter A,B --buckets HxW,HxW \\
         --loader-workers N --depth-manifest LIST] \\
        [--pretrained-npz NPZ] [--profile-dir DIR] [--steps-per-dispatch K] \\
        [--set SECTION.KEY=VALUE ...] [--device cuda|cpu]

    torchrun --nproc_per_node N -m maskrcnn_tpu_torch.cli.train \\
        --data-parallel ...

Trains the preset's model (``fpn_mask``'s mask head, ``fpn_keypoint``'s
keypoint head, ``light_head``'s Light-Head R-CNN head or ``c4_res5``'s Res5
head on the C4 backbone, ``tiny_test``'s mask head or ``darknet_keypoint``'s
keypoint head on the Darknet backbone) on the GPU unless ``--device cpu``,
from the step-pure synthetic stream (``SyntheticDetectionData``,
``--seed``), a COCO-format directory (``--dataset coco``:
``<root>/annotations/instances_<split>.json`` or
``person_keypoints_<split>.json`` for the keypoint head, images under
``<root>/<split>/``) or depth frames (``--dataset depth``: a txt manifest
of npz files, ``DepthKeypointDataset``). ``--buckets`` sets ``train.image_buckets``: each COCO
image goes to the bucket that pads it least, and the run keeps one step
and one predict per bucket shape. Writes ``<out>/args.json``
(the flags and the effective config), ``<out>/log.jsonl`` (``main/*`` rows
every ``--log-every`` steps, ``validation/main/*`` rows from the in-run
evaluator) and full-state checkpoints ``<out>/checkpoints/step_<8 digits>.pt``
every ``--snapshot-every`` steps and at the end. ``--resume`` restarts from
the latest checkpoint exactly: the stream seeks to its step. The in-run
evaluator (mask AP, or OKS keypoint AP for the keypoint head) reads a
held-out stream, seed ``--seed + 999``: synthetic, for COCO a loader
without flips on ``--eval-split`` (default: the training split), and for
depth a loader on the same manifest, augmented as the training one is (as
in the JAX CLI).

The class names come from ``--label-file`` (default ``data/label_coco.txt``,
80 classes, except for the keypoint head and ``tiny_test``, which keep
their preset's classes)
and set ``model.n_fg_class``; ``--set`` is applied after them, so ``--set
model.n_fg_class=3`` trains 3 classes (with the COCO file's category names
when it has that many, else numbered names).

Mid-run control channel: write JSON to ``<out>/commands.json``; it is read
at the next logging boundary and renamed to ``commands.json.done``. Keys:
``{"snapshot": true}`` checkpoints now, ``{"eval": true}`` evaluates now,
``{"stop": true}`` checkpoints and exits.

``--data-parallel`` runs one process per GPU under ``torchrun`` (NCCL; gloo
with ``--device cpu``): ``--batch-size`` stays the global batch, each rank
takes its rows of the synthetic or depth stream's global batches or, from
COCO, batches of ``batch_size / world`` from its own slice of the images,
and the step is the global batch's (:mod:`maskrcnn_tpu_torch.parallel.
data_parallel`). The LR's epoch stays the whole dataset's. Rank 0 alone
writes ``args.json``, the log and the checkpoints, runs the in-run
evaluation while the others wait, and reads ``commands.json``, whose keys
it broadcasts; every rank restores the same checkpoint on ``--resume``.
``--pretrained-npz`` loads a chainer npz loosely (a full serialized model,
or an ImageNet ResNet-50's backbone; rank 0 loads, then every rank takes
its weights). ``--profile-dir`` writes a ``torch.profiler`` trace of steps
10–20 (Chrome trace JSON, which Perfetto and TensorBoard read; rank 0's
under DP; with chaining, the chains that span those steps). The program's
tracer (:mod:`maskrcnn_tpu_torch.utils.tracing`) is on for the lead rank
over the same steps, so the trace carries the step's spans (``train_call``,
``train.*``) and a chained step is captured again with its stage events;
the tracer's summary is printed beside the trace's path.

``--steps-per-dispatch K`` chains K optimizer steps into one call of the
step (``make_train_step(chain=K)``: on the GPU the replays of a CUDA graph
of the step, JAX's ``lax.scan``), with exactly the K sequential steps'
results. K follows the JAX CLI's rule (:func:`dispatch_chain`): 1 under
``--data-parallel``, with more than one bucket, or on the CPU unless asked;
else the largest divisor of the logging, snapshot and evaluation periods,
the steps left and the resumed step that is at most the cap
(``--steps-per-dispatch``, else 20), so every boundary falls on a chain's
end. The log still has one row per logged step, the same rows as K=1; the
non-finite trap reads every step's loss at the first chain end at or after
each multiple of 20.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

# the non-finite-loss trap reads the loss once every this many steps, so the
# host does not wait for the device on every step
TRAP_EVERY = 20
DEFAULT_LABELS = os.path.join(os.path.dirname(__file__), "..", "..", "data",
                              "label_coco.txt")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="fpn_mask",
                   help="a preset of maskrcnn_tpu_torch/config.py: the "
                        "FPN backbone with the mask head (fpn_mask) or the "
                        "keypoint head (fpn_keypoint), or the C4 backbone "
                        "with the light head (light_head) or the Res5 head "
                        "(c4_res5), or the Darknet backbone with the mask "
                        "head (tiny_test) or the keypoint head "
                        "(darknet_keypoint)")
    p.add_argument("--out", default="result", help="output directory")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--image-size", default=None,
                   help="HxW static padded size, e.g. 512x512")
    p.add_argument("--weight", default=None,
                   help="checkpoint to warm-start parameters and buffers from")
    p.add_argument("--resume", action="store_true",
                   help="exact resume from the latest checkpoint in --out")
    p.add_argument("--snapshot-every", type=int, default=5000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate every N iterations (0: never)")
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--dataset", default="synthetic",
                   choices=["synthetic", "coco", "depth"])
    p.add_argument("--coco-root", default=None,
                   help="COCO-format directory (--dataset coco)")
    p.add_argument("--coco-split", default="train2014")
    p.add_argument("--eval-split", default=None,
                   help="COCO split of the in-run evaluation (default: a "
                        "separate loader on the training split, which "
                        "measures training-set fit)")
    p.add_argument("--category-filter", default=None,
                   help="comma-separated COCO category names: keep the "
                        "images holding any of them")
    p.add_argument("--buckets", default=None,
                   help="comma-separated HxW static padding buckets, e.g. "
                        "800x1024,1024x800 (train.image_buckets)")
    p.add_argument("--loader-workers", type=int, default=1,
                   help="COCO decode threads per batch")
    p.add_argument("--depth-manifest", default=None,
                   help="txt list of npz depth frames (--dataset depth)")
    p.add_argument("--label-file", default=None,
                   help="class names, one per line; sets model.n_fg_class "
                        "(default: data/label_coco.txt, none for the "
                        "keypoint head and tiny_test)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--set", action="append", default=[], metavar="SEC.KEY=V",
                   help="config override, applied last, e.g. --set "
                        "model.freeze_bn=False")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; cpu on purpose)")
    p.add_argument("--data-parallel", action="store_true",
                   help="one process per GPU; launch under torchrun "
                        "--nproc_per_node N")
    p.add_argument("--pretrained-npz", default=None,
                   help="chainer npz to initialise from, loosely: a full "
                        "serialized reference model or an ImageNet "
                        "ResNet-50 (backbone only)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 10-20 here")
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help="optimizer steps chained into one call of the step "
                        "(a CUDA graph's replays on the GPU); default: up "
                        "to 20 on the GPU, 1 on the CPU")
    args = p.parse_args(argv)
    if args.steps_per_dispatch is not None and args.steps_per_dispatch < 1:
        p.error("--steps-per-dispatch must be at least 1")
    check_data_args(p, args)
    from maskrcnn_tpu_torch.parallel.data_parallel import launched_by_torchrun

    if args.data_parallel and not launched_by_torchrun():
        p.error("--data-parallel runs one process per GPU: launch it as "
                "torchrun --nproc_per_node N -m maskrcnn_tpu_torch.cli.train "
                "--data-parallel ...")
    return args


def check_data_args(parser, args):
    """``--dataset coco`` needs ``--coco-root`` and ``--dataset depth``
    ``--depth-manifest``; ``--buckets`` must parse."""
    if args.dataset == "coco" and not args.coco_root:
        parser.error("--dataset coco needs --coco-root")
    if args.dataset == "depth" and not getattr(args, "depth_manifest", None):
        parser.error("--dataset depth needs --depth-manifest")
    if args.buckets:
        try:
            parse_buckets(args.buckets)
        except ValueError:
            parser.error(f"--buckets {args.buckets!r}: expected HxW,HxW,...")


def parse_buckets(text: str) -> tuple[tuple[int, int], ...]:
    """'800x1024,1024x800' → ((800, 1024), (1024, 800))."""
    buckets = []
    for item in text.split(","):
        h, w = item.split("x")
        buckets.append((int(h), int(w)))
    return tuple(buckets)


def category_filter(text: str | None) -> list[str] | None:
    return [s.strip() for s in text.split(",") if s.strip()] if text else None


def coco_label_names(names, loader, cfg):
    """The class names of a COCO run: the label file's, else the annotation
    file's categories when there are ``n_fg_class`` of them, else None."""
    if names is None and len(loader.index.label_names) == cfg.model.n_fg_class:
        return loader.index.label_names
    return names



def dispatch_chain(steps_per_dispatch: int | None, *, on_cpu: bool,
                   data_parallel: bool, multi_shape: bool, log_every: int,
                   snapshot_every: int, eval_every: int, iterations: int,
                   start: int) -> tuple[int, str | None]:
    """The JAX CLI's choice of K, the steps chained into one call → (K, a
    note to print or None). K=1 under data parallelism, with more than one
    bucket shape, or with no steps left (a note if K > 1 was asked for); 1
    on the CPU when not asked for; else the largest divisor of gcd(log,
    snapshot, eval, steps left, start) that is at most the cap (the asked K,
    else 20), with a note when that is not the asked K."""
    asked = steps_per_dispatch
    total_left = iterations - start
    if data_parallel or multi_shape or total_left <= 0:
        note = None
        if asked and asked > 1:
            note = (f"[dispatch] --steps-per-dispatch {asked} ignored "
                    "(data-parallel or multi-bucket run)")
        return 1, note
    if asked is None and on_cpu:
        return 1, None
    g = math.gcd(log_every, snapshot_every)
    if eval_every:
        g = math.gcd(g, eval_every)
    g = math.gcd(g, total_left)
    if start:
        g = math.gcd(g, start)
    cap = asked if asked else 20
    chain = next(d for d in range(max(min(cap, g), 1), 0, -1) if g % d == 0)
    note = None
    if asked and chain != asked:
        note = (f"[dispatch] --steps-per-dispatch {asked} does not divide the "
                f"log/snapshot/eval boundaries; using {chain}")
    return chain, note


def build_config(preset: str, label_file: str | None, overrides: list[str],
                 train: dict | None = None):
    """(config, class names): the preset, the flag shortcuts in ``train``,
    the label file (default the COCO names, none for the keypoint head and
    ``tiny_test``, as in the JAX CLIs) as ``model.n_fg_class``, then
    ``--set``. Names that no longer match
    ``n_fg_class`` are dropped."""
    from maskrcnn_tpu_torch import config as cfg_lib

    cfg = cfg_lib.PRESETS[preset]()
    if train:
        cfg = cfg_lib._rep(cfg, train=train)
    keypoint = cfg_lib.apply_overrides(cfg, overrides).model.head == "fpn_keypoint"
    if (label_file is None and not keypoint and preset != "tiny_test"
            and os.path.exists(DEFAULT_LABELS)):
        label_file = DEFAULT_LABELS
    names = None
    if label_file:
        with open(label_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        cfg = cfg_lib._rep(cfg, model=dict(n_fg_class=len(names)))
    cfg = cfg_lib.apply_overrides(cfg, overrides)
    if names is not None and len(names) != cfg.model.n_fg_class:
        print(f"[labels] model.n_fg_class={cfg.model.n_fg_class} from --set: "
              f"the {len(names)} names of {label_file} are not used")
        names = None
    return cfg, names


def prepare_device(device):
    """The torch device of a run; on a GPU, float32 means float32 (TF32 off
    for matmuls and cuDNN)."""
    import torch

    from maskrcnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def main(argv=None):
    args = parse_args(argv)

    from maskrcnn_tpu_torch.parallel import data_parallel as dp

    train_over = {}
    if args.iterations is not None:
        train_over["iterations"] = args.iterations
    if args.lr is not None:
        train_over["lr"] = args.lr
    if args.batch_size is not None:
        train_over["batch_size"] = args.batch_size
    if args.image_size:
        train_over["image_size"] = tuple(int(v) for v in args.image_size.split("x"))
    if args.buckets:
        train_over["image_buckets"] = parse_buckets(args.buckets)
    cfg, label_names = build_config(args.preset, args.label_file, args.set,
                                    train_over)
    device = prepare_device(args.device)
    rank, world = 0, 1
    if args.data_parallel:
        device = dp.init_from_env(device)
        rank, world = dp.rank_world()
        if cfg.train.batch_size % world:
            raise SystemExit(f"--data-parallel: the global batch "
                             f"{cfg.train.batch_size} does not divide over "
                             f"{world} ranks")
        print(f"[dp] rank {rank} of {world} on {device} over "
              f"{dp.dist.get_backend()}: "
              f"{cfg.train.batch_size // world} of the global batch "
              f"{cfg.train.batch_size}")
    lead = rank == 0
    try:
        _train(args, cfg, label_names, device, rank, world, lead)
    finally:
        if args.data_parallel:
            dp.dist.destroy_process_group()


def _train(args, cfg, label_names, device, rank, world, lead):
    import numpy as np
    import torch

    from maskrcnn_tpu_torch import config as cfg_lib
    from maskrcnn_tpu_torch.data.prefetch import Prefetcher
    from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData
    from maskrcnn_tpu_torch.eval.evaluator import (
        evaluate_dataset,
        evaluate_keypoint_dataset,
    )
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
    from maskrcnn_tpu_torch.parallel import data_parallel as dp
    from maskrcnn_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_params_only,
        restore_checkpoint,
        save_checkpoint,
    )
    from maskrcnn_tpu_torch.train.state import create_train_state, lr_schedule
    from maskrcnn_tpu_torch.train.step import make_train_step, stack_batches
    from maskrcnn_tpu_torch.utils.metrics import MetricLogger

    filt = category_filter(args.category_filter)
    if args.dataset == "coco":
        from maskrcnn_tpu_torch.data.coco import COCODetectionLoader

        # this rank's slice of the images, in batches of its rows
        data = COCODetectionLoader(
            args.coco_root, args.coco_split,
            cfg_lib._rep(cfg, train=dict(batch_size=cfg.train.batch_size // world)),
            seed=args.seed, category_filter=filt)
        # the LR decays by epochs of the whole dataset
        cfg = cfg_lib._rep(cfg, train=dict(epoch_size=data.epoch_images))
        label_names = coco_label_names(label_names, data, cfg)
    elif args.dataset == "depth":
        from maskrcnn_tpu_torch.data.depth import DepthKeypointDataset

        data = DepthKeypointDataset(cfg, args.depth_manifest, seed=args.seed)
        cfg = cfg_lib._rep(cfg, train=dict(epoch_size=len(data)))
    else:
        data = SyntheticDetectionData(cfg, seed=args.seed)
    keypoint = cfg.model.head == "fpn_keypoint"

    if lead:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "args.json"), "w") as f:
            json.dump({"cli": vars(args), "config": dataclasses.asdict(cfg)},
                      f, indent=2, default=str)

    model = MaskRCNN(cfg, device=device, seed=args.seed)
    if args.pretrained_npz and lead:
        from maskrcnn_tpu_torch.utils.convert_chainer import load_pretrained_npz

        load_pretrained_npz(model, args.pretrained_npz, cfg.model.backbone,
                            cfg.model.head, cfg.model.n_mask_convs)
    if world > 1:
        dp.replicate(model)
    state = create_train_state(cfg, model, seed=args.seed + 1)
    ckpt_dir = os.path.join(args.out, "checkpoints")
    if args.resume:
        path = latest_checkpoint(ckpt_dir)
        if path:
            restore_checkpoint(path, state)
            print(f"resumed from {path} at step {state.step}")
    elif args.weight:
        load_params_only(args.weight, state)
        print(f"warm-started parameters and buffers from {args.weight}")
    start = state.step

    # step-pure stream, prepared on a thread while the device steps
    if args.dataset == "coco":
        stream = data.iter_from(start, n_workers=args.loader_workers)
    else:
        stream = data.iter_from(start)
        if world > 1:
            stream = dp.shard_stream(stream, rank, world)
    multi_shape = (args.dataset == "coco" and cfg.train.image_buckets is not None
                   and len(cfg.train.image_buckets) > 1)
    chain, note = dispatch_chain(
        args.steps_per_dispatch, on_cpu=device.type == "cpu",
        data_parallel=args.data_parallel, multi_shape=multi_shape,
        log_every=args.log_every, snapshot_every=args.snapshot_every,
        eval_every=args.eval_every, iterations=cfg.train.iterations,
        start=start)
    if note and lead:
        print(note)
    if chain > 1 and lead:
        print(f"[dispatch] chaining {chain} steps per call of the step")
    # hold a chain's worth of batches, and the next
    batches = Prefetcher(stream, size=max(2, 2 * chain))
    steps = {}  # one train step per bucket shape (and chain length)

    def step_for(hw):
        if hw not in steps:
            steps[hw] = (make_train_step(cfg, image_size=hw) if chain == 1 else
                         make_train_step(cfg, image_size=hw, chain=chain))
        return steps[hw]

    sched = lr_schedule(cfg)
    if lead and cfg.train.iterations // cfg.train.lr_decay_period > 3:
        print(f"[lr] WARNING: lr decays ×{cfg.train.lr_decay_factor} every "
              f"{cfg.train.lr_decay_period} steps — "
              f"{cfg.train.iterations // cfg.train.lr_decay_period} decays "
              "over this run (epoch-aware period on a small dataset?). "
              "Override with --set train.lr_decay_every_iters=N.")
    logger = MetricLogger(args.out, print_every=args.log_every) if lead else None

    def poll_commands():
        """Rank 0 reads ``commands.json``; every rank gets what it read."""
        cmds = {}
        path = os.path.join(args.out, "commands.json")
        if lead and os.path.exists(path):
            try:
                with open(path) as f:
                    cmds = json.load(f)
                os.replace(path, path + ".done")
            except (OSError, json.JSONDecodeError):
                cmds = {}
        cmds = cmds if isinstance(cmds, dict) else {}
        return dp.broadcast_object(cmds) if world > 1 else cmds

    predict_cache = {}

    def held_out():
        """A held-out stream of its own, read from its start every time (a
        loader apart from the training one, whose epoch cache the prefetch
        thread uses). The depth loader keeps its default augmentation, as
        the JAX CLI's does. COCO reads the whole split, whatever the rank."""
        if args.dataset == "coco":
            if args.eval_split is None:
                print("[eval] note: no --eval-split; evaluating a separate "
                      "loader on the training split (training-set fit)")
            return iter(COCODetectionLoader(
                args.coco_root, args.eval_split or args.coco_split, cfg,
                seed=args.seed + 999, flip=False, category_filter=filt,
                split_by_rank=False))
        if args.dataset == "depth":
            return iter(DepthKeypointDataset(cfg, args.depth_manifest,
                                             seed=args.seed + 999))
        return iter(SyntheticDetectionData(cfg, seed=args.seed + 999))

    def run_eval(step_i):
        """Rank 0 evaluates; the other ranks wait for it."""
        if lead:
            evaluate(step_i)
        if world > 1:
            dp.dist.barrier()

    def evaluate(step_i):
        t0 = time.perf_counter()
        if keypoint:
            rep = evaluate_keypoint_dataset(cfg, state.model, held_out(),
                                            args.eval_batches,
                                            predict_cache=predict_cache)
        else:
            rep = evaluate_dataset(cfg, state.model, held_out(),
                                   args.eval_batches, label_names=label_names,
                                   predict_cache=predict_cache)
        secs = time.perf_counter() - t0
        n_images = args.eval_batches * cfg.train.batch_size
        print(f"[eval @{step_i}] " + " ".join(
            f"{k}={v:.4f}" for k, v in rep.items()
            if "/" not in k or k.startswith("coco"))
            + f" ({secs:.1f} s, {secs / n_images:.3f} s/image)")
        # to the JSONL, not only stdout: the round-4 0.0-AP run was
        # invisible in its own log
        logger.log_validation(step_i, rep)
        aps = [v for k, v in rep.items() if "/" not in k]
        if aps and max(aps) == 0.0 and step_i >= 1000:
            print(f"[eval @{step_i}] *** WARNING: every eval metric is 0.0 "
                  "after 1000+ steps — the model is training blind. Check "
                  "the gradient path, the predict path on a known-good "
                  "checkpoint, and the data. ***")

    def snapshot(step_i):
        if lead:
            return save_checkpoint(ckpt_dir, state, step_i)

    profiler, profiled, first_profiled = None, False, None
    it = start
    while it < cfg.train.iterations:
        if chain > 1:
            batch = stack_batches([next(batches) for _ in range(chain)])
            hw = tuple(batch.images.shape[2:4])
        else:
            batch = next(batches)
            hw = tuple(batch.images.shape[1:3])
        if (args.profile_dir and lead and not profiled and profiler is None
                and it + chain - start > 10):
            profiler, first_profiled = start_profiler(device), it + 1
        metrics = step_for(hw)(state, batch)
        if chain == 1:
            metrics = {k: v.reshape(1) for k, v in metrics.items()}
        step_i = it + chain
        if profiler is not None and step_i - start >= 20:
            path, summary = stop_profiler(profiler, device, args.profile_dir, rank)
            print(f"[profile] steps {first_profiled}-{step_i}: {path}")
            print(f"[profile] tracing summary: {json.dumps(summary)}")
            profiler, profiled = None, True
        if step_i // TRAP_EVERY > it // TRAP_EVERY:
            # every rank reads the same summed loss, so all stop together
            losses = metrics["loss"].float().cpu().numpy()
            if not np.isfinite(losses).all():
                path = snapshot(step_i)
                bad = it + 1 + int(np.argmin(np.isfinite(losses)))
                parts = {k: v.tolist() for k, v in metrics.items()}
                raise SystemExit(f"[trap] non-finite loss at step {bad} "
                                 f"(chain ending {step_i}); breakdown {parts}; "
                                 f"state dumped to {path}")
        for j, s in enumerate(range(it + 1, step_i + 1)):
            if not lead or (s % args.log_every and s != 1):
                continue
            scalars = {k: float(v[j]) for k, v in metrics.items()}
            # share of batch fetches that found the prefetch queue empty
            # (near 1: the host's data preparation bounds the run)
            scalars["prefetch_starved"] = batches.starved / max(batches.served, 1)
            if hasattr(data, "padding_waste"):
                scalars["padding_waste"] = data.padding_waste()
            if device.type == "cuda":
                scalars["peak_memory_gib"] = (
                    torch.cuda.max_memory_allocated(device) / 2**30)
            logger.log(s, scalars,
                       n_images=cfg.train.batch_size * args.log_every,
                       lr=sched(s))
        if step_i % args.snapshot_every == 0 or step_i == cfg.train.iterations:
            if lead:
                print(f"saved {snapshot(step_i)}")
        if args.eval_every and step_i % args.eval_every == 0:
            run_eval(step_i)
        if step_i % args.log_every == 0:
            cmds = poll_commands()
            if cmds.get("snapshot") and lead:
                print(f"[commands] snapshot at {step_i}: {snapshot(step_i)}")
            if cmds.get("eval"):
                run_eval(step_i)
            if cmds.get("stop"):
                print(f"[commands] stop at {step_i}")
                snapshot(step_i)
                break
        it = step_i
    if logger is not None:
        logger.close()


def start_profiler(device):
    """A started ``torch.profiler`` over the host and, on a GPU, the card
    (after the steps before it have finished there), with the program's
    tracer on."""
    import torch

    from maskrcnn_tpu_torch.utils import tracing

    tracing.reset()
    tracing.enable()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_profiler(profiler, device, out_dir: str, rank: int) -> tuple[str, dict]:
    """Stop the profiler and the tracer and write the Chrome trace → (the
    file's path, the tracer's summary)."""
    import torch

    from maskrcnn_tpu_torch.utils import tracing

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    tracing.disable()
    summary = tracing.summary()
    tracing.reset()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_rank{rank}.json")
    profiler.export_chrome_trace(path)
    return path, summary


if __name__ == "__main__":
    main()
