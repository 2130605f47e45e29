"""The comparisons that decide ``correct``: what the program served or
trained against the plain reference (:mod:`benchmark.reference`), run once
the window has closed and the program's state is freed. Each returns the
numbers it compared, by name; a cell's workload file gives each its limit.

Serving, per sampled request: every valid detection the program served is
matched, by its class and the nearest box, to the reference's candidate
(class, proposal) pairs of the same image, which come from the
reference's own backbone, RPN, proposals' NMS and box branch; the widest
score gap and box gap over all of them are two numbers. The mask or
keypoint branch of the reference runs on the program's own detection boxes,
labels and the matched proposals' levels, and the widest gap of the masks
(or of the heatmap logits, over their largest magnitude or 1) is a third.
Per-class NMS and the global top-``max_detections`` merge: for each
request the widest gap between the program's scores and the reference's
own detections' scores, both sorted; over the requests their median
(``rank_gap``) and their widest (``rank_gap_widest``). Where the program's
pool is not the reference's operations in their order, two boxes of a
class whose scores differ by rounding alone can swap places in the greedy
order and change which others they suppress, now and then in a sound
request: there the median is held and the widest reported beside. A
cell's workload file names the numbers it holds to a limit; the others
are reported beside them.

Training, over the first call's first steps (the eager step and the
replays after it): each step's loss (its relative gap), the gradient as
the optimizer got it (from its momentum buffers after the step and
before), and the parameters' change, both taken by the worst leaf. The
reference takes step 1 from the seed and each later step from the
program's own state before it, so no step inherits a gap from the one
before. A leaf's gap is the gap between the program's norm of the leaf
and the reference's, over the larger of the reference's norm of that leaf
and of the median leaf. Leaves whose gradient in the reference is under a
thousandth of the median leaf's are left out of that step: they move by
round-off alone. Beside them, :func:`parting` reports how far the
reference's own second step (from its own first) lies from the program's,
and what it picked differently.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import NamedTuple

import torch

from benchmark.reference.predict import candidates, detections, second_pass

def free_device():
    """Let go of what the program held on the device before the reference
    runs: a process's peak of device memory never falls again."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def tf32(on: bool):
    """Inside, matrix products and cuDNN convolutions may use TF32 or not:
    the reference runs in float32 with TF32 off, and its control with it
    on."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


class Served(NamedTuple):
    """A batch-1 request's detections on the host, as the program's
    predict returns them."""

    boxes: torch.Tensor  # (1, D, 4)
    scores: torch.Tensor  # (1, D)
    labels: torch.Tensor  # (1, D)
    valid: torch.Tensor  # (1, D)
    masks: torch.Tensor | None  # (1, D, S, S)
    heatmaps: torch.Tensor | None  # (1, D, 56, 56, K)


# a gap that cannot be measured (no candidate of a class) reads this
UNMATCHED = 1e9
LEAF_FLOOR = 1e-3


def _max(values) -> float:
    values = list(values)
    return max(values) if values else 0.0


def serve_numbers(cfg, model, requests: dict, served: dict) -> tuple[dict, dict]:
    """``requests`` maps an image index to its (images, img_hw, scale)
    numpy arrays (batch 1); ``served`` a request index to (image index,
    Detections of host tensors) → ({score_gap, box_gap_px, mask_gap or
    heatmap_gap, rank_gap, rank_gap_widest}, {requests, detections}
    compared)."""
    dev = model.device
    keypoint = cfg.model.head == "fpn_keypoint"
    gaps = {"score_gap": [], "box_gap_px": [],
            "heatmap_gap" if keypoint else "mask_gap": []}
    counted = {"requests": 0, "detections": 0}
    rank_gaps = []
    by_image = {}
    for idx, (img, out) in served.items():
        by_image.setdefault(img, []).append(out)
    with torch.no_grad():
        for img, outs in sorted(by_image.items()):
            images, img_hw, scale = (torch.as_tensor(x, device=dev)
                                     for x in requests[img])
            cand = candidates(cfg, model, images[0], img_hw[0].float(),
                              scale[0].float())
            ref = detections(cfg, cand)
            ref_sorted = torch.sort(torch.where(ref.valid, ref.scores, 0.0),
                                    descending=True).values
            for out in outs:
                counted["requests"] += 1
                valid = out.valid[0].to(dev)
                labels = out.labels[0].to(dev)[valid].long()
                boxes = out.boxes[0].to(dev)[valid]
                scores = out.scores[0].to(dev)[valid]
                served_sorted = torch.sort(
                    torch.where(valid, out.scores[0].to(dev), 0.0),
                    descending=True).values
                rank_gaps.append(float((served_sorted - ref_sorted).abs().max()))
                counted["detections"] += labels.numel()
                if labels.numel() == 0:
                    continue
                dist = (cand.boxes[labels] - boxes[:, None, :]).abs().amax(-1)
                dist = torch.where(cand.valid[labels], dist,
                                   torch.full_like(dist, math.inf))
                best, roi = dist.min(dim=1)
                if not torch.isfinite(best).all():
                    gaps["box_gap_px"].append(UNMATCHED)
                    gaps["score_gap"].append(UNMATCHED)
                    continue
                gaps["box_gap_px"].append(float(best.max()))
                ref_scores = cand.scores[labels, roi]
                gaps["score_gap"].append(float((ref_scores - scores).abs().max()))
                second = second_pass(cfg, model, cand.features, boxes, labels,
                                     cand.levels[roi])
                if keypoint:
                    heat = out.heatmaps[0].to(dev)[valid]
                    gaps["heatmap_gap"].append(float(
                        (heat - second).abs().max() / max(1.0, float(second.abs().max()))))
                else:
                    masks = out.masks[0].to(dev)[valid]
                    gaps["mask_gap"].append(float((masks - second).abs().max()))
    numbers = {name: _max(v) for name, v in gaps.items()}
    numbers["rank_gap"] = statistics.median(rank_gaps) if rank_gaps else 0.0
    numbers["rank_gap_widest"] = _max(rank_gaps)
    return numbers, counted


def _norms(leaves: dict) -> dict:
    return {name: float(t.double().norm()) for name, t in leaves.items()}


def leaf_gaps(program: dict, reference: dict, kept: list) -> list:
    """Each of the ``kept`` leaves' (names) gap of norms, over the larger of
    the reference's norm and the median leaf's."""
    if not kept:
        return []
    a, b = _norms({k: program[k] for k in kept}), _norms({k: reference[k] for k in kept})
    median = statistics.median(b.values())
    return [abs(a[k] - b[k]) / max(b[k], median) for k in kept]


def moved_leaves(ref_grad: dict) -> list:
    """Leaves whose reference first gradient is at least ``LEAF_FLOOR``
    of the median leaf's."""
    norms = _norms(ref_grad)
    median = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= LEAF_FLOOR * median]


def train_numbers(program: dict, reference: dict) -> tuple[dict, dict]:
    """Each side: ``losses``, ``grads`` and ``changes`` (each a list over
    the steps; a step's gradient and change map a leaf's name to a tensor)
    → ({loss_gap, grad_gap, update_gap}, each the widest over the steps;
    each step's numbers, reported beside them)."""
    steps = {"loss_gaps": [], "grad_gaps": [], "update_gaps": [], "leaves": []}
    for i, (ref_grad, grad) in enumerate(zip(reference["grads"], program["grads"])):
        p, r = program["losses"][i], reference["losses"][i]
        kept = moved_leaves(ref_grad)
        missing = [k for k in kept if k not in grad]
        steps["loss_gaps"].append(abs(p - r) / abs(r))
        steps["grad_gaps"].append(
            1.0 if missing else _max(leaf_gaps(grad, ref_grad, kept)))
        steps["update_gaps"].append(_max(leaf_gaps(
            program["changes"][i], reference["changes"][i], kept)))
        steps["leaves"].append(len(kept))
    numbers = {name: _max(steps[f"{name}s"])
               for name in ("loss_gap", "grad_gap", "update_gap")}
    return numbers, {"per_step": steps}


def apart(a_boxes, a_valid, b_boxes, b_valid, tol: float = 0.01) -> int:
    """How many valid boxes of ``a`` (B, n, 4) have no valid box of ``b``
    within ``tol`` pixels in every coordinate, image by image."""
    count = 0
    for ab, av, bb, bv in zip(a_boxes, a_valid, b_boxes, b_valid):
        a, b = ab[av], bb[bv]
        if b.shape[0] == 0:
            count += a.shape[0]
            continue
        near = ((a[:, None, :] - b[None, :, :]).abs().amax(-1) <= tol).any(1)
        count += int((~near).sum())
    return count


def parting(loss: float, grad: dict, own_loss: float, own_grad: dict,
            forced, own, top: int = 5) -> dict:
    """The program's second step (``loss``, ``grad``) against the
    reference's own second step, taken from its own first: the loss gap,
    the worst leaf and the leaves that part most, and how many kept
    proposals and sampled ROIs of the reference's own step have no match
    in what the step forced from the program's state picked (``forced``
    and ``own`` are the two steps' Chosen)."""
    kept = [k for k in moved_leaves(own_grad) if k in grad]
    gaps = sorted(zip(leaf_gaps(grad, own_grad, kept), kept), reverse=True)
    return {
        "loss_gap": abs(loss - own_loss) / abs(own_loss),
        "worst_leaves": [[name, gap] for gap, name in gaps[:top]],
        "proposals_apart": apart(own.proposals, own.proposals_valid,
                                 forced.proposals, forced.proposals_valid),
        "proposals": int(own.proposals_valid.sum()),
        "rois_apart": apart(own.rois, own.rois_valid, forced.rois, forced.rois_valid),
        "rois": int(own.rois_valid.sum())}


def verdict(numbers: dict, limits: dict) -> tuple[bool, list, dict]:
    """→ (every number that ``limits`` names is within its limit, [(name,
    number, limit)] of those, the other numbers). A named number that is
    missing or not finite fails."""
    rows = [(name, numbers.get(name, math.inf), limit) for name, limit in limits.items()]
    ok = all(math.isfinite(value) and value <= limit for _, value, limit in rows)
    return ok, rows, {k: v for k, v in numbers.items() if k not in limits}
