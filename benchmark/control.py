"""The controls of ``correct``: the reference put in the program's place,
computed one step of precision below the configuration's (TF32 for
float32 with TF32 off), or for training with half of each batch left out,
and held to the same comparison as a run; and for training, faults
planted in the program's replayed step, run as a cell's run with a short
window. Each seed prints one JSON line with the numbers and whether the
cell's limits would pass them; a control or fault that passes shows a
comparison too weak to catch it.

    python -m benchmark.control --workload <cell> --seeds 1,2,3
        [--fault tf32|half_batch|replay_half_batch|replay_stale_input|
                 dp_skip_allreduce|dp_local_counts]

The reference's controls have no measured window: they make what a run's
comparison reads (the sampled requests, or the first call's steps) and
nothing else. The planted faults need a card: ``replay_half_batch``
replays each step on the first half of its rows twice over (half the batch
left out, the mean taken over the rest), ``replay_stale_input`` replays
without staging the step's batch (every replay reads the capture's). In a
data-parallel cell (``train_dp``, where they also run on the CPU over
gloo), ``dp_skip_allreduce``: the last rank joins the gradients' all-reduce
but keeps its own gradients (the exchange between cards left out there);
``dp_local_counts``: every rank's losses divide by its own counts, not the
counts summed over the ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from benchmark import compare
from benchmark.run import Run

FAULTS = ("tf32", "half_batch")
PLANTED = ("replay_half_batch", "replay_stale_input")
PLANTED_DP = ("dp_skip_allreduce", "dp_local_counts")


def served_by_reference(run, fault: str):
    """What the reference serves for a run's sampled requests, under
    ``fault`` → (config, requests, request index → (image, Served))."""
    from benchmark.reference.predict import candidates, detections, second_pass
    from benchmark.traffic.serve_closed import make_requests, plan, reference_model

    params = run.work["params"]
    rcfg = run.reference_config()
    order, sample = plan(run, params)
    requests = make_requests(run, params)
    model = reference_model(run, rcfg)
    dev = model.device
    served = {}
    keypoint = rcfg.model.head == "fpn_keypoint"
    with torch.no_grad(), compare.tf32(fault == "tf32"):
        for i in sorted(sample):
            img = int(order[i % len(order)])
            images, img_hw, scale = (torch.as_tensor(x, device=dev)
                                     for x in requests[img])
            cand = candidates(rcfg, model, images[0], img_hw[0].float(),
                              scale[0].float())
            det = detections(rcfg, cand)
            second = second_pass(rcfg, model, cand.features, det.boxes,
                                 det.labels, det.levels)
            out = compare.Served(
                det.boxes[None].cpu(), det.scores[None].cpu(),
                det.labels[None].int().cpu(), det.valid[None].cpu(),
                None if keypoint else second[None].cpu(),
                second[None].cpu() if keypoint else None)
            served[i] = (img, out)
    del model
    compare.free_device()
    return rcfg, requests, served


def serve_control(run, fault: str) -> dict:
    from benchmark.traffic.serve_closed import reference_model

    rcfg, requests, served = served_by_reference(run, fault)
    model = reference_model(run, rcfg)
    numbers, counted = compare.serve_numbers(rcfg, model, requests, served)
    return {**numbers, **{f"n_{k}": v for k, v in counted.items()}}


def train_control(run, fault: str) -> dict:
    from benchmark import spec
    from benchmark.traffic.train_chain import check, trajectory

    rcfg, batches, n, blocks = spec.traffic(run.work["traffic"]).reference_inputs(run)
    if fault == "half_batch":
        half = rcfg.train.batch_size // 2
        faulty = [type(b)(*(None if x is None else x[:half] for x in b))
                  for b in batches]
        control = trajectory(run, rcfg, faulty, n, blocks=max(1, blocks // 2))
    else:
        control = trajectory(run, rcfg, batches, n, tf32=fault == "tf32", blocks=blocks)
    compare.free_device()
    numbers, beside = check(run, rcfg, batches, control, blocks)
    return {**numbers, **beside}


@contextlib.contextmanager
def planted(fault: str):
    """Inside, the program's replayed train step carries ``fault``."""
    from maskrcnn_tpu_torch.train import step

    replay = step.GraphedStep.replay

    def half_batch(self, batch, draws):
        def twice(x):
            return None if x is None else torch.cat([x[:x.shape[0] // 2]] * 2)
        return replay(self, type(batch)(*map(twice, batch)),
                      type(draws)(*map(twice, draws)))

    def stale_input(self, batch, draws):
        for static, x in zip(self.draws, draws):
            static.copy_(x, non_blocking=True)
        self.graph.replay()

    step.GraphedStep.replay = {"replay_half_batch": half_batch,
                               "replay_stale_input": stale_input}[fault]
    try:
        yield
    finally:
        step.GraphedStep.replay = replay


@contextlib.contextmanager
def planted_dp(fault: str, rank: int, world: int):
    """Inside, this rank of a data-parallel step carries ``fault``."""
    from maskrcnn_tpu_torch.parallel import data_parallel as dp
    from maskrcnn_tpu_torch.train import losses

    if fault == "dp_skip_allreduce":
        module, name = dp, "all_reduce_sum_"
        reduce = dp.all_reduce_sum_

        def patched(tensors):
            tensors = list(tensors)
            # the last rank joins the collective and keeps what it had
            reduce([t.clone() for t in tensors] if rank == world - 1 else tensors)
    elif fault == "dp_local_counts":
        module, name = losses, "_count"
        count = losses._count

        def patched(n, global_count=False):
            return count(n, False)
    else:
        raise ValueError(f"no data-parallel fault {fault!r}")
    original = getattr(module, name)
    setattr(module, name, patched)
    try:
        yield
    finally:
        setattr(module, name, original)


def planted_run(run, fault: str) -> dict:
    """A run of the cell with ``fault`` planted → its compared numbers and
    whether it came out correct. A data-parallel fault is planted by the
    traffic in each rank's process (:func:`planted_dp`)."""
    from benchmark.run import execute

    if fault in PLANTED_DP:
        run.fault = fault
        line = execute(run)
    else:
        with planted(fault):
            line = execute(run)
    return {**{name: row["value"] for name, row in line["compared"].items()},
            "correct": line["correct"], "per_step": line["checked"]["per_step"]}


def passes(run, numbers: dict) -> bool:
    """Whether ``numbers`` pass the cell's limits of the numbers they hold:
    a reference in the program's place has one rank, and no ranks'
    digests to part."""
    limits = {k: v for k, v in run.work["limits"].items() if k in numbers}
    return compare.verdict(numbers, limits)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default="tf32", choices=FAULTS + PLANTED + PLANTED_DP)
    p.add_argument("--seconds", type=float, default=2.0,
                   help="a planted fault's window")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        run = Run(argparse.Namespace(workload=args.workload, seed=seed,
                                     seconds=args.seconds, trace=0))
        if args.fault in PLANTED + PLANTED_DP:
            numbers = planted_run(run, args.fault)
        else:
            control = (train_control if run.work["traffic"].startswith("train")
                       else serve_control)
            numbers = control(run, args.fault)
        ok = passes(run, numbers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "passes_limits": ok,
                          "numbers": numbers}), flush=True)


if __name__ == "__main__":
    main()
