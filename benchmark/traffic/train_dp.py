"""Data-parallel training: one process a card, joined by one process group,
each taking ``make_train_step(cfg)`` (K=1, eager) on its rows of every
global batch, as ``cli/train.py --data-parallel`` does.

Parameters (the workload file's ``params``): ``ranks``, the processes and
cards; ``global_batch``, the configuration's ``train.batch_size`` under
data parallelism (each rank takes ``global_batch / ranks`` rows);
``batches``, how many distinct seed-made global batches are cycled;
``warmup_steps``, the steps before the window (the first is compared with
the reference, the others timed to fix the window's step count);
``eager_steps``, the traced stretch of a ``--trace 1`` run.

Rank 0 is this process; ranks 1.. are spawned. Each sets its card, joins
the group (NCCL on cards, gloo on the CPU) through a ``FileStore`` in a new
directory under ``TMPDIR``, so no TCP port can collide, makes every global
batch from the seed, takes its ``shard_rows`` of each and stages them on its
card, builds the model from the seed's weights and broadcasts rank 0's
(``replicate``). Rank 0 records its parameters and momentum after step 1.
After the warm-up rank 0 fixes the window's step count from the timed
steps, so that the window lasts at least ``--seconds``, and every rank runs
that many steps. The window opens on rank 0 after a sync on every rank and
a barrier, and closes at rank 0's fetch of the last step's loss; each rank
copies each step's loss to the host as the step ends and waits for it one
step behind, while the next step runs. Nothing in the window is a
collective but the program's own. After it each rank reads its peak of
reserved memory, the SHA-256 of its parameters' bytes, and the forbidden
modules it has loaded, and sends them to rank 0.

The comparison, once every rank has freed its program: rank 0's first step
against the reference's one step over the whole global batch on card 0
(``loss_gap``, ``grad_gap``, ``update_gap``, as
:func:`benchmark.compare.train_numbers` takes them), and
``rank_digest_apart``, the ranks whose parameters differ in any bit from
rank 0's at the window's close. The reference takes the global batch's
loss in blocks of the ranks' rows, each term over the count summed over
the blocks, and one backward (``reference/train.py:global_losses``): the
same loss and gradient as at once, with each block's convolutions at the
ranks' batch. Taken at once, cuDNN rounds the features otherwise, and a
proposal's rank can swap with a near-equal one's and move the sampled
ROIs; that reading is reported beside (``whole_batch``).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from benchmark import compare, spec
from benchmark.data import Synthetic
from benchmark.readings import Readings, device_peaks, math_mode
from benchmark.trace import breakdown, record
from benchmark.traffic.train_chain import _on_device, check, generator_seed, observe_steps
from benchmark.weights import load_into, make_weights

# a collective that waits longer than this fails the run
TIMEOUT_S = 300
# the window's step count: the warm-up's pace over this many seconds a second
MARGIN = 1.05


def global_config(run) -> dict:
    return {"train": {"batch_size": run.work["params"]["global_batch"]}}


def global_batches(run) -> list:
    """The seed's global batches (host arrays), alike on every rank."""
    data = Synthetic(run.reference_config(global_config(run)), run.seed)
    return [data.batch(i) for i in range(run.work["params"]["batches"])]


def reference_inputs(run):
    """What the reference's step takes: (its configuration at the global
    batch, the global batches, the steps it follows: the first, the blocks
    of rows it takes the loss in: one a rank)."""
    return (run.reference_config(global_config(run)), global_batches(run), 1,
            run.work["params"]["ranks"])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _barrier(dev):
    dist.barrier(device_ids=[dev.index]) if dev.type == "cuda" else dist.barrier()


def _digest(model) -> str:
    """SHA-256 of every parameter's bytes, in order."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _train(run, rank: int, world: int, dev) -> dict | None:
    """One rank's part of the run (the module's docstring) → rank 0's
    record, None on the other ranks."""
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
    from maskrcnn_tpu_torch.parallel import data_parallel as dp
    from maskrcnn_tpu_torch.train.state import create_train_state
    from maskrcnn_tpu_torch.train.step import make_train_step

    from benchmark.run import forbidden_modules

    params = run.work["params"]
    lead = rank == 0
    pcfg = run.program_config(global_config(run))
    rcfg = run.reference_config(global_config(run))
    batches = global_batches(run)
    shards = [_on_device(dp.shard_rows(b, rank, world), dev) for b in batches]
    run.mark("batches")
    model = MaskRCNN(pcfg, device=dev)
    run.mark("model")
    load_into(model, make_weights(rcfg, run.seed, dev))
    dp.replicate(model)
    run.mark("weights")
    state = create_train_state(pcfg, model, seed=generator_seed(run.seed))
    step = make_train_step(pcfg)
    n = len(shards)

    seen, stop = observe_steps(state, 1) if lead else ([], lambda: None)
    try:
        first = step(state, shards[0])
    finally:
        stop()
    first_loss = first["loss"].item()
    run.mark("first step")
    warmup = params["warmup_steps"]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(1, warmup):
        metrics = step(state, shards[i % n])
    metrics["loss"].item()
    pace = (time.perf_counter() - t0) / (warmup - 1)
    box = [max(1, math.ceil(MARGIN * run.seconds / pace))]
    dist.broadcast_object_list(box, src=0)
    steps = box[0]
    run.mark("warm-up")

    cuda = dev.type == "cuda"
    losses = torch.empty(steps, pin_memory=cuda)
    copied = []  # on the card: the end of each step's loss copy
    _sync(dev)
    _barrier(dev)
    t_open = run.open_window()
    for i in range(steps):
        metrics = step(state, shards[(warmup + i) % n])
        losses[i].copy_(metrics["loss"], non_blocking=True)
        if cuda:
            copied.append(torch.cuda.Event())
            copied[-1].record()
            if i:
                copied[-2].synchronize()
    if cuda:
        copied[-1].synchronize()
    window_s = time.perf_counter() - t_open
    failed = int((~torch.isfinite(losses)).sum())
    reserved = torch.cuda.max_memory_reserved(dev) if cuda else 0
    digest = _digest(model)

    trace = None
    if run.trace:
        def eager():
            for j in range(params["eager_steps"]):
                step(state, shards[j % n])["loss"].item()

        trace = record(eager, params["eager_steps"])
    mine = {"rank": rank, "digest": digest, "reserved": reserved,
            "forbidden": forbidden_modules(), "failed": failed,
            "busy_s": trace.busy_s() if trace else None}
    everyone = [None] * world if lead else None
    dist.gather_object(mine, everyone, dst=0)
    if not lead:
        return None
    return {"ranks": everyone, "window_s": window_s, "steps": steps,
            "pace_ms": 1e3 * pace, "first_loss": first_loss, "states": seen,
            "trace": trace, "batches": batches,
            "local_batch": batches[0].images.shape[0] // world}


def _rank(run, rank: int, world: int, store: str) -> dict | None:
    """Join the group as ``rank`` on its card (or the CPU), run
    :func:`_train` with the run's planted fault if any, leave the group."""
    cuda = run.device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if cuda:
        torch.cuda.set_device(dev)
        tf32 = bool(run.config.get("tf32", False))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}/store", rank=rank,
                            world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    run.mark("group")
    try:
        if run.fault is None:
            fault = contextlib.nullcontext()
        else:
            from benchmark.control import planted_dp
            fault = planted_dp(run.fault, rank, world)
        with fault:
            return _train(run, rank, world, dev)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def _job(run) -> dict:
    """What a spawned rank needs to rebuild the run."""
    return {"workload": run.name, "seed": run.seed, "seconds": run.seconds,
            "trace": int(run.trace), "device": run.device,
            "overrides": run.overrides, "work": run.work, "fault": run.fault}


def _spawn(run, world: int, store: str) -> list:
    """Ranks 1.. as processes of this interpreter, from the checkout's
    root; what they print goes to this process's standard error."""
    path = os.path.join(store, "job.json")
    with open(path, "w") as f:
        json.dump(_job(run), f)
    return [subprocess.Popen([sys.executable, "-m", "benchmark.traffic.train_dp",
                              path, str(r), str(world), store],
                             cwd=spec.ROOT, stdout=sys.stderr)
            for r in range(1, world)]


def _rank_main(path: str, rank: int, world: int, store: str):
    from benchmark.run import Run

    with open(path) as f:
        job = json.load(f)
    run = Run(argparse.Namespace(workload=job["workload"], seed=job["seed"],
                                 seconds=job["seconds"], trace=job["trace"]),
              device=job["device"], overrides=job["overrides"])
    run.work, run.fault = job["work"], job["fault"]
    _rank(run, rank, world, store)


def run(run) -> dict:
    params = run.work["params"]
    world = params["ranks"]
    if run.device == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"benchmark: {run.name} needs {world} CUDA devices")
    store = tempfile.mkdtemp(prefix="bench_dp_")
    procs, done = [], False
    try:
        procs = _spawn(run, world, store)
        out = _rank(run, 0, world, store)
        done = True
    finally:
        for p in procs:
            try:
                p.wait(timeout=60 if done else 5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(store, ignore_errors=True)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"ranks' exit codes {[p.returncode for p in procs]}")

    ranks = out["ranks"]
    run.reserved_peak = max(r["reserved"] for r in ranks)
    run.forbidden_elsewhere = set().union(*(r["forbidden"] for r in ranks))
    steps, window_s, b = out["steps"], out["window_s"], out["local_batch"]
    readings = result_breakdown = busy_s = None
    if run.trace:
        config = {**run.config, "train": {**run.config["train"], "batch_size": b}}
        # one rank's share of the work: the count is linear in the batch
        flops = (run.config["model_flops"]["train_step"] * b
                 // run.config["train"]["batch_size"])
        readings = Readings(
            run.name, config, params, device_peaks(), math_mode(run.config),
            window_s, steps, flops, run.reserved_peak, out["trace"], out["trace"])
        result_breakdown = breakdown(out["trace"])
        busy_s = sum(r["busy_s"] for r in ranks) / len(ranks)

    batches, pace_ms = out["batches"], out["pace_ms"]
    program = {"losses": [out["first_loss"]], "states": out["states"]}
    del out
    compare.free_device()
    t_check = time.perf_counter()
    rcfg = run.reference_config(global_config(run))
    numbers, beside = check(run, rcfg, batches, program, blocks=world)
    numbers["rank_digest_apart"] = sum(r["digest"] != ranks[0]["digest"] for r in ranks)
    # beside: the reference's step over the whole batch at once, whose
    # convolutions run at another batch than the ranks' and round apart
    beside["whole_batch"] = check(run, rcfg, batches, program)[0]
    ok, rows, _ = compare.verdict(numbers, run.work["limits"])
    failed = ranks[0]["failed"]
    counted = {"steps": len(program["states"]), **beside, "ranks": world,
               "window_steps": steps, "warmup_pace_ms": pace_ms,
               "seconds": time.perf_counter() - t_check}
    return {"correct": ok and failed == 0, "attempted": steps, "failed": failed,
            "compared": rows, "readings": readings, "breakdown": result_breakdown,
            "busy_s": busy_s, "checked": counted,
            "end_to_end": {"train_images_per_s": b * world * steps / window_s}}


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
