"""Training by chained dispatch: each call of ``make_train_step(cfg,
chain=K)`` runs K optimizer steps (on the card, after the first call's
eager step and capture, K replays of the step's CUDA graph), on batches
staged from host arrays as the train CLI stages them.

Parameters (the workload file's ``params``): ``chain``, the K of the call;
``batches``, how many distinct seed-made batches are cycled (call ``c``
takes batches ``c·K .. c·K+K−1`` modulo it); ``steps_compared``, the first
steps of the first call that the reference follows; ``trace_chains`` and
``eager_steps``, the traced stretches of a ``--trace 1`` run (whole calls,
and single uncaptured steps of ``make_train_step(cfg)`` on the same state).

Set-up builds the state from the seed's weights, makes the first call
(the window's own call on its own feed), and keeps what the comparison
needs from it: each step's loss, and the parameters and momentum buffers
after each of the first ``steps_compared`` steps, the eager first step and
the replays after it (:func:`observe_steps`). The window opens after a
sync, makes calls one after another, each fetched by its last loss while
the next one runs, and closes with the fetch of the last call's last loss:
only whole calls count.

The comparison (:func:`check`): the reference takes step 1 from the seed,
and each later step from the program's own state before it, on the same
batch and sampler draws. Followed on its own from step 2 on, it parts
from sound runs: rounding moves a sampled ROI, and the step's loss with
it. So each run also reports how far the reference's own step 2 lies from
the program's, and what it picked differently (:func:`compare.parting`).
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import compare
from benchmark.data import Synthetic, stack
from benchmark.readings import Readings, device_peaks, math_mode
from benchmark.trace import breakdown, record
from benchmark.weights import load_into, make_weights


def feeds(run, params):
    """The calls' stacked host batches, one for each call in a period of
    the cycle, and the batches themselves."""
    k, n = params["chain"], params["batches"]
    data = Synthetic(run.reference_config(), run.seed)
    batches = [data.batch(i) for i in range(n)]
    period = math.lcm(k, n) // k
    return [stack([batches[(c * k + j) % n] for j in range(k)])
            for c in range(period)], batches


def reference_inputs(run):
    """What the reference's steps take: (its configuration, the batches,
    the first steps of the first call that it follows, the blocks of rows
    it takes a batch's loss in)."""
    params = run.work["params"]
    _, batches = feeds(run, params)
    return (run.reference_config(), batches,
            min(params["steps_compared"], params["chain"]), 1)


def generator_seed(seed: int) -> int:
    return seed % (2**63 - 1) + 1


def observe_steps(state, n: int) -> tuple[list, callable]:
    """Record the program's parameters and momentum buffers (name → host
    tensor) after each of its next ``n`` steps, eager or replayed: an
    optimizer post-step hook sees the eager ones (not while a graph is
    captured, when nothing runs), a wrapper of ``torch.cuda.CUDAGraph.replay``
    the replayed ones. → (the list that fills, a function that takes both
    away; they also go once ``n`` steps are recorded)."""
    model, opt = state.model, state.optimizer
    named = list(model.named_parameters())
    graph = torch.cuda.CUDAGraph
    replay = graph.replay
    seen = []

    def stop():
        hook.remove()
        graph.replay = replay

    def record():
        seen.append({
            "params": {n: p.detach().to("cpu", copy=True) for n, p in named},
            "momentum": {n: opt.state[p]["momentum_buffer"].detach().to(
                "cpu", copy=True) for n, p in named if p in opt.state}})
        if len(seen) == n:
            stop()

    def after_step(optimizer, args, kwargs):
        if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
            record()

    def replayed(self, *args, **kwargs):
        out = replay(self, *args, **kwargs)
        record()
        return out

    hook = opt.register_step_post_hook(after_step)
    graph.replay = replayed
    return seen, stop


def run(run) -> dict:
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.state import create_train_state
    from maskrcnn_tpu_torch.train.step import make_train_step

    params = run.work["params"]
    k = params["chain"]
    pcfg, rcfg = run.program_config(), run.reference_config()
    dev = torch.device(run.device)
    stacks, batches = feeds(run, params)
    b = pcfg.train.batch_size
    run.mark("batches")
    model = MaskRCNN(pcfg, device=dev)
    run.mark("model")
    load_into(model, make_weights(rcfg, run.seed, dev))
    run.mark("weights")
    state = create_train_state(pcfg, model, seed=generator_seed(run.seed))
    chained = make_train_step(pcfg, chain=k)

    states, stop = observe_steps(state, min(params["steps_compared"], k))
    try:
        first = chained(state, stacks[0])
    finally:
        stop()
    losses = first["loss"].cpu().tolist()
    run.mark("first call")
    program = {"losses": losses[:len(states)], "states": states}

    t_open = run.open_window()
    done, failed, pending = 0, 0, None
    c = 1
    while True:
        metrics = chained(state, stacks[c % len(stacks)])
        c += 1
        if pending is not None:
            done += 1
            failed += not math.isfinite(pending["loss"][-1].item())
        pending = metrics
        if time.perf_counter() - t_open >= run.seconds:
            break
    done += 1
    failed += not math.isfinite(pending["loss"][-1].item())
    window_s = time.perf_counter() - t_open
    run.window_closed()

    readings = result_breakdown = None
    if run.trace:
        def graphed():
            for j in range(params["trace_chains"]):
                chained(state, stacks[j % len(stacks)])["loss"][-1].item()

        step = make_train_step(pcfg)

        def eager():
            for j in range(params["eager_steps"]):
                step(state, batches[(j + 1) % len(batches)])["loss"].item()

        graphed_trace = record(graphed, params["trace_chains"] * k)
        eager_trace = record(eager, params["eager_steps"])
        readings = Readings(
            run.name, run.config, params, device_peaks(), math_mode(run.config), window_s,
            done * k, run.config["model_flops"]["train_step"],
            run.reserved_peak, graphed_trace, eager_trace)
        result_breakdown = breakdown(graphed_trace)

    del chained, state, model, first
    compare.free_device()
    t_check = time.perf_counter()
    numbers, beside = check(run, rcfg, batches, program)
    ok, rows, _ = compare.verdict(numbers, run.work["limits"])
    counted = {"steps": len(states), **beside,
               "seconds": time.perf_counter() - t_check}
    return {"correct": ok and failed == 0, "attempted": c - 1,
            "failed": failed, "compared": rows, "readings": readings,
            "breakdown": result_breakdown, "checked": counted,
            "end_to_end": {"train_images_per_s": done * k * b / window_s}}


def seed_state(rcfg, seed: int, dev) -> dict:
    """The state before step 1: the seed's weights on ``dev``, no
    momentum."""
    return {"params": make_weights(rcfg, seed, dev), "momentum": {}}


def steps_of(states: list, losses: list, rcfg) -> dict:
    """A side's steps from its states (the seed's first, then one after
    each step) and losses → each step's loss, gradient as the optimizer got
    it (``m_i − momentum·m_{i−1} − wd·p_{i−1}``, in float64; a leaf the
    step left without a buffer has none) and change of the parameters, on
    the states' device."""
    t = rcfg.train
    decay = float(torch.tensor(t.momentum, dtype=torch.float32))
    grads, changes = [], []
    for before, after in zip(states, states[1:]):
        p0, m0 = before["params"], before["momentum"]
        grads.append({n: m.double() - t.weight_decay * p0[n].double()
                      - (decay * m0[n].double() if n in m0 else 0.0)
                      for n, m in after["momentum"].items()})
        changes.append({n: p - p0[n] for n, p in after["params"].items()})
    return {"losses": list(losses), "grads": grads, "changes": changes}


def reference_step(run, rcfg, model, batch, before: dict, i: int, blocks: int = 1):
    """The reference's step ``i + 1`` on ``batch`` (host arrays) from the
    state ``before``, its loss taken in ``blocks`` blocks of rows → (loss,
    gradient, change, state after, Chosen), on the model's device."""
    from benchmark.reference.train import Trainer

    dev = model.device
    batch = _on_device(batch, dev)
    trainer = Trainer(rcfg, model, generator_seed(run.seed))
    trainer.resume(before["params"], before["momentum"], i,
                   *batch.gt_boxes.shape[:2])
    loss = trainer.step(batch, blocks)
    named = list(model.named_parameters())
    grad = {n: p.grad.detach().clone() for n, p in named if p.grad is not None}
    after = {"params": {n: p.detach().clone() for n, p in named},
             "momentum": {n: m.clone() for (n, _), m in zip(named, trainer.momentum)}}
    change = {n: p - before["params"][n] for n, p in after["params"].items()}
    return loss, grad, change, after, trainer.chosen


def trajectory(run, rcfg, batches, n: int, tf32: bool = False, blocks: int = 1) -> dict:
    """The reference on its own through ``n`` steps from the seed, as a
    run records the program's first steps: {losses, states after each}."""
    from benchmark.reference.maskrcnn import MaskRCNN

    dev = torch.device(run.device)
    model = MaskRCNN(rcfg, device=dev)
    state, losses, states = seed_state(rcfg, run.seed, dev), [], []
    with compare.tf32(tf32):
        for i in range(n):
            loss, _, _, state, _ = reference_step(
                run, rcfg, model, batches[i % len(batches)], state, i, blocks)
            losses.append(loss)
            states.append(state)
    return {"losses": losses, "states": states}


def check(run, rcfg, batches, program: dict, blocks: int = 1) -> tuple[dict, dict]:
    """``program``'s steps ({losses, states after each}, the program's or
    a control's) against the reference's, step 1 from the seed and each
    later one from ``program``'s own state before it, each batch's loss
    taken in ``blocks`` blocks of rows → (numbers, what is reported beside
    them)."""
    from benchmark.reference.maskrcnn import MaskRCNN

    dev = torch.device(run.device)
    states = [{part: {n: t.to(dev) for n, t in leaves.items()}
               for part, leaves in state.items()}
              for state in [seed_state(rcfg, run.seed, dev)] + program["states"]]
    mine = steps_of(states, program["losses"], rcfg)
    model = MaskRCNN(rcfg, device=dev)
    reference = {"losses": [], "grads": [], "changes": []}
    for i, before in enumerate(states[:-1]):
        loss, grad, change, after, chosen = reference_step(
            run, rcfg, model, batches[i % len(batches)], before, i, blocks)
        reference["losses"].append(loss)
        reference["grads"].append(grad)
        reference["changes"].append(change)
        if i == 0:
            own = after
        elif i == 1:
            forced = chosen
    numbers, beside = compare.train_numbers(mine, reference)
    if len(states) > 2:
        loss, grad, _, _, chosen = reference_step(run, rcfg, model, batches[1 % len(batches)],
                                                  own, 1, blocks)
        beside["free_step_2"] = compare.parting(
            mine["losses"][1], mine["grads"][1], loss, grad, forced, chosen)
    return numbers, beside


def _on_device(batch, dev):
    return type(batch)(*(None if x is None else torch.as_tensor(x, device=dev)
                         for x in batch))
