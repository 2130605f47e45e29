"""Data parallelism over ``torch.distributed``: one process per GPU
(counterpart of ``maskrcnn_tpu/parallel/mesh.py``).

Every rank holds the whole model and takes the port's own train step on its
rows of the global batch, so the ROIAlign and region-scatter kernels run in
each rank on its local pyramid (batch indices 0..b_local−1). What makes the
ranks one step of the global batch, as JAX's ``shard_map`` step does:

- the four losses divide by valid counts summed over the ranks
  (``train/losses.py``, ``global_count=True``), so each rank's loss and
  gradient are its local numerator over the global denominator, and the
  gradients are then all-reduced as a **sum** (:func:`all_reduce_sum_`), as
  are the loss terms and ROI counts the step reports;
- each rank draws the global sampler table and takes its rows
  (``train/step.py``);
- a trainable ``Norm`` reduces its batch sums ``(Σx, Σx², n)`` over the
  ranks through :func:`all_reduce_sum`, whose backward all-reduces too, and
  the running statistics are averaged after the step
  (:func:`average_running_statistics`);
- rank 0's parameters and buffers start every rank (:func:`replicate`).

Processes come from ``torchrun`` (:func:`init_from_env`: NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU) or, for tests and the gloo dryrun, from
:func:`spawn_ranks` (a ``FileStore`` in a temporary directory, no TCP port).
Without a process group nothing here is called and the step is the
single-process one.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def rank_world() -> tuple[int, int]:
    """(rank, world size) of the default process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_ENV)


def init_from_env(device: torch.device) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) → this rank's device: ``cuda:LOCAL_RANK`` over NCCL
    when ``device`` is a GPU, the CPU over gloo otherwise."""
    rank, world, local = (int(os.environ[k]) for k in TORCHRUN_ENV)
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, rank=rank, world_size=world)
    return device


def _coalesced(tensors, collective):
    """Run ``collective`` on one flat buffer per dtype holding ``tensors``,
    then copy the result back into each tensor."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view(t.shape))


@torch.no_grad()
def all_reduce_sum_(tensors) -> None:
    """Sum each tensor over the ranks, in place (one all-reduce per dtype)."""
    _coalesced(list(tensors), dist.all_reduce)


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers into every rank's
    ``module``, in place → ``module``."""
    _coalesced(list(module.state_dict().values()),
               lambda flat: dist.broadcast(flat, src=0))
    return module


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x; the backward sums the cotangents over the ranks too,
    which is the gradient of the sum of every rank's loss. (An in-place
    ``dist.all_reduce`` on a tensor in the graph gives the same forward and
    drops the other ranks' terms of the gradient.)"""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks."""
    return _AllReduceSum.apply(x)


@torch.no_grad()
def average_running_statistics(model: torch.nn.Module) -> None:
    """Average the running statistics of every trainable ``Norm`` over the
    ranks, in place (JAX ``pmean`` of ``batch_stats`` after the step)."""
    from maskrcnn_tpu_torch.models.backbones.resnet import Norm

    stats = [t for m in model.modules() if isinstance(m, Norm) and not m.frozen
             for t in (m.running_mean, m.running_var)]
    if stats:
        all_reduce_sum_(stats)
        torch._foreach_div_(stats, float(dist.get_world_size()))


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (picklable objects)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shard_rows(batch, rank: int, world: int):
    """Rows ``[rank·b, (rank+1)·b)`` of every field of a global batch of
    ``world·b`` rows (absent fields stay None)."""
    n = batch.images.shape[0]
    if n % world:
        raise ValueError(f"global batch {n} not divisible by world size {world}")
    b = n // world
    return type(batch)(*(None if x is None else x[rank * b:(rank + 1) * b]
                         for x in batch))


def shard_stream(stream, rank: int, world: int):
    """This rank's rows of each global batch of ``stream``: every rank
    builds the same seeded stream and slices it."""
    for batch in stream:
        yield shard_rows(batch, rank, world)


def parameter_digest(module: torch.nn.Module) -> str:
    """SHA-256 of every parameter's bytes, in order: equal on two ranks
    only when their parameters are equal in bits."""
    h = hashlib.sha256()
    for p in module.parameters():
        h.update(p.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _rank_main(rank: int, fn, world: int, workdir: str, args: tuple):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, workdir: str | None = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined by
    one gloo group (a ``FileStore`` under ``workdir``, a new temporary
    directory by default) → the ranks' return values, by rank. ``fn`` must
    be importable (a module-level function) and return what ``torch.save``
    takes; tensors on the card are read back on the card. A rank that
    raises fails the call with its traceback."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="dp_ranks_", dir=workdir) as tmp:
        mp.start_processes(_rank_main, args=(fn, world, tmp, args),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _dryrun_rank(rank: int, world: int) -> dict:
    from maskrcnn_tpu_torch import config as cfg_lib
    from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.state import create_train_state
    from maskrcnn_tpu_torch.train.step import make_train_step

    cfg = cfg_lib._rep(cfg_lib.tiny_test(), train=dict(
        batch_size=world, image_size=(128, 160)))
    model = replicate(MaskRCNN(cfg, device="cpu", seed=rank))
    state = create_train_state(cfg, model, seed=1)
    batch = shard_rows(SyntheticDetectionData(cfg).batch(0), rank, world)
    metrics = make_train_step(cfg)(state, batch)
    r, w = rank_world()
    return {"rank": r, "world": w, "loss": float(metrics["loss"]),
            "digest": parameter_digest(model)}


def dryrun(n: int) -> dict:
    """One ``tiny_test`` step (128×160, global batch ``n``, one image a
    rank) on ``n`` gloo processes on the CPU (the port's analogue of
    ``__graft_entry__.dryrun_multichip``). Raises unless it saw ``n``
    distinct ranks of an ``n``-rank group, a finite loss, and parameters
    equal in bits on every rank → rank 0's result."""
    results = spawn_ranks(_dryrun_rank, n)
    ranks = sorted(r["rank"] for r in results)
    if ranks != list(range(n)) or {r["world"] for r in results} != {n}:
        raise RuntimeError(f"dryrun({n}) saw ranks {ranks} of world sizes "
                           f"{sorted({r['world'] for r in results})}")
    losses = {r["loss"] for r in results}
    if len(losses) != 1 or not all(torch.isfinite(torch.tensor(list(losses)))):
        raise RuntimeError(f"dryrun({n}): losses {sorted(losses)}")
    if len({r["digest"] for r in results}) != 1:
        raise RuntimeError(f"dryrun({n}): the ranks' parameters differ")
    print(f"dryrun({n}): OK, loss={results[0]['loss']:.4f}, {n} ranks, "
          "parameters equal in bits")
    return results[0]
