"""The data-parallel pieces of the port on 2 gloo processes on the CPU,
against the JAX package's ``shard_map`` versions on 2 of conftest's 8 CPU
devices.

- The four losses with a global count (``global_count=True``; JAX's
  ``axis_name``): each rank's value equals the JAX shard's, on shards with
  uneven valid counts, and the ranks' values sum to the 1-process loss of
  the whole batch. Within 1e-6 relative (float32 sums of a few hundred
  terms in another order).
- The synced ``Norm`` (sync-BN): output, running statistics and the
  gradients of x, weight and bias, on 2 ranks against JAX's trainable
  ``Norm`` inside ``spmd_local_trace`` under ``shard_map`` (the rank's weight
  and bias gradients summed over the ranks, as the step does); and a
  count-weighted case, ranks of unequal H×W (and batch), against one
  1-process ``Norm`` over the concatenation of their positions. Within 1e-5
  of each quantity's largest magnitude (float32, statistics of 96–320
  positions summed in another order).
- The COCO index split of a real 2-process group: disjoint, covering the
  split, each rank's loader yielding its local batch, ``epoch_images``
  counting the whole split; ``split_by_rank=False`` reads every image.
- ``dryrun(2)``: one ``tiny_test`` step on two ranks, refusing to pass
  unless it saw both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu_torch import config as cfg_lib  # noqa: E402
from maskrcnn_tpu_torch.models.backbones.resnet import (  # noqa: E402
    Norm,
    batch_statistics_synced,
)
from maskrcnn_tpu_torch.parallel import data_parallel as dp  # noqa: E402
from maskrcnn_tpu_torch.train import losses as L  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL = 1e-6
NORM_TOL = 1e-5
N = 24  # rows a rank, losses
S, K, C = 6, 5, 3  # mask size, keypoints, classes


def _loss_inputs(seed: int = 0) -> dict:
    """Global rows of every loss's inputs; rank 0's half holds many more
    valid rows than rank 1's, so local and global counts differ."""
    rng = np.random.RandomState(seed)
    n = 2 * N
    labels = rng.randint(-1, C, n).astype(np.int32)
    labels[N:] = np.where(rng.rand(N) < 0.7, -1, labels[N:])
    is_pos = rng.rand(n) < np.r_[np.full(N, 0.6), np.full(N, 0.15)]
    kp = rng.randint(-1, S * S, (n, K)).astype(np.int32)
    return dict(
        pred_loc=rng.randn(n, 4).astype(np.float32),
        gt_loc=rng.randn(n, 4).astype(np.float32),
        labels=labels,
        logits=rng.randn(n, C).astype(np.float32),
        mask_logits=rng.randn(n, S, S).astype(np.float32),
        mask_stack=rng.randn(n, S, S, C).astype(np.float32),
        mask_targets=(rng.rand(n, S, S) < 0.5).astype(np.float32),
        mask_labels=rng.randint(0, C + 1, n).astype(np.int32),
        is_pos=is_pos,
        heat=rng.randn(n, S, S, K).astype(np.float32),
        kp_labels=kp,
    )


# (name, function of (lib, inputs as that lib's arrays, kwargs)) per loss
LOSS_CASES = {
    "fast_rcnn_loc_loss": lambda lib, x, **kw: lib.fast_rcnn_loc_loss(
        x["pred_loc"], x["gt_loc"], x["labels"], 3.0, **kw),
    "softmax_ce_ignore": lambda lib, x, **kw: lib.softmax_ce_ignore(
        x["logits"], x["labels"], **kw),
    "sigmoid_mask_loss": lambda lib, x, **kw: lib.sigmoid_mask_loss(
        x["mask_logits"], x["mask_targets"], x["mask_labels"], x["is_pos"], **kw),
    "sigmoid_mask_loss_stack": lambda lib, x, **kw: lib.sigmoid_mask_loss(
        x["mask_stack"], x["mask_targets"], x["mask_labels"], x["is_pos"], **kw),
    "keypoint_ce_loss": lambda lib, x, **kw: lib.keypoint_ce_loss(
        x["heat"], x["kp_labels"], x["is_pos"], **kw),
}


def _torch(x: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}


def _loss_rank(rank: int, world: int, inputs: dict) -> dict:
    local = _torch({k: v[rank * N:(rank + 1) * N] for k, v in inputs.items()})
    return {name: float(fn(L, local, global_count=True))
            for name, fn in LOSS_CASES.items()}


# The ranks import this module: JAX is imported by the functions that run
# in the test's own process only.

def _mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _jax_shard_losses(inputs: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from maskrcnn_tpu.train import losses as JL

    out = {}
    keys = sorted(inputs)
    for name, fn in LOSS_CASES.items():
        def body(*arrays, fn=fn):
            x = dict(zip(keys, arrays))
            return fn(JL, x, axis_name="data")[None]

        mapped = jax.shard_map(body, mesh=_mesh(), in_specs=(P("data"),) * len(keys),
                               out_specs=P("data"))
        out[name] = np.asarray(mapped(*(jnp.asarray(inputs[k]) for k in keys)))
    return out


@pytest.fixture(scope="module")
def losses(ranks):
    inputs = _loss_inputs()
    return inputs, [r["losses"] for r in ranks], _jax_shard_losses(inputs)


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_global_count_loss_matches_jax_shard_map(losses, name):
    inputs, ranks, shards = losses
    got = np.array([r[name] for r in ranks])
    np.testing.assert_allclose(got, shards[name], rtol=LOSS_RTOL)
    whole = float(LOSS_CASES[name](L, _torch(inputs)))
    np.testing.assert_allclose(got.sum(), whole, rtol=LOSS_RTOL)
    local = [float(LOSS_CASES[name](L, _torch(
        {k: v[r * N:(r + 1) * N] for k, v in inputs.items()}))) for r in range(2)]
    assert not np.allclose(got, local, rtol=1e-3)  # the counts did differ


def test_loss_without_global_count_is_the_local_one():
    x = _torch(_loss_inputs())
    for fn in LOSS_CASES.values():
        assert torch.equal(fn(L, x), fn(L, x, global_count=False))


# ---- sync-BN ---------------------------------------------------------------

CH = 4


def _norm_params(seed: int = 1):
    rng = np.random.RandomState(seed)
    return dict(weight=rng.uniform(0.5, 1.5, CH).astype(np.float32),
                bias=rng.randn(CH).astype(np.float32) * 0.1,
                mean=rng.randn(CH).astype(np.float32) * 0.1,
                var=rng.uniform(0.5, 1.5, CH).astype(np.float32))


def _port_norm(params: dict) -> Norm:
    norm = Norm(CH, frozen=False)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(params["weight"]))
        norm.bias.copy_(torch.from_numpy(params["bias"]))
        norm.running_mean.copy_(torch.from_numpy(params["mean"]))
        norm.running_var.copy_(torch.from_numpy(params["var"]))
    return norm


def _norm_step(norm: Norm, x: np.ndarray, g: np.ndarray) -> dict:
    """Forward in training mode, backward of Σ y·g → outputs and grads."""
    xt = torch.from_numpy(x).requires_grad_(True)
    y = norm(xt, train=True)
    (y * torch.from_numpy(g)).sum().backward()
    return dict(y=y.detach(), dx=xt.grad, dw=norm.weight.grad, db=norm.bias.grad,
                mean=norm.running_mean.clone(), var=norm.running_var.clone())


def _norm_rank(rank: int, world: int, params: dict, xs: list, gs: list) -> dict:
    norm = _port_norm(params)
    with batch_statistics_synced(norm):
        return _norm_step(norm, xs[rank], gs[rank])


def _norm_inputs(shapes, seed: int = 2):
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(*s) * 2 + 0.5).astype(np.float32) for s in shapes]
    gs = [rng.randn(*s).astype(np.float32) for s in shapes]
    return xs, gs


def _jax_synced_norm(params: dict, x: np.ndarray, g: np.ndarray) -> dict:
    """JAX's trainable Norm under shard_map over 2 devices (sync-BN through
    ``spmd_local_trace``), NHWC; gradients of Σ y·g over the whole batch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from maskrcnn_tpu.models.backbones.resnet import Norm as JaxNorm
    from maskrcnn_tpu.ops.roi_align import spmd_local_trace

    module = JaxNorm(frozen=False)
    stats = {"BatchNorm_0": {"mean": jnp.asarray(params["mean"]),
                             "var": jnp.asarray(params["var"])}}

    def body(x, w, b):
        with spmd_local_trace("data"):
            y, upd = module.apply(
                {"params": {"BatchNorm_0": {"scale": w, "bias": b}},
                 "batch_stats": stats}, x, True, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    mapped = jax.shard_map(body, mesh=_mesh(), in_specs=(P("data"), P(), P()),
                           out_specs=(P("data"), P()))

    def total(x, w, b):
        y, new = mapped(x, w, b)
        return (y * jnp.asarray(g)).sum(), (y, new)

    (_, (y, new)), (dx, dw, db) = jax.value_and_grad(
        total, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(params["weight"]), jnp.asarray(params["bias"]))
    new = new["BatchNorm_0"]
    return {k: np.asarray(v) for k, v in dict(
        y=y, dx=dx, dw=dw, db=db, mean=new["mean"], var=new["var"]).items()}


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= NORM_TOL * scale, (what, err, scale)


NORM_CASES = {"equal": ([(2, CH, 4, 6)] * 2, 2),
              "unequal": ([(2, CH, 6, 8), (1, CH, 4, 10)], 3)}


@pytest.fixture(scope="module")
def norm_runs(ranks):
    return _norm_params(), {
        name: (_norm_inputs(*case), [r["norm"][name] for r in ranks])
        for name, case in NORM_CASES.items()}


def test_synced_norm_matches_jax_shard_map(norm_runs):
    params, runs = norm_runs
    (xs, gs), ranks = runs["equal"]
    nhwc = [x.transpose(0, 2, 3, 1) for x in xs]
    want = _jax_synced_norm(params, np.concatenate(nhwc), np.concatenate(
        [g.transpose(0, 2, 3, 1) for g in gs]))
    for r, rank in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        _close(rank["y"].numpy().transpose(0, 2, 3, 1), want["y"][rows], "y")
        _close(rank["dx"].numpy().transpose(0, 2, 3, 1), want["dx"][rows], "dx")
        _close(rank["mean"], want["mean"], "running mean")
        _close(rank["var"], want["var"], "running var")
    _close(sum(r["dw"] for r in ranks), want["dw"], "d weight")
    _close(sum(r["db"] for r in ranks), want["db"], "d bias")


def _flat(x: np.ndarray) -> np.ndarray:
    """(N, C, H, W) → (C, N·H·W)."""
    return x.transpose(1, 0, 2, 3).reshape(x.shape[1], -1)


def test_synced_norm_weighs_unequal_ranks_by_their_counts(norm_runs):
    """Rank 0 holds 2×6×8 positions, rank 1 1×4×10: the synced statistics
    are those of all 136 positions, as one Norm over their concatenation
    computes them (a mean of the ranks' means would not be)."""
    params, runs = norm_runs
    (xs, gs), ranks = runs["unequal"]
    cat = lambda arrays: np.concatenate([_flat(a) for a in arrays], 1)[None, :, None]  # noqa: E731
    want = _norm_step(_port_norm(params), cat(xs), cat(gs))
    sizes = [_flat(x).shape[1] for x in xs]
    for part, rank, x in zip(np.split(np.arange(sum(sizes)), [sizes[0]]), ranks, xs):
        _close(_flat(rank["y"].numpy()), want["y"][0, :, 0, part], "y")
        _close(_flat(rank["dx"].numpy()), want["dx"][0, :, 0, part], "dx")
        _close(rank["mean"], want["mean"], "running mean")
        _close(rank["var"], want["var"], "running var")
    _close(sum(r["dw"] for r in ranks), want["dw"], "d weight")
    _close(sum(r["db"] for r in ranks), want["db"], "d bias")
    means = np.mean([_flat(x).mean(1) for x in xs], 0)
    assert not np.allclose(means, ranks[0]["mean"].numpy(), rtol=1e-3)


# ---- data and the dryrun -----------------------------------------------------

COCO_SIZES = [(96, 128), (128, 96), (100, 120), (120, 90), (90, 100)]


def _coco_rank(rank: int, world: int, root: str) -> dict:
    from maskrcnn_tpu_torch.data.coco import COCODetectionLoader

    cfg = cfg_lib._rep(cfg_lib.fpn_mask(), train=dict(
        batch_size=1, image_size=(128, 160)))
    loader = COCODetectionLoader(root, "val", cfg)
    whole = COCODetectionLoader(root, "val", cfg, split_by_rank=False)
    return {"ids": list(loader.ids), "epoch_images": loader.epoch_images,
            "all": list(whole.ids),
            "rows": next(iter(loader)).images.shape[0]}


def test_coco_index_split_is_disjoint_and_covers_the_split(ranks):
    r0, r1 = (r["coco"] for r in ranks)
    every = sorted(r0["all"])
    assert len(every) == len(COCO_SIZES) and r0["all"] == r1["all"]
    assert not set(r0["ids"]) & set(r1["ids"])
    assert sorted(r0["ids"] + r1["ids"]) == every
    assert r0["ids"] == every[0::2] and r1["ids"] == every[1::2]
    assert r0["epoch_images"] == r1["epoch_images"] == len(COCO_SIZES)
    assert r0["rows"] == r1["rows"] == 1


def test_shard_rows_takes_each_ranks_rows():
    from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData

    cfg = cfg_lib._rep(cfg_lib.tiny_test(), train=dict(batch_size=4))
    batch = SyntheticDetectionData(cfg).batch(3)
    parts = [dp.shard_rows(batch, r, 2) for r in range(2)]
    for name, x in batch._asdict().items():
        if x is None:
            assert all(getattr(p, name) is None for p in parts)
        else:
            assert np.array_equal(np.concatenate([getattr(p, name) for p in parts]), x)
    with pytest.raises(ValueError, match="not divisible by world size 3"):
        dp.shard_rows(batch, 0, 3)
    stream = dp.shard_stream(SyntheticDetectionData(cfg).iter_from(3), 1, 2)
    assert np.array_equal(next(stream).images, parts[1].images)


def test_dryrun_two_ranks(capsys):
    out = dp.dryrun(2)
    assert out["world"] == 2 and np.isfinite(out["loss"])
    assert "dryrun(2): OK" in capsys.readouterr().out


def test_all_reduce_sum_backward_sums_the_ranks_cotangents(ranks):
    """d/dx_r of Σ_k L_k(Σ_r x_r) = Σ_k dL_k/dS: each rank's gradient holds
    every rank's term (a plain in-place all-reduce would give rank r's own)."""
    s = sum(torch.arange(3.0) + r for r in range(2))
    want = sum(2 * (r + 1) * s for r in range(2))  # d/dS of Σ_r (r+1)·|S|²
    for r in ranks:
        assert torch.allclose(r["sum_grad"], want)


def _sum_rank(rank: int, world: int):
    x = (torch.arange(3.0) + rank).requires_grad_(True)
    total = dp.all_reduce_sum(x)
    ((rank + 1) * (total * total).sum()).backward()
    return x.grad



def _rank(rank: int, world: int, coco_root: str) -> dict:
    """Everything the tests above read from the ranks, in one group."""
    params = _norm_params()
    norm = {}
    for name, case in NORM_CASES.items():
        norm[name] = _norm_rank(rank, world, params, *_norm_inputs(*case))
    return {"losses": _loss_rank(rank, world, _loss_inputs()), "norm": norm,
            "coco": _coco_rank(rank, world, coco_root),
            "sum_grad": _sum_rank(rank, world)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from maskrcnn_tpu_torch.data.coco_synthetic import write_coco

    root = tmp_path_factory.mktemp("ranks")
    write_coco(str(root / "coco"), "val", COCO_SIZES, seed=1)
    return dp.spawn_ranks(_rank, 2, str(root / "coco"), workdir=str(root))
