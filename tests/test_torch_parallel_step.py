"""The data-parallel train step: 2 gloo processes on the CPU against the
port's 1-process step on the same global batch.

``tiny_test`` at its own 128×160: global batch 2, one image a rank, and
global batch 4 with ``grad_accum_steps=2`` (two images a rank, micro-batches
of one). Each rank splits its own rows into micro-batches, as JAX's
``shard_map`` step does, so with accumulation the 1-process step that the
ranks equal takes the global batch with its rows interleaved, micro-batch m
holding every rank's m-th micro-batch (rows 0, 2, 1, 3), and those rows of
the global sampler tables. Rank 0 alone holds the weights before the step (the other rank
starts from another seed) and :func:`replicate` broadcasts them. Both runs
draw the samplers' tables from the same generator seed: each rank draws the
global table and takes its rows, so the draws each rank's samplers see are
its rows of the 1-process run's, exactly. The RPN's shared conv is zeroed
(``tests/test_torch_trainable_bn.py``'s recipe): every anchor scores the
same, so both runs propose and sample the same ROIs whatever the last bits
of a batch-1 and a batch-2 convolution. Darknet's five BatchNorms always
train, so the step runs sync-BN forward and backward.

Tolerances, from the dtype (float32) and the distances measured here: the
ROI counts equal; each loss term within 1e-5 relative (measured 7.2e-8:
the global counts are exact, the ranks' numerators add in another order);
each tensor's update within 5e-4 of the step's largest update plus two
float32 roundings of the tensor's largest weight (measured 1.2e-4, on
Darknet's conv biases, whose true gradient is zero and whose update is
rounding alone: sync-BN sums two ranks' float32 partial sums where the
1-process step takes one mean); the running statistics within 1e-5 of
max(1, each tensor's largest value) (measured 2.3e-7). After the step the
two ranks' parameters are equal in bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu_torch import config as cfg_lib  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.parallel import data_parallel as dp  # noqa: E402
from maskrcnn_tpu_torch.train import step as step_mod  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
UPDATE_SHARE = 5e-4
ULPS = 2
STATS_RTOL = 1e-5
LOSSES = ("loss", "rpn_loc_loss", "rpn_cls_loss", "roi_loc_loss",
          "roi_cls_loss", "mask_loss")


def _cfg(batch: int, accum: int = 1):
    return cfg_lib._rep(cfg_lib.tiny_test(), train=dict(
        batch_size=batch, grad_accum_steps=accum, image_size=(128, 160)))


def _weights(cfg) -> dict:
    model = MaskRCNN(cfg, device="cpu", seed=0)
    with torch.no_grad():
        model.rpn_head.conv.weight.zero_()
        model.rpn_head.conv.bias.zero_()
    return {k: v.clone() for k, v in model.state_dict().items()}


class DrawSpy:
    """Records the priorities each call of the anchor and proposal samplers
    gets (the step's draws, micro-batch by micro-batch)."""

    def __init__(self):
        self.anchor, self.proposal = [], []
        self.real = step_mod.anchor_targets, step_mod.proposal_targets

    def __enter__(self):
        anchor, proposal = self.real

        def spy_anchor(pos, neg, *args, **kwargs):
            self.anchor.append(torch.stack([pos, neg], 1).clone())
            return anchor(pos, neg, *args, **kwargs)

        def spy_proposal(pos, neg, *args, **kwargs):
            self.proposal.append(torch.stack([pos, neg], 1).clone())
            return proposal(pos, neg, *args, **kwargs)

        step_mod.anchor_targets, step_mod.proposal_targets = spy_anchor, spy_proposal
        return self

    def __exit__(self, *exc):
        step_mod.anchor_targets, step_mod.proposal_targets = self.real

    def draws(self) -> dict:
        return {"anchor": torch.cat(self.anchor), "proposal": torch.cat(self.proposal)}


def _take_step(cfg, model, batch, draws=None) -> dict:
    state = create_train_state(cfg, model, seed=1)
    with DrawSpy() as spy:
        metrics = step_mod.make_train_step(cfg)(state, batch, draws)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "draws": spy.draws(), "digest": dp.parameter_digest(model),
            "step": state.step}


def _rank(rank: int, world: int, cfg, weights: dict, batch) -> dict:
    model = MaskRCNN(cfg, device="cpu", seed=rank + 7)
    if rank == 0:
        model.load_state_dict(weights)
    dp.replicate(model)
    out = _take_step(cfg, model, dp.shard_rows(batch, rank, world))
    out["rank_world"] = dp.rank_world()
    return out


def _model(cfg, weights):
    model = MaskRCNN(cfg, device="cpu", seed=0)
    model.load_state_dict(weights)
    return model


def interleaved(batch: int, world: int, accum: int) -> list[int]:
    """Global rows in the order whose micro-batch m holds every rank's m-th
    micro-batch."""
    local, micro = batch // world, batch // world // accum
    return [r * local + m * micro + j for m in range(accum)
            for r in range(world) for j in range(micro)]


def _run(tmp_path_factory, batch: int, accum: int):
    """(config, weights, the 1-process step in the global batch's order —
    its draws are the global tables —, the 1-process step the ranks should
    equal, the two ranks' steps)."""
    cfg = _cfg(batch, accum)
    weights = _weights(cfg)
    data = SyntheticDetectionData(cfg).batch(0)
    single = _take_step(cfg, _model(cfg, weights), data)
    order = interleaved(batch, 2, accum)
    same = single if order == sorted(order) else _take_step(
        cfg, _model(cfg, weights), type(data)(*(
            None if x is None else x[order] for x in data)),
        step_mod.SamplerDraws(single["draws"]["proposal"][order],
                              single["draws"]["anchor"][order]))
    ranks = dp.spawn_ranks(_rank, 2, cfg, weights, data,
                           workdir=str(tmp_path_factory.mktemp("ranks")))
    return cfg, weights, single, same, ranks


@pytest.fixture(scope="module", params=[(2, 1), (4, 2)], ids=["b2", "b4-accum2"])
def run(request, tmp_path_factory):
    return _run(tmp_path_factory, *request.param)


def test_ranks_form_one_group(run):
    _, _, single, _, ranks = run
    assert [r["rank_world"] for r in ranks] == [(0, 2), (1, 2)]
    assert all(r["step"] == single["step"] == 1 for r in ranks)


def test_losses_and_counts_match_one_process(run):
    _, _, _, single, ranks = run
    want = single["metrics"]
    for r in ranks:
        got = r["metrics"]
        assert got["n_valid_rois"] == want["n_valid_rois"]
        assert got["n_pos_rois"] == want["n_pos_rois"]
        for k in LOSSES:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
        assert got == ranks[0]["metrics"]


def test_updates_match_one_process(run):
    _, weights, _, single, ranks = run
    params = [k for k in weights if not k.endswith(("running_mean", "running_var"))]
    eps = torch.finfo(torch.float32).eps
    want = {k: single["state"][k] - weights[k] for k in params}
    largest = max(float(u.abs().max()) for u in want.values())
    assert largest > 0
    for k in params:
        got = ranks[0]["state"][k] - weights[k]
        err = float((got - want[k]).abs().max())
        tol = UPDATE_SHARE * largest + ULPS * eps * float(weights[k].abs().max())
        assert err <= tol, (k, err, tol)


def test_running_statistics_match_one_process(run):
    _, weights, _, single, ranks = run
    stats = [k for k in weights if k.endswith(("running_mean", "running_var"))]
    assert stats  # Darknet's BatchNorms train
    for k in stats:
        want = single["state"][k]
        assert not torch.equal(want, weights[k]), k
        scale = max(1.0, float(want.abs().max()))
        for r in ranks:
            err = float((r["state"][k] - want).abs().max())
            assert err <= STATS_RTOL * scale, (k, err)


def test_parameters_equal_in_bits_across_ranks(run):
    *_, ranks = run
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k


def test_each_rank_draws_its_rows_of_the_global_table(run):
    """The global table's rows [rank·b, (rank+1)·b) are what each rank's
    samplers see, exactly (micro-batch by micro-batch in order)."""
    cfg, _, single, _, ranks = run
    b = cfg.train.batch_size // 2
    for rank, r in enumerate(ranks):
        for kind in ("anchor", "proposal"):
            want = single["draws"][kind][rank * b:(rank + 1) * b]
            assert torch.equal(r["draws"][kind], want), (rank, kind)


REFUSALS = {
    "world": ((3, 1), "batch_size 3 not divisible by the world size 2"),
    "accum": ((2, 2), "batch 1 not divisible by grad_accum_steps 2 (global "
                      "batch 2 over 2 ranks"),
}


def _refusals(rank: int, world: int) -> dict:
    out = {}
    for name, ((batch, accum), _) in REFUSALS.items():
        cfg = _cfg(batch, accum)
        try:
            step = step_mod.make_train_step(cfg)
            step(create_train_state(cfg, MaskRCNN(cfg, device="cpu")),
                 dp.shard_rows(SyntheticDetectionData(cfg).batch(0), rank, world))
        except ValueError as e:
            out[name] = str(e)
    return out


@pytest.fixture(scope="module")
def refusals(tmp_path_factory):
    return dp.spawn_ranks(_refusals, 2, workdir=str(tmp_path_factory.mktemp("r")))


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_step_refuses_batches_the_ranks_cannot_split(refusals, case):
    """A global batch the world size does not divide, and a local batch the
    accumulation steps do not divide, raise in every rank."""
    for got in refusals:
        assert REFUSALS[case][1] in got[case]
