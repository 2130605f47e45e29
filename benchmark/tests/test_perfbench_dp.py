"""``fpn_mask-train-dp4`` (a cell held out of ``BENCHMARK.json``, PERF.md
§7) rehearsed on the CPU: two gloo ranks, rank 0 in this process and rank 1
spawned, at a small size. A sound run is correct; the exchange between the
ranks left out on one rank, and losses divided by each rank's own counts,
read not correct. The reference in blocks of rows is the whole batch's
step. And the all-reduce readers on a trace of known intervals."""

import pytest

from benchmark import control
from benchmark.run import load_reader
from benchmark.tests.rehearsal import rehearse, small_run
from benchmark.trace import Trace

CELL = "fpn_mask-train-dp4"


def test_rehearsal_is_correct():
    line = rehearse(CELL)
    assert line["correct"], line["compared"]
    assert line["checked"]["ranks"] == 2 and line["checked"]["steps"] == 1
    assert line["compared"]["rank_digest_apart"]["value"] == 0
    # held out of BENCHMARK.json: no metric lists the cell but set-up
    assert set(line["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("fault, caught_by", [
    ("dp_skip_allreduce", "rank_digest_apart"),
    ("dp_local_counts", "grad_gap")])
def test_a_planted_fault_reads_not_correct(fault, caught_by):
    run = small_run(CELL)
    numbers = control.planted_run(run, fault)
    assert not numbers["correct"], numbers
    assert numbers[caught_by] > run.work["limits"][caught_by]


def _trace(device, annotations=()):
    return Trace(device=list(device), host=[], kernels=[], wall_s=1.0,
                 units=2, untraced_wall_s=1.0, annotations=tuple(annotations))


class _Readings:
    def __init__(self, trace):
        self.eager = trace


def test_allreduce_readers_take_kernels_by_name():
    device = [
        ("conv_fwd_kernel", 0, 100),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 90, 140),
        ("nccl:all_reduce", 85, 145),  # the host operation's device-side copy
        ("Memcpy DtoD (Device -> Device)", 120, 130),
        ("ncclKernel_AllReduce_RING_LL_Sum_int64_t", 200, 210),
        ("sgd_kernel", 205, 230)]
    readings = _Readings(_trace(device, annotations=[("nccl:all_reduce", 85, 145)]))
    # 50 + 10 µs of all-reduce over 2 steps
    assert load_reader("allreduce_device_ms.train")(readings) == pytest.approx(0.030)
    # exposed: 100–140 and 200–205
    assert load_reader("allreduce_exposed_ms.train")(readings) == pytest.approx(0.0225)


def test_allreduce_readers_give_nothing_without_nccl():
    readings = _Readings(_trace([("conv_fwd_kernel", 0, 100)]))
    assert load_reader("allreduce_device_ms.train")(readings) is None
    assert load_reader("allreduce_exposed_ms.train")(readings) is None
    assert load_reader("allreduce_device_ms.train")(_Readings(None)) is None


def test_the_reference_in_blocks_is_the_whole_batchs_step():
    import torch

    from benchmark.reference.maskrcnn import MaskRCNN
    from benchmark.reference.train import Trainer
    from benchmark.traffic.train_chain import _on_device
    from benchmark.traffic.train_dp import global_batches
    from benchmark.weights import load_into, make_weights

    run = small_run(CELL)
    run.work["params"]["global_batch"] = 4
    rcfg = run.reference_config({"train": {"batch_size": 4}})
    batch = _on_device(global_batches(run)[0], torch.device("cpu"))
    weights = make_weights(rcfg, run.seed, torch.device("cpu"))
    steps = {}
    for blocks in (1, 2, 4):
        model = MaskRCNN(rcfg, device="cpu")
        load_into(model, weights)
        trainer = Trainer(rcfg, model, 5)
        loss = trainer.step(batch, blocks)
        steps[blocks] = loss, {n: p.detach().clone() for n, p in model.named_parameters()}
    for blocks in (2, 4):
        assert steps[blocks][0] == pytest.approx(steps[1][0], rel=1e-5)
        for name, p in steps[1][1].items():
            torch.testing.assert_close(steps[blocks][1][name], p, rtol=1e-4, atol=1e-7)
