"""On the card, at a small size: each cell's run is correct through the
program's kernels and CUDA graphs, its control (the reference in the
program's place with TF32 on, one step below the configuration's float32)
fails the cell's limits, and so does a training run with a fault planted
in its replayed step. On four cards, ``fpn_mask-train-dp4``'s four NCCL
ranks (an image each) are correct, and each fault planted in its ranks
fails. Run on a GPU:

    python -m pytest -m cuda benchmark/tests/test_perfbench_cuda.py
"""

import pytest

CELLS = ["fpn_mask-serve", "darknet_keypoint-serve", "fpn_mask-train"]


@pytest.fixture
def float32(card):
    import torch

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct_on_the_card(float32, cell):
    from benchmark import run as bench_run
    from benchmark.tests.rehearsal import small_run

    run = small_run(cell, device="cuda", seconds=0.5)
    line = bench_run.execute(run)
    assert line["correct"], line["compared"]
    if "train" in cell:  # the eager step and a replay compared
        assert line["checked"]["steps"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS + ["fpn_mask-train-dp4"])
def test_tf32_control_fails(float32, cell):
    from benchmark import control
    from benchmark.tests.rehearsal import small_run

    run = small_run(cell, device="cuda")
    fn = control.train_control if "train" in cell else control.serve_control
    numbers = fn(run, "tf32")
    assert not control.passes(run, numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["replay_half_batch", "replay_stale_input"])
def test_a_fault_in_the_replayed_step_fails(float32, fault):
    from benchmark import control
    from benchmark.tests.rehearsal import small_run

    run = small_run("fpn_mask-train", device="cuda", seconds=0.5)
    numbers = control.planted_run(run, fault)
    assert not numbers["correct"], numbers
    # the eager first step is sound; the fault shows from the replay on
    assert numbers["per_step"]["loss_gaps"][0] <= run.work["limits"]["loss_gap"]


@pytest.fixture
def four_cards(float32):
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")


def _dp_run():
    from benchmark.tests.rehearsal import small_run

    run = small_run("fpn_mask-train-dp4", device="cuda", seconds=0.5)
    run.work["params"].update(ranks=4, global_batch=4)
    return run


@pytest.mark.cuda
def test_dp_run_is_correct_on_four_cards(four_cards):
    from benchmark import run as bench_run

    line = bench_run.execute(_dp_run())
    assert line["correct"], line["compared"]
    assert line["checked"]["ranks"] == 4
    assert line["compared"]["rank_digest_apart"]["value"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["dp_skip_allreduce", "dp_local_counts"])
def test_a_fault_in_the_ranks_fails(four_cards, fault):
    from benchmark import control

    numbers = control.planted_run(_dp_run(), fault)
    assert not numbers["correct"], numbers
