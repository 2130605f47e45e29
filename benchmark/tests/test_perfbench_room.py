"""Room for configurations the frozen reference lacks: a head the reference
does not hold is built from ``benchmark/reference/heads_<head>.py``, a
chosen load the harness does not hold from ``benchmark/loads/<name>.py``,
and the loads find the class-score layer from the weights' names; the
existing configurations' weights and loads are what they were."""

import pytest
import torch

from benchmark import data, flops, spec
from benchmark import reference as reference_package
from benchmark.reference import config as ref_config
from benchmark.reference.maskrcnn import MaskRCNN
from benchmark.weights import make_weights

STUB_HEAD = '''
from torch import nn


class StubHead(nn.Module):
    roi_size_box = 7
    roi_size_mask = 14

    def __init__(self, n_class, width):
        super().__init__()
        self.fc = nn.Linear(width, 16)
        self.score = nn.Linear(16, n_class)


def build(cfg, width, dtype):
    return StubHead(cfg.model.n_class, width)
'''


def _with_head(cfg, head: str):
    import dataclasses

    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, head=head))


@pytest.fixture
def stub_heads(tmp_path, monkeypatch):
    """A directory searched for ``benchmark.reference`` modules, holding
    ``heads_stub.py``."""
    (tmp_path / "heads_stub.py").write_text(STUB_HEAD)
    monkeypatch.setattr(reference_package, "__path__",
                        [*reference_package.__path__, str(tmp_path)])
    yield tmp_path
    import sys

    sys.modules.pop("benchmark.reference.heads_stub", None)


def test_build_head_finds_a_head_module_by_file(stub_heads):
    model = MaskRCNN(_with_head(ref_config.tiny_test(), "stub"), device="meta")
    assert type(model.head).__name__ == "StubHead"
    assert model.head.score.out_features == 4  # tiny_test's 3 classes and background


def test_build_head_names_the_file_it_looked_for():
    with pytest.raises(ValueError, match=r"benchmark/reference/heads_nothing\.py"):
        MaskRCNN(_with_head(ref_config.tiny_test(), "nothing"), device="meta")


@pytest.mark.parametrize("config", ["fpn_mask", "darknet_keypoint"])
def test_loads_find_the_box_branch_score(config):
    cfg = spec.build_config(ref_config, spec.config_file(config))
    names = dict(MaskRCNN(cfg, device="meta").named_parameters())
    assert data.class_score_names(names) == ("head.box.score.weight",
                                             "head.box.score.bias")


def test_loads_find_a_head_level_score(stub_heads):
    cfg = _with_head(ref_config.tiny_test(), "stub")
    plain = make_weights(cfg, 2**31 + 3, torch.device("cpu"))
    loaded = make_weights(cfg, 2**31 + 3, torch.device("cpu"), "visualize_fill")
    assert data.class_score_names(plain) == ("head.score.weight", "head.score.bias")
    assert torch.equal(loaded["head.score.weight"], 32 * plain["head.score.weight"])
    assert torch.equal(loaded["head.score.bias"][1:], plain["head.score.bias"][1:] + 4)


def test_loads_want_exactly_one_class_score_layer():
    with pytest.raises(KeyError, match="one class-score layer"):
        data.class_score_names({"head.a.score.weight": 0, "head.b.score.weight": 0})
    with pytest.raises(KeyError, match="one class-score layer"):
        data.class_score_names({"rpn_head.score.weight": 0})


def _parent_loads(weights: dict, load: str) -> dict:
    """The loads as they were, on the box branch's names."""
    if load == "spread_class_scores":
        weights["head.box.score.weight"].mul_(8.0)
    else:
        weights["head.box.score.weight"].mul_(32.0)
        weights["head.box.score.bias"][1:] += 2.0
        if load == "visualize_fill":
            weights["head.box.score.bias"][1:] += 2.0
    return weights


@pytest.mark.parametrize("config, load", [
    ("fpn_mask", None), ("fpn_mask", "spread_class_scores"),
    ("darknet_keypoint", "visualize_load"), ("darknet_keypoint", "visualize_fill")])
def test_weights_are_the_parents_bit_for_bit(config, load):
    cfg = spec.build_config(ref_config, spec.config_file(config))
    seed, cpu = 2**31 + 19, torch.device("cpu")
    now = make_weights(cfg, seed, cpu, load)
    before = make_weights(cfg, seed, cpu)
    if load is not None:
        _parent_loads(before, load)
    assert now.keys() == before.keys()
    for name in now:
        assert torch.equal(now[name], before[name]), name


def test_a_load_is_found_by_file(tmp_path, monkeypatch):
    (tmp_path / "halve_bias.py").write_text(
        "def apply(weights):\n"
        "    weights['head.box.score.bias'].mul_(0.5)\n"
        "    return weights\n")
    monkeypatch.setattr(data, "LOADS_DIR", tmp_path)
    weights = {"head.box.score.bias": torch.full((3,), 2.0)}
    data.chosen_load("halve_bias")(weights)
    assert torch.equal(weights["head.box.score.bias"], torch.ones(3))
    assert data.chosen_load("spread_class_scores") is data.spread_class_scores
    with pytest.raises(KeyError, match="no_such_load.py"):
        data.chosen_load("no_such_load")


@pytest.mark.parametrize("config, rows, request_flops", [
    ("fpn_mask", 100, 427_410_137_088),
    # one class keeping 10: pass 2 on 11 rows, the head's 0.5732 GFLOP a row
    ("darknet_keypoint", 11, 8_367_529_984)])
def test_request_counts_pass_2_on_the_rows_it_runs(config, rows, request_flops):
    cfg = spec.build_config(ref_config, spec.config_file(config))
    assert flops.head_rows(cfg) == rows
    assert flops.request_flops(cfg) == request_flops
    assert spec.config_file(config)["model_flops"]["request"] == request_flops

