"""A run whose timed path is broken underneath comes out not correct:
once for each fault the cell can have (a step that leaves its state
unchanged, half the batch left out with the mean over the rest, an answer
altered where it is produced), at a small size on the CPU."""

import pytest
import torch

from benchmark.tests.rehearsal import rehearse


def test_state_left_unchanged(monkeypatch):
    from maskrcnn_tpu_torch.train import state

    monkeypatch.setattr(state.MomentumSGD, "step",
                        torch.no_grad()(lambda self, lr=None: None))
    line = rehearse("fpn_mask-train")
    assert not line["correct"]
    assert line["compared"]["update_gap"]["value"] > line["compared"]["update_gap"]["limit"]


def test_half_the_batch_left_out(monkeypatch):
    from maskrcnn_tpu_torch.train import step

    to_device = step.to_device

    def half(fields, dev):
        moved = to_device(fields, dev)
        if isinstance(moved, step.Batch) and moved.images.dim() == 4:
            b = moved.images.shape[0] // 2
            return type(moved)(*(None if x is None else x[:b] for x in moved))
        return moved

    monkeypatch.setattr(step, "to_device", half)
    assert not rehearse("fpn_mask-train")["correct"]


@pytest.mark.parametrize("cell", ["fpn_mask-serve", "darknet_keypoint-serve"])
def test_answer_altered(monkeypatch, cell):
    from maskrcnn_tpu_torch.eval import predict

    make = predict.make_predict_fn

    def altered(cfg, model, image_size=None):
        inner = make(cfg, model, image_size)

        def serve(*request):
            det = inner(*request)
            return det._replace(scores=det.scores + 0.01 * det.valid)

        serve.eager, serve.graphs = inner.eager, inner.graphs
        return serve

    monkeypatch.setattr(predict, "make_predict_fn", altered)
    line = rehearse(cell)
    assert line["checked"]["detections"] > 0
    assert not line["correct"]
