"""Train state, optimizer and LR schedule (port of
``maskrcnn_tpu/train/state.py``).

MomentumSGD(lr=1e-3, momentum=0.9) with WeightDecay(5e-4) added to the
gradient before the momentum update, over ALL parameters (frozen-BN
``weight``/``bias`` and conv biases included), and a step-decay schedule:
optax's ``add_decayed_weights`` then ``sgd(momentum)`` is
``torch.optim.SGD(momentum, weight_decay, dampening=0, nesterov=False)``.
The state carries model, optimizer, step and sampler generator, so a
checkpoint of it resumes exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN


def lr_schedule(cfg: Config):
    """step → learning rate: ``lr · factor^(step // lr_decay_period)``."""
    base, factor = cfg.train.lr, cfg.train.lr_decay_factor
    period = cfg.train.lr_decay_period

    def schedule(step: int) -> float:
        return base * factor ** (step // period)

    return schedule


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.SGD:
    if cfg.train.momentum_dtype is not None:
        raise NotImplementedError(
            "momentum_dtype: the port keeps the momentum buffer in float32")
    return torch.optim.SGD(
        model.parameters(), lr=cfg.train.lr, momentum=cfg.train.momentum,
        weight_decay=cfg.train.weight_decay, dampening=0, nesterov=False)


@dataclasses.dataclass
class TrainState:
    """Mutable: :func:`maskrcnn_tpu_torch.train.step.make_train_step`'s step
    updates the model's parameters and the optimizer's buffers in place."""

    model: MaskRCNN
    optimizer: torch.optim.SGD
    generator: torch.Generator  # the samplers' draws, on the model's device
    step: int = 0


def create_train_state(cfg: Config, model: MaskRCNN,
                       seed: int | None = None) -> TrainState:
    gen = torch.Generator(device=model.device)
    gen.manual_seed(cfg.train.seed if seed is None else seed)
    return TrainState(model, make_optimizer(cfg, model), gen)
