"""Train state, optimizer and LR schedule (port of
``maskrcnn_tpu/train/state.py``).

MomentumSGD(lr=1e-3, momentum=0.9) with WeightDecay(5e-4) added to the
gradient before the momentum update, over ALL parameters (BN
``weight``/``bias`` and conv biases included), and a step-decay schedule:
optax's ``add_decayed_weights`` then ``sgd(momentum)`` is
``torch.optim.SGD(momentum, weight_decay, dampening=0, nesterov=False)``.
With ``train.momentum_dtype="bfloat16"`` the momentum buffer is stored in
bf16 (optax's ``accumulator_dtype``), which ``torch.optim.SGD`` cannot do:
:class:`MomentumSGD` writes that step out. The state carries model,
optimizer, step and sampler generator, so a checkpoint of it resumes
exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.models.layers import compute_dtype
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN


def lr_schedule(cfg: Config):
    """step → learning rate: ``lr · factor^(step // lr_decay_period)``."""
    base, factor = cfg.train.lr, cfg.train.lr_decay_factor
    period = cfg.train.lr_decay_period

    def schedule(step: int) -> float:
        return base * factor ** (step // period)

    return schedule


class MomentumSGD(torch.optim.Optimizer):
    """optax ``chain(add_decayed_weights(wd), sgd(lr, momentum,
    accumulator_dtype=momentum_dtype))``, one ``torch._foreach_*`` pass per
    group: with ``d = g + wd·p`` and ``t`` the stored buffer,

        new = d + momentum·t     (float32; ``momentum·t`` in the buffer's
                                  dtype, as JAX multiplies a bf16 array by a
                                  Python float)
        p  -= lr · new
        t   = new, rounded to ``momentum_dtype``

    The parameter moves by the unrounded ``new``; only the buffer is
    rounded."""

    def __init__(self, params, lr: float, momentum: float, weight_decay: float,
                 momentum_dtype: torch.dtype):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay, dampening=0,
                                      nesterov=False))
        self.momentum_dtype = momentum_dtype

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            bufs = [self.state[p].setdefault(
                "momentum_buffer",
                torch.zeros_like(p, dtype=self.momentum_dtype,
                                 memory_format=torch.preserve_format))
                for p in params]
            new = torch._foreach_mul(params, group["weight_decay"])
            torch._foreach_add_(new, [p.grad for p in params])
            decay = torch.tensor(group["momentum"], dtype=self.momentum_dtype).item()
            torch._foreach_add_(new, torch._foreach_mul(bufs, decay))
            torch._foreach_add_(params, torch._foreach_mul(new, -group["lr"]))
            torch._foreach_copy_(bufs, new)


def make_optimizer(cfg: Config, model: torch.nn.Module) -> torch.optim.Optimizer:
    """``torch.optim.SGD`` with a float32 buffer (``momentum_dtype`` None or
    "float32"), else :class:`MomentumSGD`."""
    t = cfg.train
    dt = torch.float32 if t.momentum_dtype is None else compute_dtype(t.momentum_dtype)
    if dt == torch.float32:
        return torch.optim.SGD(
            model.parameters(), lr=t.lr, momentum=t.momentum,
            weight_decay=t.weight_decay, dampening=0, nesterov=False)
    return MomentumSGD(model.parameters(), t.lr, t.momentum, t.weight_decay, dt)


@dataclasses.dataclass
class TrainState:
    """Mutable: :func:`maskrcnn_tpu_torch.train.step.make_train_step`'s step
    updates the model's parameters and the optimizer's buffers in place."""

    model: MaskRCNN
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # the samplers' draws, on the model's device
    step: int = 0


def create_train_state(cfg: Config, model: MaskRCNN,
                       seed: int | None = None) -> TrainState:
    gen = torch.Generator(device=model.device)
    gen.manual_seed(cfg.train.seed if seed is None else seed)
    return TrainState(model, make_optimizer(cfg, model), gen)
