"""Train state, optimizer and LR schedule (port of
``maskrcnn_tpu/train/state.py``).

MomentumSGD(lr=1e-3, momentum=0.9) with WeightDecay(5e-4) added to the
gradient before the momentum update, over ALL parameters (BN
``weight``/``bias`` and conv biases included), and a step-decay schedule:
optax's ``add_decayed_weights`` then ``sgd(momentum)``. :class:`MomentumSGD`
writes that step out for both momentum dtypes: float32, or with
``train.momentum_dtype="bfloat16"`` a bf16 buffer (optax's
``accumulator_dtype``). It takes the learning rate as a tensor on the
parameters' device, which the train step computes there from a step counter
(:func:`lr_on_device`), as optax does inside JAX's program: so the update
reads nothing from the host and a CUDA graph of the step replays the
schedule. The state carries model, optimizer, step and sampler generator,
so a checkpoint of it resumes exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.models.layers import compute_dtype
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
from maskrcnn_tpu_torch.utils.device import device_constant


def lr_schedule(cfg: Config):
    """step → learning rate: ``lr · factor^(step // lr_decay_period)``."""
    base, factor = cfg.train.lr, cfg.train.lr_decay_factor
    period = cfg.train.lr_decay_period

    def schedule(step: int) -> float:
        return base * factor ** (step // period)

    return schedule


def lr_on_device(cfg: Config, step: torch.Tensor) -> torch.Tensor:
    """:func:`lr_schedule` of a 0-d int64 step counter, on its device: the
    schedule in float64, rounded to float32 once, as the host's Python
    float is rounded where it multiplies a float32 tensor."""
    base, factor = cfg.train.lr, cfg.train.lr_decay_factor
    factor_t = device_constant(factor, torch.float64, step.device)
    return (base * factor_t.pow(step // cfg.train.lr_decay_period)).float()


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
    rounded. ``step(lr)`` takes the rate as a 0-d float32 tensor on the
    parameters' device; without it, each group's ``lr``."""

    def __init__(self, params, lr: float, momentum: float, weight_decay: float,
                 momentum_dtype: torch.dtype):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay, dampening=0,
                                      nesterov=False))
        self.momentum_dtype = momentum_dtype
        # the momentum as the buffer's dtype holds it, once: a step reads
        # no tensor on the host
        self.decay = torch.tensor(momentum, dtype=momentum_dtype).item()

    @torch.no_grad()
    def step(self, lr: torch.Tensor | None = None):
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
            torch._foreach_add_(new, torch._foreach_mul(bufs, self.decay))
            rate = -group["lr"] if lr is None else -lr
            torch._foreach_add_(params, torch._foreach_mul(new, rate))
            torch._foreach_copy_(bufs, new)

    def load_state_dict(self, state_dict):
        """``Optimizer.load_state_dict`` casts every buffer to its
        parameter's dtype; the momentum buffer goes back to
        ``momentum_dtype`` (exact: it was stored in it)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            st["momentum_buffer"] = st["momentum_buffer"].to(self.momentum_dtype)


def make_optimizer(cfg: Config, model: torch.nn.Module) -> MomentumSGD:
    """:class:`MomentumSGD` with a float32 buffer (``momentum_dtype`` None or
    "float32") or a bf16 one."""
    t = cfg.train
    dt = torch.float32 if t.momentum_dtype is None else compute_dtype(t.momentum_dtype)
    return MomentumSGD(model.parameters(), t.lr, t.momentum, t.weight_decay, dt)


@dataclasses.dataclass
class TrainState:
    """Mutable: :func:`maskrcnn_tpu_torch.train.step.make_train_step`'s step
    updates the model's parameters and the optimizer's buffers in place."""

    model: MaskRCNN
    optimizer: MomentumSGD
    generator: torch.Generator  # the samplers' draws, on the model's device
    step: int = 0


def create_train_state(cfg: Config, model: MaskRCNN,
                       seed: int | None = None) -> TrainState:
    gen = torch.Generator(device=model.device)
    gen.manual_seed(cfg.train.seed if seed is None else seed)
    return TrainState(model, make_optimizer(cfg, model), gen)
