"""Checkpoints of the full train state, for an exact resume (port of
``maskrcnn_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file, ``<dir>/step_<8-digit step>.pt``,
holding the model's ``state_dict`` (parameters and buffers: frozen-BN
statistics and trainable-BN running statistics too), the optimizer's
``state_dict`` (momentum buffers), the step, and the sampler generator's
state. It is written to a temporary file and renamed into place, so a run
killed mid-write leaves no partial checkpoint. ``load_params_only`` is the
warm start: parameters and buffers, with the optimizer, step and generator
left as they are. JAX (orbax) checkpoints are not read here; JAX weights
come in through :mod:`maskrcnn_tpu_torch.utils.convert_flax`.
"""

from __future__ import annotations

import os
import re

import torch

from maskrcnn_tpu_torch.train.state import TrainState

_NAME = re.compile(r"step_(\d+)\.pt$")


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int | None = None) -> str:
    """Write ``state`` as ``step_<step>.pt`` (``step`` defaults to the
    state's) → its path; a step already on disk is left as it is."""
    step = state.step if step is None else step
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
    if os.path.exists(path):
        return path
    tmp = path + ".tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step,
                "generator": state.generator.get_state()}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The checkpoint of the highest step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [(int(m.group(1)), name) for name in os.listdir(ckpt_dir)
             if (m := _NAME.fullmatch(name))]
    return os.path.join(ckpt_dir, max(steps)[1]) if steps else None


def _load(path: str, state: TrainState) -> dict:
    # our own files only: the generator state and the optimizer's need the
    # full unpickler
    return torch.load(path, map_location=state.model.device, weights_only=False)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Exact resume: parameters, buffers, optimizer, step and generator of
    ``path`` into ``state`` (in place) → ``state``."""
    ckpt = _load(path, state)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state.generator.set_state(ckpt["generator"].cpu())
    return state


def load_params_only(path: str, state: TrainState) -> TrainState:
    """Warm start: parameters and buffers of ``path`` into ``state``'s model
    (in place); optimizer, step and generator stay fresh → ``state``."""
    state.model.load_state_dict(_load(path, state)["model"])
    return state
