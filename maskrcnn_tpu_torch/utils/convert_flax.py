"""Weight bridge: the JAX package's flax ``variables`` → the port's
``state_dict``.

Input is the ``{"params", "batch_stats"}`` tree as nested dicts of numpy
arrays, of any preset the port builds: the ResNet-50-FPN backbone, the
C4 backbone (ResNet-50 to res4), or the Darknet backbone (five convs with
bias under ``extractor/conv{1..5}/Conv_0`` and their trainable BatchNorms
under ``extractor/conv{1..5}/Norm_0/BatchNorm_0``, scale and bias in
``params``, mean and var in ``batch_stats``); the RPN head; the FPN mask or keypoint
head (``head/box``, ``head/mask``), the light head (the thin map's four
convs under ``head/thin``, ``fc``, ``cls_loc``, ``score``, ``conv2``..
``conv4``, ``deconv1``) or the Res5 head (res5 under ``head/res5/res5``,
``conv1``, per-class ``cls_loc``, ``score``, ``deconv1``, ``conv2``).
Module names carry over with ``Conv_k`` → ``conv{k}`` and
``Norm_k/BatchNorm_0`` → ``bn{k}``; leaves convert as follows:

- conv kernels HWIO → OIHW;
- dense kernels (in, out) → (out, in) (the box branch's ``fc1`` and the
  light head's ``fc``, 24,010 rows of a 7×7×490 pool, are already in the
  HWC order the port flattens in);
- every head's 2×2/2 transposed conv ``deconv1``, which the JAX module
  applies flipped: ``W[c, o, di, dj] = K[1-di, 1-dj, c, o]``;
- the mask head's ``conv2_kernel`` (c_in, n_out) → ``conv2_weight`` (n_out,
  c_in); the keypoint head's ``conv2`` is a 1×1 conv like any other
  (``mask1``..``mask8``, ``deconv1`` and ``conv2`` under ``head/mask``);
- BatchNorm scale/bias/mean/var → weight/bias/running_mean/running_var.

A JAX leaf with no place in the port, a port tensor with no JAX leaf, or a
shape mismatch raises. :func:`export_flax_variables` is the inverse, so the
running statistics a trainable BatchNorm moves (``batch_stats``) and the
parameters go back into a flax tree and compare leaf by leaf.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "mean": "running_mean", "var": "running_var",
         "conv2_kernel": "conv2_weight", "conv2_bias": "conv2_bias"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_key(path: tuple[str, ...]) -> str:
    mods = []
    for name in path[1:-1]:  # drop the collection and the leaf
        if name == "BatchNorm_0":
            continue
        m = re.fullmatch(r"(Conv|Norm)_(\d+)", name)
        mods.append(f"{'conv' if m[1] == 'Conv' else 'bn'}{m[2]}" if m else name)
    return ".".join(mods + [_LEAF[path[-1]]])


def _convert(path: tuple[str, ...], x: np.ndarray) -> np.ndarray:
    leaf = path[-1]
    if leaf == "conv2_kernel":
        return x.T
    if leaf != "kernel":
        return x
    if x.ndim == 4 and path[-2] == "deconv1":
        return x[::-1, ::-1].transpose(2, 3, 0, 1)  # (c_in, c_out, kh, kw)
    if x.ndim == 4:
        return x.transpose(3, 2, 0, 1)
    if x.ndim == 2:
        return x.T
    raise ValueError(f"{'/'.join(path)}: unexpected kernel rank {x.ndim}")


def _unconvert(path: tuple[str, ...], x: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_convert`."""
    leaf = path[-1]
    if leaf == "conv2_kernel":
        return x.T
    if leaf != "kernel":
        return x
    if x.ndim == 4 and path[-2] == "deconv1":
        return x.transpose(2, 3, 0, 1)[::-1, ::-1]
    if x.ndim == 4:
        return x.transpose(2, 3, 1, 0)
    return x.T


def _nest(pairs) -> dict:
    tree = {}
    for path, x in pairs:
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = x
    return tree


def convert_flax_variables(variables, model: torch.nn.Module) -> dict:
    """flax ``variables`` → a complete ``state_dict`` for ``model``."""
    target = model.state_dict()
    out, extra = {}, []
    for path, x in _flatten(variables):
        key = _torch_key(path) if path[-1] in _LEAF else None
        if key not in target:
            extra.append("/".join(path))
            continue
        y = np.ascontiguousarray(_convert(path, x))
        if tuple(y.shape) != tuple(target[key].shape):
            raise ValueError(f"{'/'.join(path)} → {key}: shape {y.shape} vs "
                             f"{tuple(target[key].shape)}")
        out[key] = torch.from_numpy(y.astype(np.float32))
    missing = sorted(set(target) - set(out))
    if extra or missing:
        raise KeyError(f"flax leaves without a port tensor: {extra}; "
                       f"port tensors without a flax leaf: {missing}")
    return out


def load_flax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load converted flax weights into ``model`` in place (any device)."""
    sd = convert_flax_variables(variables, model)
    model.load_state_dict(sd, strict=True)
    return model


def export_flax_variables(model: torch.nn.Module, like) -> dict:
    """``model``'s parameters and running statistics as a flax ``variables``
    tree with the paths of ``like`` (a tree of the same model, e.g. the one
    it was loaded from), float32 numpy leaves that own their memory."""
    sd = model.state_dict()
    return _nest(
        (path, np.array(_unconvert(
            path, sd[_torch_key(path)].detach().float().cpu().numpy()),
            order="C"))
        for path, _ in _flatten(like))
