"""Carry PathModel weights between the flax variable trees and a state_dict.

The flax trees are the nested dicts ``PathModel.init(...)["params"]`` and
``["batch_stats"]`` of the JAX package, with numpy arrays as leaves; the
state_dict is the port's ``PathModel.state_dict()``. The mapping, leaf
by leaf:

- Dense ``kernel (in, out)``  <->  Linear ``weight (out, in)``
- Conv ``kernel`` HWIO        <->  Conv2d ``weight`` OIHW
- ConvTranspose ``kernel (kh, kw, in, out)``  <->  ConvTranspose2d
  ``weight (in, out, kh, kw)``, flipped in space: flax's transposed
  convolution applies its kernel as a convolution does, torch's scatters
  each input by it, so ``w = k[::-1, ::-1].transpose(2, 3, 0, 1)``
- BatchNorm ``scale``  <->  ``weight``
- ``batch_stats`` ``mean``, ``var``  <->  buffers ``running_mean``,
  ``running_var``
- ``bias``, ``fcn_kernel (map^2, cnn_outdim)`` and ``fcn_bias`` as they are
- ``gnn/pair_step/<mlp>/...`` <->  ``gnn.<mlp>....`` (the port's TimeGNN
  holds the three pair-step MLPs directly)

``cnn/...`` (LayoutNet's ``Conv_{0..3}``, the U-Net's flax auto-names),
``mlp_alpha`` and ``mlp_fuse`` keep their names. Both directions copy
values exactly.
"""

from __future__ import annotations

import numpy as np
import torch

_PAIR_STEP = "pair_step"
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _transposed(path) -> bool:
    return any(part.startswith("ConvTranspose") for part in path)


def _key(path, name) -> str:
    if path[0] == "gnn" and path[1] == _PAIR_STEP:
        path = path[:1] + path[2:]
    return ".".join(tuple(path[:-1]) + (name,))


def params_from_flax(tree, batch_stats=None) -> dict:
    """flax param tree (and, for the U-Net, its ``batch_stats`` tree) ->
    state_dict of float32 CPU tensors."""
    state = {}
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, np.float32)  # a writable copy
        name = path[-1]
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4 and _transposed(path):
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            else:
                raise ValueError(f"unexpected kernel rank at {path}: "
                                 f"{arr.shape}")
            name = "weight"
        elif name == "scale":
            name = "weight"
        state[_key(path, name)] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, leaf in _flatten(batch_stats or {}):
        state[_key(path, _STATS[path[-1]])] = torch.from_numpy(
            np.array(leaf, np.float32))
    return state


def _tree_insert(tree, key, arr, name):
    path = key.split(".")
    if path[0] == "gnn":
        path.insert(1, _PAIR_STEP)
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[name] = np.ascontiguousarray(arr)


def params_to_flax(state_dict) -> dict:
    """state_dict -> flax param tree of float32 numpy arrays (the running
    averages go to :func:`batch_stats_to_flax`)."""
    tree = {}
    for key, val in state_dict.items():
        name = key.rsplit(".", 1)[-1]
        if name in _STATS.values():
            continue
        arr = val.detach().cpu().numpy().astype(np.float32)
        if name == "weight":
            if arr.ndim == 1:
                name = "scale"
            elif arr.ndim == 2:
                arr, name = arr.T, "kernel"
            elif arr.ndim == 4 and _transposed(key.split(".")):
                arr, name = arr.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
            elif arr.ndim == 4:
                arr, name = arr.transpose(2, 3, 1, 0), "kernel"  # -> HWIO
            else:
                raise ValueError(f"unexpected weight rank at {key}: "
                                 f"{arr.shape}")
        _tree_insert(tree, key, arr, name)
    return tree


def batch_stats_to_flax(state_dict) -> dict:
    """state_dict's BatchNorm running averages -> flax ``batch_stats``
    tree of float32 numpy arrays (empty without a U-Net)."""
    names = {v: k for k, v in _STATS.items()}
    tree = {}
    for key, val in state_dict.items():
        name = key.rsplit(".", 1)[-1]
        if name in names:
            _tree_insert(tree, key,
                         val.detach().cpu().numpy().astype(np.float32),
                         names[name])
    return tree
