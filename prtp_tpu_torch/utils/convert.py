"""Carry PathModel weights between the flax param tree and a state_dict.

The flax tree is the nested dict ``PathModel.init(...)["params"]`` of the
JAX package, with numpy arrays as leaves; the state_dict is the port's
``PathModel.state_dict()``. The mapping, leaf by leaf:

- Dense ``kernel (in, out)``  <->  Linear ``weight (out, in)``
- Conv ``kernel`` HWIO        <->  Conv2d ``weight`` OIHW
- ``bias``, ``fcn_kernel (map^2, cnn_outdim)`` and ``fcn_bias`` as they are
- ``gnn/pair_step/<mlp>/...`` <->  ``gnn.<mlp>....`` (the port's TimeGNN
  holds the three pair-step MLPs directly)

``cnn/Conv_{0..3}``, ``mlp_alpha`` and ``mlp_fuse`` keep their names.
Both directions copy values exactly.
"""

from __future__ import annotations

import numpy as np
import torch

_PAIR_STEP = "pair_step"


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def params_from_flax(tree) -> dict:
    """flax param tree -> state_dict of float32 CPU tensors."""
    state = {}
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, np.float32)  # a writable copy
        if path[0] == "gnn" and path[1] == _PAIR_STEP:
            path = path[:1] + path[2:]
        name = path[-1]
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            else:
                raise ValueError(f"unexpected kernel rank at {path}: "
                                 f"{arr.shape}")
            name = "weight"
        state[".".join(path[:-1] + (name,))] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return state


def params_to_flax(state_dict) -> dict:
    """state_dict -> flax param tree of float32 numpy arrays."""
    tree = {}
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy().astype(np.float32)
        path = key.split(".")
        if path[0] == "gnn":
            path.insert(1, _PAIR_STEP)
        if path[-1] == "weight":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            else:
                raise ValueError(f"unexpected weight rank at {key}: "
                                 f"{arr.shape}")
            path[-1] = "kernel"
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree
