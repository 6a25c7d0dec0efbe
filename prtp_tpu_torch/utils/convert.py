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

:func:`init_from_seed` draws, under these names, the tree that flax's
``model.init`` would make for a seed (``utils/jax_random.py``), so the
port starts where the JAX package does without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from . import jax_random

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


def _to_port(path, arr):
    """A flax leaf at ``path`` -> its state_dict key and the array in the
    port's layout."""
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
    return _key(path, name), arr


def _to_flax(key, arr):
    """A state_dict key (not a running average) and its array -> the flax
    leaf's path and the array in flax's layout."""
    path = key.split(".")
    name = path.pop()
    if path and path[0] == "gnn":
        path.insert(1, _PAIR_STEP)
    if name == "weight":
        if arr.ndim == 1:
            name = "scale"
        elif arr.ndim == 2:
            arr, name = arr.T, "kernel"
        elif arr.ndim == 4 and _transposed(path):
            arr, name = arr.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
        elif arr.ndim == 4:
            arr, name = arr.transpose(2, 3, 1, 0), "kernel"  # -> HWIO
        else:
            raise ValueError(f"unexpected weight rank at {key}: "
                             f"{arr.shape}")
    return tuple(path) + (name,), arr


def params_from_flax(tree, batch_stats=None) -> dict:
    """flax param tree (and, for the U-Net, its ``batch_stats`` tree) ->
    state_dict of float32 CPU tensors."""
    state = {}
    for path, leaf in _flatten(tree):
        # a writable copy
        key, arr = _to_port(path, np.array(leaf, np.float32))
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, leaf in _flatten(batch_stats or {}):
        state[_key(path, _STATS[path[-1]])] = torch.from_numpy(
            np.array(leaf, np.float32))
    return state


def _tree_insert(tree, path, arr):
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = np.ascontiguousarray(arr)


def params_to_flax(state_dict) -> dict:
    """state_dict -> flax param tree of float32 numpy arrays (the running
    averages go to :func:`batch_stats_to_flax`)."""
    tree = {}
    for key, val in state_dict.items():
        if key.rsplit(".", 1)[-1] in _STATS.values():
            continue
        _tree_insert(tree, *_to_flax(
            key, val.detach().cpu().numpy().astype(np.float32)))
    return tree


def batch_stats_to_flax(state_dict) -> dict:
    """state_dict's BatchNorm running averages -> flax ``batch_stats``
    tree of float32 numpy arrays (empty without a U-Net)."""
    names = {v: k for k, v in _STATS.items()}
    tree = {}
    for key, val in state_dict.items():
        path = key.split(".")
        if path[-1] in names:
            if path[0] == "gnn":
                path.insert(1, _PAIR_STEP)
            path[-1] = names[path[-1]]
            _tree_insert(tree, path,
                         val.detach().cpu().numpy().astype(np.float32))
    return tree


# A flax module makes its kernel (or a BatchNorm its scale) before its
# bias, and PathModel its fcn_kernel before its fcn_bias, so every drawn
# leaf takes its scope's first make_rng('params'); the constant leaves
# use up a counter but draw nothing
_FIRST_DRAW = 1


def _seed_leaf(root, path, shape) -> np.ndarray:
    """The flax leaf at ``path`` as flax's init under the key ``root``
    makes it, in flax's layout."""
    name = path[-1]
    if name in ("bias", "fcn_bias"):
        return np.zeros(shape, np.float32)
    if name == "scale":
        return np.ones(shape, np.float32)
    key = jax_random.param_key(root, path[:-1], _FIRST_DRAW)
    if name == "fcn_kernel":
        return jax_random.xavier_uniform(key, shape)
    if name == "kernel":  # Dense, Conv, ConvTranspose, StaticInputConv
        return jax_random.lecun_normal(key, shape)
    raise ValueError(f"no flax initializer known for {'/'.join(path)}")


def init_from_seed(model, seed: int):
    """Set ``model``'s parameters to the JAX package's
    ``jax.jit(model.init)(jax.random.PRNGKey(seed), ...)`` (on JAX's CPU
    backend), bit for bit, and its BatchNorm running averages to flax's
    (means 0, variances 1); returns ``model``.

    Each leaf is drawn on the host in float32 under its flax path
    (:func:`params_to_flax`'s names) by ``utils/jax_random.py`` and copied
    into the module on its device, so a card run and a CPU run start from
    the same bits. At the headline's width (2,727,202 parameters, the
    16,384 x 128 ``fcn_kernel`` among them) the draw takes 0.38-0.45 s
    on one core of an Intel Xeon (:func:`main`)."""
    root = jax_random.prng_key(seed)
    stats = {v: float(k == "var") for k, v in _STATS.items()}
    with torch.no_grad():
        for key, val in model.state_dict().items():
            name = key.rsplit(".", 1)[-1]
            if name in stats:
                val.fill_(stats[name])
                continue
            if not val.is_floating_point():
                continue
            # a zero-stride view: the layout's shape, no memory
            path, view = _to_flax(key, np.broadcast_to(
                np.float32(0), tuple(val.shape)))
            _key, arr = _to_port(path, _seed_leaf(root, path, view.shape))
            val.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return model


def main(argv=None):
    """Time :func:`init_from_seed` on the headline model (36 cell and 3
    net features, the CLIs' default widths) on this host:

        python -m prtp_tpu_torch.utils.convert [--seed S] [--reps N]
    """
    import argparse
    import time

    from ..models import PathModel

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--seed", type=int, default=9294)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    model = PathModel(36, 3)
    n = sum(p.numel() for p in model.parameters())
    for _ in range(args.reps):
        t0 = time.perf_counter()
        init_from_seed(model, args.seed)
        print(f"init_from_seed: {n} parameters in "
              f"{time.perf_counter() - t0:.3f} s (one thread)")


if __name__ == "__main__":
    main()
