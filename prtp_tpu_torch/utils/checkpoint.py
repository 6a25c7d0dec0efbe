"""Pickle-free torch checkpoints.

The API of ``prtp_tpu/utils/checkpoint.py``: :func:`save_checkpoint`,
:func:`checkpoint_exists`, :func:`load_config`, :func:`load_checkpoint`.
A checkpoint directory holds

- ``model.pt``: the train state through ``torch.save``, tensors and
  numbers only: the model's ``state_dict``, FlatAdam's ``mu``, ``nu``
  and ``count``, ``step``, ``best_f1`` and ``best_r2``. It is written to
  ``model.pt.tmp`` and renamed into place, and read with
  ``weights_only=True``, so loading runs no pickled code;
- ``config.json``: the hyperparameters, written exactly as the JAX
  package writes them.

The JAX package's ``model.msgpack`` is a flax blob that the port does not
read. A directory that holds one and no ``model.pt`` is not "empty":
:func:`checkpoint_exists` raises there, so that the train CLI never
starts fresh over it and rewrites its ``config.json``.
"""

from __future__ import annotations

import json
import os

import torch

from ..parallel.distributed import is_main_process

CKPT_NAME = "model.pt"
CONFIG_NAME = "config.json"
JAX_CKPT_NAME = "model.msgpack"


def save_checkpoint(save_dir: str, state, config: dict) -> str:
    """Write ``state`` (a :class:`~prtp_tpu_torch.trainer.TrainState`)
    and ``config``; returns the path of ``model.pt``. Under data
    parallelism only rank 0 writes (the ranks' states are replicas); the
    others return the path and write nothing."""
    path = os.path.join(save_dir, CKPT_NAME)
    if not is_main_process():
        return path
    os.makedirs(save_dir, exist_ok=True)
    blob = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "best_f1": float(state.best_f1),
        "best_r2": float(state.best_r2),
    }
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    with open(os.path.join(save_dir, CONFIG_NAME), "w") as f:
        json.dump(config, f, indent=2, sort_keys=True, default=str)
    return path


def checkpoint_exists(save_dir: str) -> bool:
    """Whether ``save_dir`` holds a port checkpoint. Raises
    ``FileExistsError`` where it holds only the JAX package's."""
    if os.path.exists(os.path.join(save_dir, CKPT_NAME)):
        return True
    if os.path.exists(os.path.join(save_dir, JAX_CKPT_NAME)):
        raise FileExistsError(
            f"{save_dir} holds the JAX package's {JAX_CKPT_NAME} and no "
            f"{CKPT_NAME}: prtp_tpu_torch reads only {CKPT_NAME}. Convert "
            "the flax params with prtp_tpu_torch.utils.convert."
            "params_from_flax and save them with save_checkpoint, or give "
            "another --model_saving_dir")
    return False


def load_config(save_dir: str) -> dict:
    """The saved hyperparameter record alone; empty dict when absent."""
    cfg_path = os.path.join(save_dir, CONFIG_NAME)
    if not os.path.exists(cfg_path):
        return {}
    with open(cfg_path) as f:
        return json.load(f)


def _check_fits(path: str, saved: dict, want: dict) -> None:
    """Raise unless ``saved`` holds exactly ``want``'s keys and shapes:
    ``load_state_dict`` would copy the tensors that fit before it raised
    for the rest."""
    missing = sorted(set(want) - set(saved))
    extra = sorted(set(saved) - set(want))
    shapes = [f"{k} {tuple(saved[k].shape)} (model {tuple(want[k].shape)})"
              for k in sorted(set(want) & set(saved))
              if saved[k].shape != want[k].shape]
    if missing or extra or shapes:
        raise ValueError(
            f"{path} was saved from another model than this one: missing "
            f"{missing}, unexpected {extra}, other shapes {shapes}. Give "
            "the model flags it was trained with (such as --attn and "
            "--num_heads, --unet, --task and --nlabels, the widths)")


def load_checkpoint(save_dir: str, state):
    """Restore ``model.pt`` into ``state`` in place: the model's
    parameters and FlatAdam's moments are copied into the tensors that
    are there (the parameters stay views of the optimizer's flat buffer),
    on their device.

    Returns (state, config). Raises FileNotFoundError when absent, and
    ValueError, before anything is copied, when the saved tensors do not
    fit the model (another architecture, such as ``--attn`` or its
    ``--num_heads``)."""
    dev = state.optimizer.flat.device
    path = os.path.join(save_dir, CKPT_NAME)
    blob = torch.load(path, map_location=dev, weights_only=True)
    _check_fits(path, blob["model"], state.model.state_dict())
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    state.best_f1 = float(blob["best_f1"])
    state.best_r2 = float(blob["best_r2"])
    return state, load_config(save_dir)
