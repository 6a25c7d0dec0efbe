"""Where the port's results pack and the JAX package's part (ROADMAP F5,
F6): their inits, and their training from one init, on a pack config.

    PYTHONPATH=.:tests python tests/_pack_init_check.py [--config NAME]
        [--epochs N] [--seeds N] [--work DIR]

On the pack's corpus (``scripts/results_pack_torch.py::build_corpus``,
on the CPU) it prints (1) the RMS of each package's initial predictions
on ``syn_a``'s train split for ``--seed`` 0 .. N-1 (the port's weights
from a seeded ``torch.Generator``, JAX's from ``PRNGKey``) and (2) with
``--epochs``, both train CLIs from JAX's init converted
(``_cli_parity.save_initial_states``) for that many epochs: each one's
first and last per-batch loss and the first batch where the two print
values more than ``_cli_parity.ATOL`` apart.
"""

import argparse
import importlib.util
import os
import re
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from prtp_tpu import train as jax_train
from prtp_tpu.data.dataset import load_single_design as jax_load_single
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models.fusion import model_from_options as jax_model_from_options
from prtp_tpu.options import get_options as jax_get_options
from prtp_tpu_torch import train as train_mod
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models.fusion import model_from_options
from prtp_tpu_torch.options import get_options

from _cli_parity import ATOL, save_initial_states

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "results_pack_torch", os.path.join(REPO, "scripts",
                                       "results_pack_torch.py"))
pack = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pack)


def init_scales(data, args, seeds):
    """(JAX's, the port's) RMS of the initial predictions on ``syn_a``'s
    train split, one a seed."""
    jopts = jax_get_options(args)
    jopts.cell_feat_dim -= jopts.feat_reduce[0]
    jopts.net_feat_dim -= jopts.feat_reduce[1]
    parsed = jax_load_single("train", data, "syn_a",
                             feat_reduce=jopts.feat_reduce)
    jdesign = jax_pack_design(parsed, map_size=jopts.map_size)
    jids = jnp.arange(jdesign.num_paths, dtype=jnp.int32)
    design = pack_design(parsed, map_size=jopts.map_size, device="cpu")
    ids = torch.arange(design.num_paths)
    out = ([], [])
    for seed in range(seeds):
        model = jax_model_from_options(jopts)
        variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jdesign,
                                        jids)
        preds = model.apply(variables, jdesign, jids)
        out[0].append(float(jnp.sqrt(jnp.mean(preds ** 2))))
        port = model_from_options(
            get_options(args + ["--seed", str(seed)]),
            parsed["cell_feat"].shape[1], parsed["net_feat"].shape[1],
            parsed["cnn_input"].shape[0])
        with torch.no_grad():
            out[1].append(float(port(design, ids).pow(2).mean().sqrt()))
    return out


def _losses(mdl):
    with open(os.path.join(mdl, "stdout.log")) as f:
        return [float(m) for m in re.findall(r"^e\d+,\S+,b\d+/\d+, l:(\S+),",
                                             f.read(), re.M)]


def converted_run(data, args, tmp):
    """Both train CLIs from JAX's init; returns each one's per-batch
    losses."""
    dirs = {name: os.path.join(tmp, name) for name in ("jax", "port")}
    save_initial_states(data, args, dirs)
    jax_train.main(args + ["--model_saving_dir", dirs["jax"]])
    train_mod.main(args + ["--model_saving_dir", dirs["port"]], device="cpu")
    return {name: _losses(mdl) for name, mdl in dirs.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="cls_fusion")
    ap.add_argument("--epochs", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--work", default=os.path.join(
        tempfile.gettempdir(), "prtp_pack_init_check"))
    opts = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    _name, kind, extra = next(c for c in pack.CONFIGS
                              if c[0] == opts.config)
    os.makedirs(opts.work, exist_ok=True)
    data = pack.build_corpus(opts.work, kind)
    args = (["--data_save_path", data, "--map_size",
             str(pack.CORPORA[kind]["map_size"])] + pack.BASE + extra)
    jax_rms, port_rms = init_scales(data, args, opts.seeds)
    print(f"{opts.config}: initial prediction RMS on syn_a, seeds 0-"
          f"{opts.seeds - 1}: JAX {np.round(jax_rms, 3).tolist()} (mean "
          f"{np.mean(jax_rms):.3f}), port {np.round(port_rms, 3).tolist()} "
          f"(mean {np.mean(port_rms):.3f})")
    if not opts.epochs:
        return
    with tempfile.TemporaryDirectory(dir=opts.work) as tmp:
        runs = converted_run(data, args + ["--num_epoch", str(opts.epochs),
                                           "--val_interval", "50"], tmp)
    gaps = np.abs(np.subtract(runs["port"], runs["jax"]))
    apart = np.nonzero(gaps > ATOL)[0]
    for name, losses in runs.items():
        print(f"{opts.config}, {opts.epochs} epochs from JAX's init, {name}:"
              f" {len(losses)} batches, per-batch loss {losses[0]} -> "
              f"{losses[-1]}; the last 30 between {min(losses[-30:])} and "
              f"{max(losses[-30:])}")
    print(f"first batch more than {ATOL} apart: "
          f"{int(apart[0]) if len(apart) else None}; largest gap "
          f"{gaps.max():.4g}")


if __name__ == "__main__":
    main(sys.argv[1:])
