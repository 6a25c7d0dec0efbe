"""Where the port's results pack and the JAX package's part (ROADMAP F5):
both train CLIs on a pack config from ``--seed`` alone, on the CPU.

    PYTHONPATH=.:tests python tests/_pack_init_check.py [--config NAME]
        [--epochs N] [--work DIR]

On the pack's corpus (``scripts/results_pack_torch.py::build_corpus``)
it runs the JAX package's train CLI and the port's (``device="cpu"``)
with the pack's flags for ``--epochs`` epochs (150 by default, the
pack's), each drawing its own weights from the seed (the port's by
``utils/convert.py::init_from_seed``, no converted state), and prints
each one's first and last per-batch loss, the first batch where the two
print values more than ``_cli_parity.ATOL`` apart, and the JAX pack's
committed first and last loss (``results/<config>/summary.json``).
"""

import argparse
import importlib.util
import json
import os
import re
import sys
import tempfile

import jax
import numpy as np

from prtp_tpu import train as jax_train
from prtp_tpu_torch import train as train_mod

from _cli_parity import ATOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "results_pack_torch", os.path.join(REPO, "scripts",
                                       "results_pack_torch.py"))
pack = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pack)


def _losses(mdl):
    with open(os.path.join(mdl, "stdout.log")) as f:
        return [float(m) for m in re.findall(r"^e\d+,\S+,b\d+/\d+, l:(\S+),",
                                             f.read(), re.M)]


def seeded_run(data, args, tmp):
    """Both train CLIs from the seed in ``args``; returns each one's
    per-batch losses, as printed."""
    dirs = {name: os.path.join(tmp, name) for name in ("jax", "port")}
    jax_train.main(args + ["--model_saving_dir", dirs["jax"]])
    train_mod.main(args + ["--model_saving_dir", dirs["port"]], device="cpu")
    return {name: _losses(mdl) for name, mdl in dirs.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="cls_fusion")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--work", default=os.path.join(
        tempfile.gettempdir(), "prtp_pack_init_check"))
    opts = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    _name, kind, extra = next(c for c in pack.CONFIGS
                              if c[0] == opts.config)
    os.makedirs(opts.work, exist_ok=True)
    data = pack.build_corpus(opts.work, kind)
    args = (["--data_save_path", data, "--map_size",
             str(pack.CORPORA[kind]["map_size"]), "--num_epoch",
             str(opts.epochs), "--val_interval", "50"] + pack.BASE + extra)
    with tempfile.TemporaryDirectory(dir=opts.work) as tmp:
        runs = seeded_run(data, args, tmp)
    gaps = np.abs(np.subtract(runs["port"], runs["jax"]))
    apart = np.nonzero(gaps > ATOL)[0]
    for name, losses in runs.items():
        print(f"{opts.config}, {opts.epochs} epochs from --seed, {name}: "
              f"{len(losses)} batches, per-batch loss {losses[0]} -> "
              f"{losses[-1]}; the last 30 between {min(losses[-30:])} and "
              f"{max(losses[-30:])}")
    with open(os.path.join(REPO, "results", opts.config,
                           "summary.json")) as f:
        committed = json.load(f)
    print(f"the JAX pack's committed run: {committed['first_loss']} -> "
          f"{committed['last_loss']} over {committed['steps']} batches")
    print(f"first batch more than {ATOL} apart: "
          f"{int(apart[0]) if len(apart) else None}; largest gap "
          f"{gaps.max():.4g}")


if __name__ == "__main__":
    main(sys.argv[1:])
