"""The CLI parity checks shared by ``tests/test_torch_cli_parity*.py``:
from one initial state, converted from JAX's, both packages' train CLIs
must print the same per-batch and validation values and both test CLIs
the same ``predict.txt`` row and ``predict_critical`` lists, for each
flag set of CLI_FLAGS; the SEEDED flag sets give no state, and each
package draws its own from ``--seed`` (the port by
``utils/convert.py::init_from_seed``) and trains one whole epoch. Each test file runs some of the flag sets
(:func:`cli_runs_fixture`), so that pytest-xdist's ``--dist loadfile``
spreads them over its workers.

Run as a script, :func:`main` measures how far the two packages' CLIs
lie apart on any flag set (``tests/test_torch_cli_parity.py`` calls it):

    PYTHONPATH=. python tests/test_torch_cli_parity.py [flag ...]
"""

import functools
import json
import os
import re
import tempfile

import jax
import numpy as np
import pytest

from prtp_tpu import test as jax_test
from prtp_tpu import train as jax_train
from prtp_tpu import trainer as jtrainer
from prtp_tpu.data.dataset import load_single_design as jax_load_single
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models.fusion import model_from_options as jax_model_from_options
from prtp_tpu.options import get_options as jax_get_options
from prtp_tpu.utils import checkpoint as jax_ckpt
from prtp_tpu_torch import test as test_mod
from prtp_tpu_torch import train as train_mod
from prtp_tpu_torch.data import generate, synthetic
from prtp_tpu_torch.models.fusion import model_from_options
from prtp_tpu_torch.options import get_options
from prtp_tpu_torch.trainer import init_state, make_optimizer
from prtp_tpu_torch.utils import checkpoint as ckpt
from prtp_tpu_torch.utils.convert import params_from_flax

from test_torch_cli import MAP_ARGS

CORPUS_ARGS = ["--designs", "syn_a", "syn_b", "--num_paths", "6",
               "--depth", "4", "--cnn_hw", "64"]
# the U-Net halves its raster: a 32 px raster for MAP_ARGS' map of 16
UNET_CORPUS_ARGS = CORPUS_ARGS[:-1] + ["32", "--cnn_channels", "3"]
# the flag sets of the CLI runs, and the corpus each runs on
CLI_FLAGS = {
    "default": ([], "corpus"),
    "cls": (["--task", "cls", "--nlabels", "2"], "corpus"),
    "unet": (["--unet"], "unet"),
    "attn": (["--attn", "--num_heads", "2"], "corpus"),
    "flags": (["--norm", "--pooling", "avg", "--droplast", "--os_rate", "2",
               "--weight_decay", "1e-4"], "corpus"),
    # --exact_levels so that JAX's train steps take its fused exact walk,
    # the port's; JAX's validations (two designs) and test CLI still
    # evaluate through its padded scan, and so does the port's
    "bf16": (["--compute_dtype", "bfloat16", "--exact_levels"], "corpus"),
    # JAX's default flags: its train steps, validations and test CLI all
    # take its padded scan, and the port's the scan's rounding
    "bf16_default": (["--compute_dtype", "bfloat16"], "corpus"),
    "merged": (["--merge_designs"], "corpus"),
    # each package's own weights for the default --seed, and the U-Net's
    # (BatchNorm scales and running averages) for another
    "seeded": ([], "corpus"),
    "seeded_unet": (["--unet", "--seed", "3"], "unet"),
}
SEEDED = ("seeded", "seeded_unet")
# the corpus's train batches in one epoch: syn_a 2, syn_b 3
EPOCH_BATCHES = 5
# printed values: 3 decimals, and float32 sums taken in another order
RTOL, ATOL = 1e-4, 2e-3
# bf16 evaluations (validation lines, the test CLI's row): both packages
# round the walk's pair-step MLPs as JAX's padded scan does
# (tests/test_torch_bf16_eval.py); what is left is the layout CNN's bf16
# outputs, a few an ulp apart where a float32 sum is taken in another
# order. This module's main() measured the validation values equal and
# the test row 1.7e-3 apart (needing rtol 1.73e-3 beside ATOL); 3.8e-2 in
# validation while the port evaluated through the fused walk's rounding
BF16_EVAL_RTOL = 5e-3
BF16_RUNS = ("bf16", "bf16_default")
_NUMBER = re.compile(r"-?(?:\d+\.\d+(?:e[+-]?\d+)?|inf|nan)")


@pytest.fixture(scope="module")
def unet_data(tmp_path_factory):
    """The port's synthetic and generate on a 3-channel corpus."""
    raw = str(tmp_path_factory.mktemp("unet_raw"))
    data = str(tmp_path_factory.mktemp("unet_data"))
    synthetic.main(["--out", raw] + UNET_CORPUS_ARGS)
    generate.main(["--rawdata_path", raw, "--data_save_path", data,
                   "--map_size", "16"])
    return data


@pytest.fixture(scope="module")
def corpus_data(tmp_path_factory):
    """The port's synthetic and generate on the small corpus."""
    raw = str(tmp_path_factory.mktemp("corpus_raw"))
    data = str(tmp_path_factory.mktemp("corpus_data"))
    synthetic.main(["--out", raw] + CORPUS_ARGS)
    generate.main(["--rawdata_path", raw, "--data_save_path", data,
                   "--map_size", "16"])
    return data


def cli_runs_fixture(names):
    """A module fixture ``cli_runs`` over the flag sets ``names`` of
    CLI_FLAGS: for each, both packages' train and test CLIs from one
    initial state (:func:`run_clis`) on ``corpus_data`` or
    ``unet_data``. Returns the model directories and the flag set's
    name."""
    @pytest.fixture(scope="module", params=list(names), name="cli_runs")
    def cli_runs(request, tmp_path_factory):
        flags, corpus = CLI_FLAGS[request.param]
        data = request.getfixturevalue(
            "corpus_data" if corpus == "corpus" else "unet_data")
        dirs = {"jax": str(tmp_path_factory.mktemp("jax_mdl")),
                "port": str(tmp_path_factory.mktemp("port_mdl"))}
        run_clis(data, flags, dirs, seeded=request.param in SEEDED)
        return dirs, request.param

    return cli_runs


def _train_lines(mdl):
    """The loop's lines of the run's stdout.log, the model directory
    written as MDL: (line with each number as #, its numbers)."""
    keep = ("e", "validate:", "\tcase", "\toverall", "Saving model",
            "Model successfully", "max_steps", "-------")
    out = []
    with open(os.path.join(mdl, "stdout.log")) as f:
        for line in f.read().splitlines():
            if line.startswith(keep):
                line = line.replace(mdl, "MDL")
                out.append((_NUMBER.sub("#", line),
                            [float(x) for x in _NUMBER.findall(line)]))
    return out


def test_train_cli_prints_jax_values(cli_runs):
    dirs, run = cli_runs
    want, got = _train_lines(dirs["jax"]), _train_lines(dirs["port"])
    assert [s for s, _ in got] == [s for s, _ in want]
    assert sum(s.startswith("e0,") for s, _ in want) == (
        EPOCH_BATCHES if run in SEEDED else 3)
    assert sum(s == "validate:" for s, _ in want) >= 2
    for (line, a), (_s, b) in zip(got, want):
        rtol = (BF16_EVAL_RTOL if run in BF16_RUNS and not line.startswith("e")
                else RTOL)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=ATOL, err_msg=line)


def test_train_cli_saves_jax_config(cli_runs):
    configs = {}
    for name, mdl in cli_runs[0].items():
        with open(os.path.join(mdl, "config.json")) as f:
            configs[name] = json.load(f)
        assert configs[name].pop("model_saving_dir") == mdl
        configs[name].pop("compile_cache_dir")
    assert configs["port"] == configs["jax"]


def test_test_cli_writes_jax_predictions(cli_runs):
    dirs, run = cli_runs
    rows = {}
    for name, mdl in dirs.items():
        with open(os.path.join(mdl, "predict.txt")) as f:
            rows[name] = [float(x) for x in f.read().split()]
    assert len(rows["jax"]) == 6
    np.testing.assert_allclose(rows["port"], rows["jax"], atol=ATOL,
                               rtol=BF16_EVAL_RTOL if run in BF16_RUNS
                               else RTOL)
    if run == "cls":  # no regression outputs, in either package
        assert rows["jax"][1] == rows["port"][1] == 0.0
        for mdl in dirs.values():
            assert not os.path.exists(os.path.join(mdl, "predict_critical"))
            assert not os.path.exists(os.path.join(mdl, "visual"))
        return
    crit = {name: sorted(os.listdir(os.path.join(mdl, "predict_critical")))
            for name, mdl in dirs.items()}
    assert crit["port"] == crit["jax"] == ["syn_a.json", "syn_b.json"]
    for name in crit["jax"]:
        lists = []
        for mdl in dirs.values():
            with open(os.path.join(mdl, "predict_critical", name)) as f:
                lists.append(json.load(f))
        assert lists[0] == lists[1], name


def save_initial_states(data, args, dirs):
    """JAX's ``init_state`` for the train CLI arguments ``args`` saved by
    JAX in ``dirs["jax"]``, converted (running averages too) and saved by
    the port in every other directory of ``dirs``."""
    jopts = jax_get_options(args + ["--model_saving_dir", dirs["jax"]])
    jopts.cell_feat_dim -= jopts.feat_reduce[0]
    jopts.net_feat_dim -= jopts.feat_reduce[1]
    parsed = jax_load_single("train", data, "syn_a",
                             feat_reduce=jopts.feat_reduce)
    jstate = jtrainer.init_state(
        jax_model_from_options(jopts),
        jtrainer.make_optimizer(jopts.learning_rate, jopts.weight_decay),
        jax_pack_design(parsed, map_size=jopts.map_size),
        jax.random.PRNGKey(jopts.seed))
    jax_ckpt.save_checkpoint(dirs["jax"], jstate, dict(vars(jopts)))

    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    for name, mdl in dirs.items():
        if name == "jax":
            continue
        popts = get_options(args + ["--model_saving_dir", mdl])
        popts.cell_feat_dim -= popts.feat_reduce[0]
        popts.net_feat_dim -= popts.feat_reduce[1]
        model = model_from_options(popts, parsed["cell_feat"].shape[1],
                                   parsed["net_feat"].shape[1],
                                   parsed["cnn_input"].shape[0], draw=False)
        model.load_state_dict(params_from_flax(to_np(jstate.params),
                                               to_np(jstate.batch_stats)))
        state = init_state(model, make_optimizer(popts.learning_rate), "cpu")
        ckpt.save_checkpoint(mdl, state, dict(vars(popts)))


def run_clis(data, flags, dirs, seeded=False):
    """JAX's init_state saved by JAX, converted (running averages too)
    and saved by the port (:func:`save_initial_states`); then both train
    CLIs resume on ONE data directory (the first writes the validation
    split files, the second reads them) for 3 steps, and both test CLIs
    evaluate. ``seeded``: no state is saved, each train CLI draws its
    own weights from ``--seed`` and trains one whole epoch. ``dirs``
    maps ``"jax"`` and ``"port"`` to a model directory each."""
    args = (["--data_save_path", data, "--num_epoch", "1", "--val_interval",
             "2", "--steps_per_dispatch", "1"] + MAP_ARGS + flags)
    if not seeded:
        args += ["--max_steps", "3"]
        save_initial_states(data, args, dirs)
    jax_train.main(args + ["--model_saving_dir", dirs["jax"]])
    train_mod.main(args + ["--model_saving_dir", dirs["port"]], device="cpu")
    test_args = ["--data_save_path", data] + MAP_ARGS + flags
    jax_test.main(test_args + ["--model_saving_dir", dirs["jax"]])
    test_mod.main(test_args + ["--model_saving_dir", dirs["port"]],
                  device="cpu")


def _gap(a, b, atol):
    a, b = np.asarray(a, float), np.asarray(b, float)
    need = (np.abs(a - b) - atol) / np.maximum(np.abs(b), 1e-30)
    return float(np.abs(a - b).max()), float(max(need.max(), 0.0))


def main(argv):
    """On this module's corpus (CORPUS_ARGS: the port's ``synthetic`` and
    ``generate``), :func:`run_clis` with the flags ``argv``, then for the
    printed train-step values, the validation values and the test CLI's
    ``predict.txt`` row, the largest distance between the packages and
    the rtol that distance needs beside ATOL: ``max((|port - jax| - ATOL)
    / |jax|)``. ``--compute_dtype bfloat16`` alone measures the bf16 CLIs
    under JAX's default flags, whose train steps take its padded scan."""
    jax.config.update("jax_platforms", "cpu")

    with tempfile.TemporaryDirectory(prefix="cli_gap_") as tmp:
        raw, data = os.path.join(tmp, "raw"), os.path.join(tmp, "data")
        synthetic.main(["--out", raw] + CORPUS_ARGS)
        generate.main(["--rawdata_path", raw, "--data_save_path", data,
                       "--map_size", "16"])
        dirs = {name: os.path.join(tmp, f"{name}_mdl")
                for name in ("jax", "port")}
        run_clis(data, list(argv), dirs)
        lines = {name: _train_lines(mdl) for name, mdl in dirs.items()}
        rows = {}
        for name, mdl in dirs.items():
            with open(os.path.join(mdl, "predict.txt")) as f:
                rows[name] = [float(x) for x in f.read().split()]
    if [s for s, _ in lines["port"]] != [s for s, _ in lines["jax"]]:
        raise SystemExit("the two train CLIs printed different lines")
    groups = {"train steps": ([], []), "validation": ([], [])}
    for (line, a), (_s, b) in zip(lines["port"], lines["jax"]):
        group = groups["train steps" if line.startswith("e") else
                       "validation"]
        group[0].extend(a)
        group[1].extend(b)
    groups["test CLI row"] = (rows["port"], rows["jax"])
    print(f"flags {' '.join(argv) or '(default)'}; atol {ATOL}")
    for name, (a, b) in groups.items():
        worst, need = _gap(a, b, ATOL)
        print(f"  {name}: {len(b)} values, largest distance {worst:.6g}, "
              f"needs rtol {need:.6g}")
