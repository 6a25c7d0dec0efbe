"""The port's results pack (``scripts/results_pack_torch.py``) on the CPU:
a short run of one config writes its summary, predictions and a
RESULTS.md row beside the JAX package's committed row; its train CLI
starts from ``model_from_options(--seed)``'s weights, where the
committed card pack started; its log parser finds every batch line and
refuses a log without numbers."""

import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from prtp_tpu_torch.data.dataset import load_single_design
from prtp_tpu_torch.models.fusion import model_from_options
from prtp_tpu_torch.options import get_options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACK = os.path.join(REPO, "scripts", "results_pack_torch.py")
EPOCHS, CONFIG = 2, "reg_fusion"

_spec = importlib.util.spec_from_file_location("results_pack_torch", PACK)
pack = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pack)


@pytest.fixture(scope="module")
def pack_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("pack")
    proc = subprocess.run(
        [sys.executable, PACK, "--device", "cpu", "--epochs", str(EPOCHS),
         "--configs", CONFIG, "--work", str(root / "work"), "--out",
         str(root / "out")], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return root, proc.stdout


def test_pack_writes_summary_predictions_and_row_beside_jax(pack_run):
    root, stdout = pack_run
    keep = root / "out" / CONFIG
    with open(keep / "summary.json") as f:
        summary = json.load(f)
    assert summary["name"] == CONFIG and summary["epochs"] == EPOCHS
    assert summary["device"] == "CPU (plain PyTorch versions)"
    assert sorted(summary["final"]) == sorted(pack.METRICS)
    assert len(summary["eval_runtimes"]) == 3  # the corpus's 3 designs
    assert json.loads(stdout.splitlines()[0]) == summary
    rows = (keep / "predict.txt").read_text().strip().splitlines()
    assert [float(x) for x in rows[-1].split()] == [
        summary["final"][k] for k in pack.METRICS]
    assert (keep / "config.json").exists()
    md = (root / "out" / "RESULTS.md").read_text()
    with open(os.path.join(REPO, "results", CONFIG, "summary.json")) as f:
        jax = json.load(f)["final"]
    assert pack._row(f"{CONFIG} `(default)`, port", summary["final"]) in md
    assert pack._row(f"{CONFIG}, JAX (results/)", jax) in md
    assert f"on {summary['device']}" in md


def test_train_cli_starts_from_the_seed_where_the_card_started(pack_run):
    """The train CLI's starting weights, read back from the checkpoint it
    writes at creation (the pack's trace), are ``model_from_options
    (--seed)``'s; and its first loss, on batch 0 before any update, is the
    committed card pack's (``results_torch/``, drawn under another
    PyTorch), within the rtol phase 15 of chip_smoke.py holds the card to
    and the half unit of its 3-decimal print. A seed's weights must not
    depend on PyTorch's own truncated-normal sampler, which draws other
    values from 2.13 on (``models/mlp.py::lecun_normal_``)."""
    root, _stdout = pack_run
    work = root / "work"
    weights, steps = pack.read_trace(str(work / f"{CONFIG}_trace"))
    options = get_options(pack.train_args(str(work / "data_L"), "-", 16, [],
                                          EPOCHS))
    parsed = load_single_design("train", str(work / "data_L"), "syn_a",
                                feat_reduce=options.feat_reduce)
    want = model_from_options(options, parsed["cell_feat"].shape[1],
                              parsed["net_feat"].shape[1],
                              parsed["cnn_input"].shape[-3]).state_dict()
    assert sorted(weights) == sorted(want)
    for key in want:
        assert torch.equal(weights[key], want[key]), key
    with open(os.path.join(REPO, "results_torch", CONFIG,
                           "summary.json")) as f:
        card = json.load(f)
    assert card["device"].startswith("NVIDIA")
    assert abs(steps[0]["loss"] - card["first_loss"]) <= (
        1e-3 * abs(card["first_loss"]) + 5e-4), (steps[0], card["first_loss"])


def test_parse_curve_finds_every_batch_line(pack_run):
    root, _stdout = pack_run
    log = root / "work" / CONFIG / "stdout.log"
    batches, vals = pack.parse_curve(str(log))
    text = log.read_text()
    per_epoch = sum(int(n) for n in re.findall(r"^e0,\S+,b0/(\d+), ", text,
                                               re.M))
    assert per_epoch >= 3  # a batch or more a design
    assert len(batches) == EPOCHS * per_epoch
    assert sorted({e for e, _l, _r in batches}) == list(range(EPOCHS))
    assert vals and all(len(v) == 3 for v in vals)


@pytest.mark.parametrize("text", [
    "e0,syn_a,b0/1, l:nan, r2:nan, r:0.000, F1:0.000\n",
    "e0,syn_a,b0/1, l:1.000, r2:0.500, r:0.000, F1:0.000\n"
    "e1,syn_a,b0/1, l:nan, r2:nan, r:0.000, F1:0.000\n",
    "----------------Start training---------------\n",
], ids=["nan", "nan_after_numbers", "no_batch_line"])
def test_parse_curve_raises_without_numeric_batch_lines(tmp_path, text):
    log = tmp_path / "stdout.log"
    log.write_text(text)
    with pytest.raises(ValueError, match="batch lines hold numbers"):
        pack.parse_curve(str(log))
