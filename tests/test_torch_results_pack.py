"""The port's results pack (``scripts/results_pack_torch.py``) on the CPU:
a short run of one config writes its summary, predictions and a
RESULTS.md row beside the JAX package's committed row; its train CLI
starts from ``model_from_options(--seed)``'s weights, where the
committed card pack started; every committed config of the card pack
(``results_torch/``) starts where the JAX package's committed pack
(``results/``) does, since both draw a seed's weights alike; its log
parser finds every batch line and refuses a log without numbers."""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from prtp_tpu_torch.data.dataset import load_single_design
from prtp_tpu_torch.models.fusion import model_from_options
from prtp_tpu_torch.options import get_options

import _torch_threads  # noqa: F401  (one torch thread a worker)

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
    committed card pack's (``results_torch/``, run under another
    PyTorch), within the rtol phase 15 of chip_smoke.py holds the card to
    and the half unit of its 3-decimal print. A seed's weights must not
    depend on PyTorch or on the device: they are the JAX package's,
    drawn on the host (``utils/convert.py::init_from_seed``)."""
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


@pytest.mark.parametrize("config", [c[0] for c in pack.CONFIGS])
def test_committed_card_pack_starts_where_the_jax_pack_does(config):
    """Each config of the committed card pack (``results_torch/``) has the
    JAX package's committed pack's first per-batch loss (``results/``),
    within rtol 1e-3 and half the unit of the 3-decimal print: both train
    CLIs draw ``--seed``'s weights alike and see the same first batch."""
    rows = []
    for root in ("results_torch", "results"):
        with open(os.path.join(REPO, root, config, "summary.json")) as f:
            rows.append(json.load(f))
    card, jax = rows
    assert card["device"].startswith("NVIDIA") and card["epochs"] == 150
    assert abs(card["first_loss"] - jax["first_loss"]) <= (
        1e-3 * abs(jax["first_loss"]) + 5e-4), (card["first_loss"],
                                                jax["first_loss"])


@pytest.mark.parametrize("first, jax_first, misses", [
    (18.902944564819336, 18.903, False),   # the print's rounding
    (505.97, 505.47, False),               # within 1e-3 of it
    (0.0005, 0.001, False),                # within half the print's unit
    (506.0, 505.47, True),
    (1.101, 18.903, True),                 # another init's first loss
    (1.101, None, False),                  # JAX has no row
])
def test_start_gap_names_a_first_loss_not_jax(first, jax_first, misses):
    jax = None if jax_first is None else {
        "first_loss": jax_first, "final": {"r2": 1.0, "f1": 1.0}}
    gap = pack.start_gap(first, jax)
    assert bool(gap) == misses, gap
    row = {"first_loss": first, "last_loss": 0.0, "name": "reg_x",
           "final": {"r2": 1.0, "f1": 1.0}}
    assert (gap in pack.findings(row, jax)) if misses else not any(
        "first loss" in f for f in pack.findings(row, jax))


def test_pack_keeps_the_final_state_and_its_digests(pack_run):
    """The trace keeps the state the train CLI ended in (the weights and
    flat Adam's moments after its last step), and the summary the
    digests of every step's metrics and of that state, by which two
    packs are compared bit for bit."""
    root, _stdout = pack_run
    trace = str(root / "work" / f"{CONFIG}_trace")
    start, steps = pack.read_trace(trace)
    final = pack.read_final(trace)
    with open(root / "out" / CONFIG / "summary.json") as f:
        summary = json.load(f)
    assert sorted(final["model"]) == sorted(start)
    assert not all(torch.equal(final["model"][k], start[k]) for k in start)
    n = sum(v.numel() for k, v in final["model"].items()
            if not k.endswith(("running_mean", "running_var")))
    assert final["optimizer"]["mu"].shape == (n,)
    assert final["optimizer"]["count"] == len(steps) == summary["steps"]
    assert summary["last_loss_exact"] == steps[-1]["loss"]
    assert summary["steps_sha256"] == pack.steps_digest(steps)
    assert summary["final_sha256"] == pack.state_digest(final)
    final["optimizer"]["nu"][0] += 1.0
    assert pack.state_digest(final) != summary["final_sha256"]


@pytest.mark.parametrize("change", [None, "steps_sha256", "final_sha256"])
def test_compare_says_whether_two_packs_repeat(pack_run, tmp_path, change):
    """``--compare A B`` trains nothing: exit 0 and ``"repeat": true``
    where every config's digests agree, else exit 1 naming the config
    and the digest that differs."""
    root, _stdout = pack_run
    other = tmp_path / "other"
    shutil.copytree(root / "out", other)
    if change:
        path = other / CONFIG / "summary.json"
        summary = json.loads(path.read_text())
        summary[change] = "0" * 64
        path.write_text(json.dumps(summary))
    proc = subprocess.run(
        [sys.executable, PACK, "--compare", str(root / "out"), str(other)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    said = json.loads(proc.stdout.splitlines()[-1])
    assert proc.returncode == (1 if change else 0), proc.stderr
    assert said["repeat"] is (change is None)
    assert [d.split(",")[0] for d in said["differ"]] == (
        [f"{CONFIG}: {change} differs"] if change else [])


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
