"""The port's CLIs on the CPU: the flag surface against the JAX
package's, the synthetic -> generate -> train -> resume -> test flow,
the torch checkpoint format and its round trip through FlatAdam's views.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from prtp_tpu.options import get_options as jax_get_options
from prtp_tpu.train import next_val_trigger as jax_next_val_trigger
from prtp_tpu_torch import test as test_mod
from prtp_tpu_torch import train as train_mod
from prtp_tpu_torch.data import generate, synthetic
from prtp_tpu_torch.data.random_design import make_random_design
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models import PathModel
from prtp_tpu_torch.options import get_options
from prtp_tpu_torch.trainer import (init_state, make_optimizer, pad_batch,
                                    train_step)
from prtp_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_e2e.py's widths
MAP_ARGS = ["--map_size", "16", "--cnn_outdim", "8", "--out_dim", "16",
            "--hidden_dim", "32", "--batch_size", "4",
            "--cell_feat_dim", "13", "--net_feat_dim", "3"]
TRAIN_ARGS = ["--num_epoch", "1", "--max_steps", "3", "--val_interval", "2"]


# ---- the flag surface ----

def test_options_match_jax_keys_and_defaults():
    port, jax = vars(get_options([])), vars(jax_get_options([]))
    assert set(port) == set(jax)
    for key in port:
        if key != "compile_cache_dir":
            assert port[key] == jax[key], key
    assert port["compile_cache_dir"] == ""


def test_unknown_compute_dtype_is_refused(tmp_path):
    """``--compute_dtype`` takes float32 or bfloat16, as in the JAX
    package: another value stops at the parser, before anything runs."""
    assert get_options(["--compute_dtype", "bfloat16"]).compute_dtype == \
        "bfloat16"
    for bad in ("float16", "bf16"):
        with pytest.raises(SystemExit):
            get_options(["--compute_dtype", bad])
        with pytest.raises(SystemExit):
            train_mod.main(["--compute_dtype", bad, "--model_saving_dir",
                            str(tmp_path)], device="cpu")
    assert not os.listdir(tmp_path)


def test_no_op_flags_are_accepted_and_bad_task_is_refused():
    get_options(["--exact_levels", "--scan_groups", "0", "--gnn_unroll", "0",
                 "--compile_cache_dir", "/x", "--pallas", "--flat_adam",
                 "--balanced", "--data_info_txt", "i", "--data_usage", "u"])
    with pytest.raises(ValueError, match="--task"):
        get_options(["--task", "rank"])


@pytest.mark.parametrize("vi", [1, 7, 50])
def test_next_val_trigger_matches_jax(vi):
    for num_batch in range(1, 201):
        for bidx in range(num_batch):
            assert (train_mod.next_val_trigger(bidx, num_batch, vi)
                    == jax_next_val_trigger(bidx, num_batch, vi))


def test_gpu_index_needs_a_card():
    with pytest.raises(SystemExit, match="--gpu 1"):
        train_mod.select_device(get_options(["--gpu", "1"]), "cpu")
    assert train_mod.select_device(get_options([]), "cpu").type == "cpu"


def test_train_module_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card, so the CUDA default is valid")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "prtp_tpu_torch.train",
         "--model_saving_dir", str(tmp_path / "m")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert not (tmp_path / "m").exists()


# ---- synthetic -> generate -> train -> resume -> test ----

@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """The port's own four CLIs on a two-design corpus, on the CPU; the
    train CLI twice (the second run resumes)."""
    raw = str(tmp_path_factory.mktemp("raw"))
    data = str(tmp_path_factory.mktemp("data"))
    mdl = str(tmp_path_factory.mktemp("mdl"))
    synthetic.main(["--out", raw, "--designs", "syn_a", "syn_b",
                    "--num_paths", "6", "--depth", "4", "--cnn_hw", "64"])
    generate.main(["--rawdata_path", raw, "--data_save_path", data,
                   "--map_size", "16"])
    args = (["--data_save_path", data, "--model_saving_dir", mdl]
            + TRAIN_ARGS + MAP_ARGS)
    first = train_mod.main(args, device="cpu")
    with open(os.path.join(mdl, "stdout.log")) as f:
        first_log = f.read()
    second = train_mod.main(args, device="cpu")
    result = test_mod.main(["--data_save_path", data,
                            "--model_saving_dir", mdl] + MAP_ARGS,
                           device="cpu")
    return dict(raw=raw, data=data, mdl=mdl, args=args, first=first,
                second=second, first_log=first_log, result=result)


def test_flow_generates_the_dataset(flow):
    files = sorted(os.listdir(flow["data"]))
    assert {"syn_a.npz", "syn_b.npz", "traindata_list.txt",
            "testdata_list.txt"} <= set(files)
    from prtp_tpu_torch.native import native_available
    assert native_available()


def test_parsed_designs_have_no_prior_rows(flow):
    """The parser puts a net sink one level after its one driver, so no
    net level of a parsed design has a prior row (a driver below the
    pair's cell level), and the walk never launches gather_rows."""
    from prtp_tpu_torch.data.dataset import load_design_npz
    for design in ("syn_a", "syn_b"):
        graph = pack_design(load_design_npz(os.path.join(
            flow["data"], f"{design}.npz")), map_size=16, device="cpu").graph
        assert graph.num_pairs > 1
        for k in range(graph.num_pairs):
            assert graph.gather_rows[k].numel() == \
                graph.cell_mail[k].numel(), (design, k)


def test_flow_train_writes_checkpoint_config_and_log(flow):
    mdl = flow["mdl"]
    for name in ("model.pt", "config.json", "stdout.log", "stderr.log"):
        assert os.path.exists(os.path.join(mdl, name)), name
    assert not os.path.exists(os.path.join(mdl, "model.pt.tmp"))
    with open(os.path.join(mdl, "config.json")) as f:
        config = json.load(f)
    assert set(config) == set(vars(jax_get_options([])))
    assert config["cell_feat_dim"] == 13 - 6  # after --feat_reduce
    log = flow["first_log"]
    assert "creating model in:" in log
    assert "Start training" in log
    assert "e0,syn_a,b0/" in log and "validate:" in log
    assert "Saving model.... " in log and "max_steps 3 reached" in log
    assert flow["first"].step == 3


def test_flow_resumes(flow):
    mdl = flow["mdl"]
    with open(os.path.join(mdl, "seed.txt")) as f:
        assert f.read() == "9294" * 2  # two seeds appended
    with open(os.path.join(mdl, "stdout.log")) as f:
        log = f.read()
    assert log.startswith(flow["first_log"])
    resumed = log[len(flow["first_log"]):]
    assert ("----------------Loading the model and hyper-parameters"
            "----------------") in resumed
    # the step count and the best R² came back with the checkpoint: the
    # first run's last save followed its batch line of step `saved`, and
    # the second run took 3 steps more from there
    before_save = flow["first_log"].rsplit("Saving model.... ", 1)[0]
    saved = len(re.findall(r"^e\d+,\S+,b\d+/\d+, ", before_save, re.M))
    assert flow["first"].step == 3 and 1 <= saved <= 3
    assert flow["second"].step == saved + 3
    assert flow["second"].best_r2 >= flow["first"].best_r2


def test_flow_test_writes_predictions(flow):
    mdl = flow["mdl"]
    with open(os.path.join(mdl, "predict.txt")) as f:
        rows = [r.split() for r in f.read().strip().splitlines()]
    assert len(rows) == 1 and len(rows[0]) == 6
    res, _f1, r2, preds = flow["result"]
    assert len(res) == 2 and float(rows[0][1]) == pytest.approx(r2, abs=1e-3)
    for design in ("syn_a", "syn_b"):
        with open(os.path.join(mdl, "predict_critical",
                               f"{design}.json")) as f:
            crit = json.load(f)
        assert all(0 <= i < len(preds[design]) for i in crit)
        assert np.all(np.isfinite(preds[design]))
    assert sorted(os.listdir(os.path.join(mdl, "visual"))) == ["0.png",
                                                              "1.png"]


def test_steps_per_dispatch_and_debug_options_keep_the_run(flow, tmp_path):
    """From one checkpoint, chunks of 1 and of 3 steps print the same
    lines; --debug_nans runs under anomaly detection and restores it,
    --profile_dir writes a trace."""
    logs = {}
    for spd, extra in (("1", []), ("3", ["--debug_nans", "--profile_dir",
                                         str(tmp_path / "prof")])):
        mdl = str(tmp_path / f"spd{spd}")
        shutil.copytree(flow["mdl"], mdl)
        os.remove(os.path.join(mdl, "stdout.log"))
        args = [a if a != flow["mdl"] else mdl for a in flow["args"]]
        train_mod.main(args + ["--steps_per_dispatch", spd] + extra,
                       device="cpu")
        with open(os.path.join(mdl, "stdout.log")) as f:
            logs[spd] = [ln.replace(mdl, "MDL")
                         for ln in f.read().splitlines()
                         if not ln.startswith("Namespace")]
    assert logs["1"] == logs["3"]
    assert any(ln.startswith("e0,syn_b,b0/") for ln in logs["1"])
    assert not torch.is_anomaly_enabled()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_merge_designs_is_accepted_and_trains(flow, tmp_path):
    """``--merge_designs`` trains the two designs as one super-graph, the
    unit ``syn_a+syn_b``, validating per design; it resumes from a
    checkpoint written without the flag, and a run without it resumes
    from its checkpoint (the parameters do not depend on the designs)."""
    assert get_options(["--merge_designs"]).merge_designs
    mdl = str(tmp_path / "mdl")
    shutil.copytree(flow["mdl"], mdl)
    os.remove(os.path.join(mdl, "stdout.log"))
    args = [a if a != flow["mdl"] else mdl for a in flow["args"]]
    merged = train_mod.main(args + ["--merge_designs"], device="cpu")
    with open(os.path.join(mdl, "stdout.log")) as f:
        log = f.read()
    assert "Loading the model and hyper-parameters" in log
    steps = [ln for ln in log.splitlines() if ln.startswith("e0,")]
    assert [ln[:len("e0,syn_a+syn_b,b0/3")] for ln in steps] == [
        f"e0,syn_a+syn_b,b{b}/3" for b in range(3)]
    assert "\tcase 1 \tl:" in log and "max_steps 3 reached" in log
    again = train_mod.main(args + ["--max_steps", "1"], device="cpu")
    assert again.step > 0


@pytest.mark.parametrize("change_lr", [False, True])
def test_resume_keeps_the_saved_learning_rate_unless_changed(flow, tmp_path,
                                                            change_lr):
    mdl = str(tmp_path / "mdl")
    shutil.copytree(flow["mdl"], mdl)
    args = [a if a != flow["mdl"] else mdl for a in flow["args"]]
    args += ["--learning_rate", "0.5", "--max_steps", "1"]
    state = train_mod.main(args + (["--change_lr"] if change_lr else []),
                           device="cpu")
    assert state.optimizer.lr == (0.5 if change_lr else 1e-3)


def test_clis_turn_tf32_off(flow, tmp_path):
    """train.main and test.main compute in float32, whatever the caller's
    TF32 settings: both flags are False after each CLI ran with them True
    (cuDNN's is True by PyTorch's default)."""
    mdl = str(tmp_path / "mdl")
    shutil.copytree(flow["mdl"], mdl)
    args = [a if a != flow["mdl"] else mdl for a in flow["args"]]
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for run in (
                lambda: train_mod.main(args + ["--max_steps", "1"],
                                       device="cpu"),
                lambda: test_mod.main(["--data_save_path", flow["data"],
                                       "--model_saving_dir", mdl] + MAP_ARGS,
                                      device="cpu")):
            for f in flags:
                f.allow_tf32 = True
            run()
            assert [f.allow_tf32 for f in flags] == [False, False]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


# ---- the checkpoint format ----

def test_bf16_checkpoint_evaluates_in_either_dtype(flow, tmp_path,
                                                   monkeypatch):
    """``--compute_dtype bfloat16``: the train CLI packs its designs in
    bf16 and records the dtype in config.json as JAX does; model.pt holds
    float32 parameters (and Adam's moments), so the test CLI evaluates
    the checkpoint in float32 and in bf16, packing float32 either way.
    The two give finite predictions of every design within 5e-2 of their
    largest |value| of each other (bf16 keeps 8 bits)."""
    packed = {}

    def recording(module):
        real = module.pack_design

        def pack(parsed, *args, **kwargs):
            packed.setdefault(module.__name__, set()).add(
                kwargs.get("compute_dtype", torch.float32))
            return real(parsed, *args, **kwargs)
        return pack

    mdl = str(tmp_path / "mdl")
    bf16 = ["--compute_dtype", "bfloat16"]
    monkeypatch.setattr(train_mod, "pack_design", recording(train_mod))
    monkeypatch.setattr(test_mod, "pack_design", recording(test_mod))
    train_mod.main(["--data_save_path", flow["data"], "--model_saving_dir",
                    mdl] + TRAIN_ARGS + MAP_ARGS + bf16, device="cpu")
    assert packed.pop(train_mod.__name__) == {torch.bfloat16}
    with open(os.path.join(mdl, "config.json")) as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    blob = torch.load(os.path.join(mdl, "model.pt"), weights_only=True)
    assert all(t.dtype == torch.float32 for t in blob["model"].values())
    assert blob["optimizer"]["mu"].dtype == torch.float32
    preds = {}
    for dtype in ("float32", "bfloat16"):
        preds[dtype] = test_mod.main(
            ["--data_save_path", flow["data"], "--model_saving_dir", mdl,
             "--compute_dtype", dtype] + MAP_ARGS, device="cpu")[3]
    assert packed[test_mod.__name__] == {torch.float32}
    assert sorted(preds["float32"]) == sorted(preds["bfloat16"])
    for design, want in preds["float32"].items():
        got = preds["bfloat16"][design]
        assert np.all(np.isfinite(got)) and got.shape == want.shape
        assert not np.array_equal(got, want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-2 * np.abs(want).max())


def test_jax_checkpoint_alone_raises(flow, tmp_path):
    mdl = tmp_path / "jax_mdl"
    mdl.mkdir()
    (mdl / "model.msgpack").write_bytes(b"\x80")
    (mdl / "config.json").write_text("{}")
    with pytest.raises(FileExistsError, match="model.msgpack.*model.pt"):
        ckpt.checkpoint_exists(str(mdl))
    args = ["--data_save_path", flow["data"], "--model_saving_dir",
            str(mdl)] + TRAIN_ARGS + MAP_ARGS
    with pytest.raises(FileExistsError):
        train_mod.main(args, device="cpu")
    with pytest.raises(FileExistsError):
        test_mod.main(args, device="cpu")
    assert (mdl / "config.json").read_text() == "{}"
    assert not (mdl / "model.pt").exists()


def _small_state(seed):
    model = PathModel(10, 3, out_dim=8, hidden_dim=8, cnn_outdim=4,
                      map_size=8, global_dim=4,
                      generator=torch.Generator().manual_seed(seed))
    return init_state(model, make_optimizer(1e-3), device="cpu")


def _inside_flat(state):
    """Every parameter lies inside FlatAdam's flat buffer, and its
    gradient inside the flat gradient, at the same offset."""
    opt = state.optimizer
    size = opt.flat.numel() * opt.flat.element_size()
    for p in state.model.parameters():
        off = p.data_ptr() - opt.flat.data_ptr()
        if not (0 <= off < size
                and p.grad.data_ptr() - opt.grad.data_ptr() == off):
            return False
    return True


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    """Save after a step, load into a fresh state: parameters, moments,
    counts and best metrics come back exactly, every parameter stays a
    view of FlatAdam's flat buffer, and one more step on each gives
    bit-equal parameters."""
    parsed = make_random_design([6, 8, 6, 8, 6], cell_feat_dim=10,
                                map_size=8, cnn_hw=32, mask_nnz_per_path=4,
                                seed=3)
    design = pack_design(parsed, map_size=8, device="cpu")
    ids, mask = pad_batch(np.arange(design.num_paths), design.num_paths,
                          "cpu")
    state = _small_state(1)
    train_step(state, design, ids, mask)
    state.best_f1, state.best_r2 = 0.25, 0.5
    path = ckpt.save_checkpoint(str(tmp_path), state, {"learning_rate": 1e-3})
    assert path == str(tmp_path / "model.pt") and ckpt.checkpoint_exists(
        str(tmp_path))
    fresh, config = ckpt.load_checkpoint(str(tmp_path), _small_state(2))
    assert config == {"learning_rate": 1e-3}
    assert (fresh.step, fresh.best_f1, fresh.best_r2) == (1, 0.25, 0.5)
    assert fresh.optimizer.count == state.optimizer.count == 1
    for key in ("flat", "mu", "nu"):
        assert torch.equal(getattr(fresh.optimizer, key),
                           getattr(state.optimizer, key)), key
    assert _inside_flat(fresh)
    before = fresh.optimizer.flat.clone()
    train_step(state, design, ids, mask)
    train_step(fresh, design, ids, mask)
    assert _inside_flat(fresh)
    assert not torch.equal(fresh.optimizer.flat, before)
    for (key, a), b in zip(state.model.state_dict().items(),
                           fresh.model.state_dict().values()):
        assert torch.equal(a, b), key
    assert torch.equal(fresh.optimizer.mu, state.optimizer.mu)


def test_checkpoint_round_trip_keeps_batchnorm_averages(tmp_path):
    """The U-Net's BatchNorm running averages are buffers, outside
    FlatAdam: a step moves them, ``model.pt`` carries them, a load into a
    fresh state restores them bit-equal, and one more step on each gives
    bit-equal parameters and averages."""
    parsed = make_random_design([6, 8, 6, 8, 6], cell_feat_dim=10,
                                map_size=8, cnn_channels=3, cnn_hw=16,
                                mask_nnz_per_path=4, seed=3)
    design = pack_design(parsed, map_size=8, device="cpu")
    ids, mask = pad_batch(np.arange(design.num_paths), design.num_paths,
                          "cpu")

    def unet_state(seed):
        model = PathModel(10, 3, out_dim=8, hidden_dim=8, cnn_outdim=4,
                          map_size=8, global_dim=4, unet=True,
                          cnn_channels=3,
                          generator=torch.Generator().manual_seed(seed))
        return init_state(model, make_optimizer(1e-3), device="cpu")

    state = unet_state(1)
    train_step(state, design, ids, mask)
    avgs = {k: v for k, v in state.model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}
    assert len(avgs) == 28
    assert not torch.equal(avgs["cnn.DoubleConv_0.BatchNorm_0.running_mean"],
                           torch.zeros(16))
    ckpt.save_checkpoint(str(tmp_path), state, {})
    fresh, _c = ckpt.load_checkpoint(str(tmp_path), unet_state(2))
    for key, val in avgs.items():
        assert torch.equal(fresh.model.state_dict()[key], val), key
    assert _inside_flat(fresh)
    train_step(state, design, ids, mask)
    train_step(fresh, design, ids, mask)
    for (key, a), b in zip(state.model.state_dict().items(),
                           fresh.model.state_dict().values()):
        assert torch.equal(a, b), key


def test_flat_adam_refuses_moments_of_another_model():
    state = _small_state(1)
    with pytest.raises(ValueError, match="mu"):
        state.optimizer.load_state_dict({"mu": torch.zeros(3),
                                         "nu": torch.zeros(3), "count": 1})
