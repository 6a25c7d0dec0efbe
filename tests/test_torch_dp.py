"""Data parallelism in the port (``--dp``, ``--mesh_shape``), on the CPU
with gloo: the port's counterparts of ``tests/test_dp_cli.py``,
``tests/test_distributed.py`` and ``tests/test_multihost.py``.

The port runs one process a rank (JAX: one process, a mesh of its
devices), the batch split into contiguous blocks, the gradients summed
by one all-reduce. A summed gradient is taken in another order than one
rank's, so data-parallel values equal the single-rank ones within
float32 rounding: the printed values are held at rtol 1e-4, atol 1e-5,
as ``test_dp_cli.py`` holds JAX's; JAX's ``--dp`` runs start from the
same state (converted) and are held at the same bounds.
"""

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from prtp_tpu import test as jax_test
from prtp_tpu import train as jax_train
from prtp_tpu_torch import test as test_mod
from prtp_tpu_torch import train as train_mod
from prtp_tpu_torch.data import generate, synthetic
from prtp_tpu_torch.data.random_design import make_random_design
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models import PathModel
from prtp_tpu_torch.parallel import (Mesh, maybe_initialize,
                                     mesh_from_options, requested_ranks,
                                     run_ranks)
from prtp_tpu_torch.parallel.dp import dp_evaluate, dp_train_step, shard_batch
from prtp_tpu_torch.parallel.distributed import free_port
from prtp_tpu_torch.test import evaluate
from prtp_tpu_torch.trainer import (init_state, make_optimizer, pad_batch,
                                    train_step)

from test_torch_cli import MAP_ARGS
from _cli_parity import save_initial_states

import _torch_threads  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_dp_child.py")
# test_dp_cli.py's run: 4 steps, validation only at the designs' ends
TRAIN_ARGS = ["--num_epoch", "1", "--max_steps", "4", "--val_interval",
              "100"]
DP4 = ["--dp", "--mesh_shape", "4"]
RTOL, ATOL = 1e-4, 1e-5
_LOSS = re.compile(r"b\d+/\d+, l:([0-9.]+),")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """test_dp_cli.py's corpus, by the port's synthetic and generate."""
    raw = str(tmp_path_factory.mktemp("raw"))
    data = str(tmp_path_factory.mktemp("data"))
    synthetic.main(["--out", raw, "--designs", "syn_a", "syn_b",
                    "--num_paths", "6", "--depth", "4", "--cnn_hw", "64",
                    "--cnn_channels", "2"])
    generate.main(["--rawdata_path", raw, "--data_save_path", data,
                   "--map_size", "16"])
    return data


def _log(mdl):
    with open(os.path.join(mdl, "stdout.log")) as f:
        return f.read()


def _losses(mdl):
    losses = [float(x) for x in _LOSS.findall(_log(mdl))]
    assert losses, _log(mdl)
    return np.array(losses)


def _row(mdl):
    with open(os.path.join(mdl, "predict.txt")) as f:
        return np.array([float(x) for x in f.readlines()[-1].split()])


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """From one initial state (JAX's, converted): JAX's train and test
    CLIs with ``--dp --mesh_shape 4``, the port's with it, and the
    port's on one rank."""
    dirs = {name: str(tmp_path_factory.mktemp(name))
            for name in ("jax", "port_dp", "port_single")}
    args = ["--data_save_path", corpus] + TRAIN_ARGS + MAP_ARGS
    save_initial_states(corpus, args, dirs)
    test_args = ["--data_save_path", corpus] + MAP_ARGS
    jax_train.main(args + DP4 + ["--model_saving_dir", dirs["jax"]])
    jax_test.main(test_args + DP4 + ["--model_saving_dir", dirs["jax"]])
    for name, flags in (("port_dp", DP4), ("port_single", [])):
        out = train_mod.main(args + flags + ["--model_saving_dir",
                                             dirs[name]], device="cpu")
        assert (out is None) == bool(flags)
        test_mod.main(test_args + flags + ["--model_saving_dir",
                                           dirs[name]], device="cpu")
    return dirs


def test_dp_train_cli_matches_single_rank(runs):
    """``--dp --mesh_shape 4`` on 4 CPU ranks: the same per-batch losses
    as one rank, the mesh line printed, rank 0 alone writing the log."""
    log = _log(runs["port_dp"])
    assert "--- data-parallel mesh: 4 x cpu devices, batch_size 4" in log
    assert log.count("----------------Start training") == 1
    single, dp = _losses(runs["port_single"]), _losses(runs["port_dp"])
    assert len(dp) == len(single) == 4
    np.testing.assert_allclose(dp, single, rtol=RTOL, atol=ATOL)


def test_dp_train_cli_matches_jax_dp(runs):
    """The port's ``--dp --mesh_shape 4`` losses against JAX's, from the
    same initial state."""
    np.testing.assert_allclose(_losses(runs["port_dp"]),
                               _losses(runs["jax"]), rtol=RTOL, atol=ATOL)


def test_dp_writes_once(runs):
    """Rank 0 alone writes the seed file, the config (with the flags)
    and the checkpoint, which loads."""
    mdl = runs["port_dp"]
    with open(os.path.join(mdl, "seed.txt")) as f:
        assert f.read() == "9294"
    with open(os.path.join(mdl, "config.json")) as f:
        config = json.load(f)
    assert config["dp"] is True and config["mesh_shape"] == [4]
    assert sorted(os.listdir(mdl)) == sorted(os.listdir(runs["port_single"]))


@pytest.mark.parametrize("want", ["port_single", "jax"])
def test_dp_eval_cli_row(runs, want):
    """The test CLI with ``--dp --mesh_shape 4``: its ``predict.txt`` row
    against the single-rank port's and against JAX's ``--dp`` row (each
    from its own trained checkpoint, which agree as the losses do)."""
    np.testing.assert_allclose(_row(runs["port_dp"]), _row(runs[want]),
                               rtol=RTOL, atol=ATOL)


def test_dp_eval_cli_on_one_checkpoint(runs, tmp_path):
    """The single-rank checkpoint evaluated with ``--dp --mesh_shape 3``
    (each design's paths padded to a multiple of 3): the same
    ``predict.txt`` row and ``predict_critical`` lists as its own
    single-rank evaluation."""
    mdl = str(tmp_path / "mdl")
    shutil.copytree(runs["port_single"], mdl)
    test_mod.main(["--data_save_path", _data(runs)] + MAP_ARGS
                  + ["--dp", "--mesh_shape", "3", "--model_saving_dir", mdl],
                  device="cpu")
    np.testing.assert_allclose(_row(mdl), _row(runs["port_single"]),
                               rtol=RTOL, atol=ATOL)
    crit = os.path.join(mdl, "predict_critical")
    for name in os.listdir(crit):
        with open(os.path.join(crit, name)) as a, open(os.path.join(
                runs["port_single"], "predict_critical", name)) as b:
            assert a.read() == b.read(), name


def _data(runs):
    with open(os.path.join(runs["port_dp"], "config.json")) as f:
        return json.load(f)["data_save_path"]


def test_merged_dp_matches_single_rank(corpus, tmp_path):
    """``--merge_designs --dp --mesh_shape 2``: each design's ids of the
    grouped ``(K, B)`` batch split over 2 ranks; the losses equal the
    single-rank merged run's."""
    args = (["--data_save_path", corpus, "--merge_designs"] + TRAIN_ARGS
            + MAP_ARGS)
    out = {}
    for name, flags in (("single", []), ("dp", ["--dp", "--mesh_shape",
                                                "2"])):
        mdl = str(tmp_path / name)
        train_mod.main(args + flags + ["--model_saving_dir", mdl],
                       device="cpu")
        out[name] = _losses(mdl)
        assert "e0,syn_a+syn_b," in _log(mdl)
    np.testing.assert_allclose(out["dp"], out["single"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("flags,error,match", [
    (["--mesh_shape", "2", "2"], ValueError, "1-D"),
    (["--dp", "--gpu", "1"], SystemExit, "--gpu 1 with --dp")])
@pytest.mark.parametrize("cli", ["train", "test"])
def test_cli_refuses(flags, error, match, cli, tmp_path):
    """A 2-D ``--mesh_shape`` and ``--gpu`` with ``--dp`` are refused
    before anything is written."""
    mod = train_mod if cli == "train" else test_mod
    with pytest.raises(error, match=match):
        mod.main(flags + ["--model_saving_dir", str(tmp_path)],
                 device="cpu")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags,want", [
    ([], None), (["--dp"], 1), (["--mesh_shape", "3"], 3),
    (["--dp", "--mesh_shape", "2"], 2)])
def test_requested_ranks(flags, want):
    """``--dp`` alone is one rank on the CPU (every card on CUDA);
    ``--mesh_shape N`` is N ranks; neither is no mesh."""
    options = argparse.Namespace(dp="--dp" in flags,
                                 mesh_shape=([int(flags[-1])]
                                             if "--mesh_shape" in flags
                                             else None))
    assert requested_ranks(options, "cpu") == want
    if want is None:
        assert mesh_from_options(options, "cpu") is None


def test_more_ranks_than_cards_are_refused():
    if torch.cuda.device_count() >= 64:
        pytest.skip("this host has 64 cards")
    options = argparse.Namespace(dp=True, mesh_shape=[64])
    with pytest.raises(RuntimeError, match="need 64 CUDA cards"):
        requested_ranks(options, "cuda")


@pytest.mark.parametrize("shape", [(10,), (3, 7)])
@pytest.mark.parametrize("size", [1, 3, 4])
def test_shard_batch_is_jax_dp_layout(shape, size):
    """Rank r holds the r-th contiguous block of the last axis, padded
    with masked entries to a multiple of the ranks; the blocks in rank
    order are the padded batch."""
    ids = torch.arange(int(np.prod(shape))).reshape(shape) + 1
    mask = torch.ones(shape)
    blocks = [shard_batch(ids, mask, Mesh(size, r)) for r in range(size)]
    b = shape[-1]
    per = -(-b // size)
    assert all(i.shape[-1] == per for i, _m in blocks)
    got = torch.cat([i for i, _m in blocks], dim=-1)
    got_mask = torch.cat([m for _i, m in blocks], dim=-1)
    assert torch.equal(got[..., :b], ids) and not got[..., b:].any()
    assert torch.equal(got_mask[..., :b], mask) and not got_mask[..., b:].any()


def _tiny(task="reg"):
    parsed = make_random_design([16, 24, 16, 8], cell_feat_dim=12,
                                net_feat_dim=3, map_size=16, cnn_hw=64,
                                seed=3)
    design = pack_design(parsed, map_size=16, device="cpu")
    model = PathModel(12, 3, out_dim=16, hidden_dim=32, cnn_outdim=8,
                      map_size=16, global_dim=8,
                      nlabels=2 if task == "cls" else 1,
                      generator=torch.Generator().manual_seed(0))
    ids, mask = pad_batch(np.arange(min(15, design.num_paths)), 16, "cpu")
    return design, model, ids, mask


@pytest.fixture
def group_of_one():
    """A gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    yield Mesh.of_group()
    dist.destroy_process_group()


@pytest.mark.parametrize("task", ["reg", "cls"])
def test_dp_step_of_one_rank_is_train_step(group_of_one, task):
    """At world size 1 the data-parallel step is ``train_step``: the
    same loss, metrics and gradients bit for bit, 3 steps; and the
    data-parallel evaluation is ``evaluate``'s."""
    design, model, ids, mask = _tiny(task)
    states = [init_state(m, make_optimizer(1e-3), "cpu")
              for m in (model, _tiny(task)[1])]
    for _ in range(3):
        want = train_step(states[0], design, ids, mask, task)
        got = dp_train_step(states[1], design, ids, mask, group_of_one, task)
        for key in want:
            assert torch.equal(got[key], want[key]), key
        assert torch.equal(states[1].optimizer.grad, states[0].optimizer.grad)
        assert torch.equal(states[1].optimizer.flat, states[0].optimizer.flat)
    p_want, m_want = evaluate(states[0].model, design, ids, mask, task)
    p_got, m_got = dp_evaluate(states[1].model, design, ids, mask,
                               group_of_one, task)
    assert torch.equal(p_got, p_want)
    for key in m_want:
        assert torch.equal(m_got[key], m_want[key]), key


def _step_losses(options, mesh, dev):
    """A run_ranks body: one data-parallel step; rank 0 records its
    loss beside the model directory."""
    design, model, ids, mask = _tiny()
    state = init_state(model, make_optimizer(1e-3), dev)
    loss = float(dp_train_step(state, design, ids, mask, mesh)["loss"])
    if mesh.rank == 0:
        with open(options.out, "w") as f:
            f.write(f"{mesh.size} {loss!r}")


@pytest.mark.parametrize("flags,world", [(["--dp"], 1),
                                         (["--mesh_shape", "2"], 2)])
def test_run_ranks_starts_the_ranks(flags, world, tmp_path):
    """Without a process group ``run_ranks`` runs one rank here or spawns
    N, each in the group; the step's loss is the one-rank step's."""
    options = argparse.Namespace(dp="--dp" in flags,
                                 mesh_shape=[2] if world == 2 else None,
                                 out=str(tmp_path / "loss"))
    run_ranks(_step_losses, options, "cpu")
    assert not dist.is_initialized()
    with open(options.out) as f:
        size, loss = f.read().split()
    design, model, ids, mask = _tiny()
    state = init_state(model, make_optimizer(1e-3), "cpu")
    want = float(train_step(state, design, ids, mask)["loss"])
    assert int(size) == world
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)


def test_maybe_initialize_noop_without_env(monkeypatch):
    for key in ("PRTP_COORDINATOR", "PRTP_MULTIHOST"):
        monkeypatch.delenv(key, raising=False)
    assert maybe_initialize("cpu") is False
    assert not dist.is_initialized()


def _parse(out):
    m = re.search(r"RESULT rank=(\d+) world=(\d+) loss=(\S+) "
                  r"checksum=(\S+)", out)
    assert m, f"no RESULT line in {out!r}"
    return int(m.group(2)), float(m.group(3)), float(m.group(4))


def _jax_dp_grads(compute_dtype, layout=None):
    """JAX's ``make_dp_train_step`` on a 2-device mesh of the virtual CPU
    mesh, from the children's init (converted): the first step's
    gradients (an SGD(1) step's parameter change), on the padded pack
    (align 8) of the children's design, bf16 in a bf16 model. With
    ``layout`` (a tensor of the layout CNN's output) JAX's ``LayoutNet``
    returns those values instead of its own."""
    import contextlib

    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax
    from prtp_tpu import trainer as jtrainer
    from prtp_tpu.graph import pack_design as jax_pack_design
    from prtp_tpu.models import PathModel as JaxPathModel
    from prtp_tpu.models.layoutnet import LayoutNet
    from prtp_tpu.parallel.dp import make_dp_train_step
    from prtp_tpu.parallel.mesh import make_mesh
    from prtp_tpu_torch.utils.convert import params_from_flax, params_to_flax

    from _torch_dp_child import tiny_inputs

    parsed, _design, model, ids, mask = tiny_inputs()
    jdt = jnp.bfloat16 if compute_dtype else jnp.float32
    design = jax_pack_design(parsed, map_size=16, align=8, compute_dtype=jdt)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    params_to_flax(model.state_dict()))
    jmodel = JaxPathModel(out_dim=16, hidden_dim=32, cnn_outdim=8,
                          map_size=16, global_dim=8,
                          compute_dtype=jdt if compute_dtype else None)
    tx = optax.sgd(1.0)
    state = jtrainer.TrainState(
        params=params, batch_stats={}, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), best_f1=jnp.zeros(()),
        best_r2=jnp.zeros(()))
    step = make_dp_train_step(jmodel, tx, make_mesh(2), donate=False)

    def port_layout(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if not (isinstance(context.module, LayoutNet)
                and context.method_name == "__call__"):
            return out
        return jnp.asarray(layout.float().numpy()).astype(
            out.dtype).reshape(out.shape)

    with (contextlib.nullcontext() if layout is None
          else nn.intercept_methods(port_layout)):
        new, _mets = step(state, design, jnp.asarray(ids.numpy()),
                          jnp.asarray(mask.numpy()))
    return params_from_flax(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
        params, new.params))


@pytest.fixture(scope="module")
def coordinated(tmp_path_factory):
    """One run of two processes joined by ``PRTP_COORDINATOR`` (gloo, the
    CPU) and of one process alone (``_torch_dp_child.py``): each RESULT
    line, and each bf16 step's output; JAX's 2-device dp step's first
    gradients in bf16 and float32, and in bf16 with the port's layout CNN
    output (``"port_layout"``), computed here while they run."""
    out_dir = str(tmp_path_factory.mktemp("coordinated"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PRTP_")}
    env["PYTHONPATH"] = REPO
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, CHILD, *args], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for args in (("0", str(port), out_dir),
                          ("1", str(port), out_dir), ("ref", out_dir))]
    try:
        jax_grads = {dt: _jax_dp_grads(dt) for dt in ("bfloat16", None)}
        jax_grads["port_layout"] = _jax_dp_grads("bfloat16",
                                                 _port_layout_output())
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-2000:]
            outs.append(_parse(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bf16 = [torch.load(os.path.join(out_dir, f"bf16_{tag}.pt"))
            for tag in (0, 1, "ref")]
    return outs, bf16, jax_grads


def test_two_coordinated_processes(coordinated):
    """Two processes joined by ``PRTP_COORDINATOR`` (gloo, the CPU) run
    one data-parallel step: identical losses and parameter checksums (rank
    0's gradient crossed the process boundary), equal to one process's
    ``train_step`` at rtol 1e-5 (loss) and 1e-6 (checksum)."""
    outs = coordinated[0]
    assert outs[0] == outs[1] and outs[0][0] == 2, outs
    world, loss, checksum = outs[2]
    assert world == 1
    np.testing.assert_allclose(outs[0][1], loss, rtol=1e-5)
    np.testing.assert_allclose(outs[0][2], checksum, rtol=1e-6)


# the head's first layer reads the layout branch's output in its columns
# out_dim .. out_dim + cnn_outdim (_torch_dp_child.tiny_inputs: 16, 8)
HEAD, HEAD_CNN_COLUMNS = "mlp_fuse.fc0.weight", np.arange(16, 24)


def _port_layout_output():
    """The port's bf16 layout CNN output on the children's design."""
    from _torch_dp_child import tiny_inputs

    _parsed, design, model, _ids, _mask = tiny_inputs("bfloat16")
    with torch.no_grad():
        return model.cnn(design.cnn_input)


def test_bf16_dp_step_matches_jax_dp_step_and_one_process(coordinated):
    """F4: the two ranks' bf16 step (the mailbox model in JAX's padded
    scan's rounding) against JAX's ``make_dp_train_step`` on a 2-device
    mesh and against one process's ``train_step``. JAX's partitioner
    sums the ranks' float32 cotangents before any bf16 rounding, and so
    does the port (every rank backpropagates the whole batch): every
    leaf's gradient lies within 1e-3 x JAX's bf16-to-float32 distance of
    the one-process step in mean distance and within 1e-4 x its max |g|, as
    do the walk's and the head's weights of JAX's (the other leaves are
    not JAX's in one process either: held at 0.1 x max |g|; both by
    ``tests/test_torch_graph_shard.py::_assert_bf16_grads``). The head's
    first weight's columns that multiply the layout branch's output are
    JAX's cotangent times that output, and JAX's compiled bf16 CNN is
    not the port's bit for bit (some of its outputs an ulp apart at this
    draw of the weights); so JAX's reference for those columns is its dp
    step with its ``LayoutNet`` returning the port's output, the whole
    leaf at F4's bound. The ranks' losses, gradients and checksums are
    equal."""
    from test_torch_graph_shard import _assert_bf16_grads, _tight_vs_jax

    _outs, (rank0, rank1, ref), jax_grads = coordinated
    assert rank0["checksum"] == rank1["checksum"]
    assert rank0["loss"] == rank1["loss"]
    np.testing.assert_allclose(rank0["loss"], ref["loss"], rtol=1e-5)
    for key, g in rank0["grads"].items():
        assert torch.equal(g, rank1["grads"][key]), key
    j16, j32 = jax_grads["bfloat16"], jax_grads[None]
    gaps = {key: float(np.abs(np.asarray(w, np.float64)
                              - np.asarray(j32[key], np.float64)).mean())
            for key, w in j16.items()}
    _assert_bf16_grads(rank0["grads"], ref["grads"], gaps, "one process")
    want = dict(j16)
    want[HEAD] = np.array(j16[HEAD], np.float64)
    want[HEAD][:, HEAD_CNN_COLUMNS] = np.asarray(
        jax_grads["port_layout"][HEAD], np.float64)[:, HEAD_CNN_COLUMNS]
    _assert_bf16_grads(rank0["grads"], want, gaps, "JAX's dp step",
                       _tight_vs_jax)
