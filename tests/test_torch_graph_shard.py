"""The 2-D ``(dp, gp)`` edge-sharded train step in the port
(``prtp_tpu_torch/parallel/graph_shard.py``) against the port's
single-process segment step and JAX's ``make_graph_sharded_train_step``
on the same mesh shape of the virtual CPU mesh, on tiny designs of
``tests/test_graph_shard.py``'s generator: gp only ``(1, 2)``,
``(2, 2)``, merged designs on ``(2, 2)``, ``--attn`` with 2 heads on
``(2, 2)``, and the bf16 model (JAX's padded scan's rounding) on
``(2, 2)``, held by the bf16 bounds its tests state. The port's ranks
run in one child run (``tests/_torch_graph_shard_child.py``, gloo, at
most 4 ranks), started as soon as the inputs exist, while JAX's steps
compile here.

A sharded step sums each level's partial reductions over ``gp`` and the
gradients over ``dp``, in another order than one process, so values
agree to float32 rounding: losses at JAX's own rtol 1e-4
(``tests/test_graph_shard.py``), first-step gradients at rtol 1e-3 with
atol 1e-4 x each leaf's max |g| (the bound of JAX's sharded-vs-replicated
check, ``__graft_entry__.py:129-131``). Every rank's parameters must
stay the same (checksums equal after each step), and each design must
have a cell slot whose edges lie in both gp blocks, so that the
MAX-then-SUM combine is exercised (JAX's seed 31 splits none, so the
single design is seed 7's).
"""

import argparse
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from prtp_tpu import trainer as jtrainer
from prtp_tpu.graph import merge_parsed_designs as jax_merge
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.parallel import graph_shard as jgs
from prtp_tpu_torch.graph import (merge_parsed_designs, pack_design,
                                  scan_pair_rows)
from prtp_tpu_torch.models import PathModel
from prtp_tpu_torch.ops import KERNELS
from prtp_tpu_torch.parallel import requested_ranks
from prtp_tpu_torch.parallel.distributed import free_port
from prtp_tpu_torch.parallel.graph_shard import (graph_sharded_train_step,
                                                 make_2d_mesh, shard_design,
                                                 split_slot_count)
from prtp_tpu_torch.trainer import init_state, make_optimizer, train_step
from prtp_tpu_torch.utils.convert import params_from_flax

from _torch_graph_shard_child import walk
from test_models import _tiny_parsed_design
from test_torch_convert import jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_graph_shard_child.py")
MODEL_KW = dict(out_dim=16, hidden_dim=32, cnn_outdim=8, map_size=16,
                global_dim=8, gnn_reduce="segment")
LR, STEPS = 1e-3, 3
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3, 1e-4
# F4's bound on a bf16 dp step's gradients (_assert_bf16_grads)
F4_MEAN, F4_MAX = 1e-3, 1e-4
ATTN_KW = dict(MODEL_KW, flag_attn=True, num_heads=2)
BF16_KW = dict(MODEL_KW, compute_dtype="bfloat16")
CASES = {"gp_only": ((1, 2), None), "dp_gp": ((2, 2), "dp"),
         "merged": ((2, 2), "dp"), "attn": ((2, 2), "dp"),
         "bf16": ((2, 2), "dp")}
# the cases whose ranks also run the walk alone: dp_gp's gp blocks are
# gp_only's, so its walk would repeat gp_only's
WALK_CASES = ("gp_only", "merged", "attn")


def _model_kw(name):
    """The model of a case: the segment reduce, with ``--attn`` (2 heads,
    the per-head combine over gp and fc_attn2's gradient summed over gp)
    in the ``attn`` case, in bf16 (JAX's padded scan's rounding) in the
    ``bf16`` case."""
    return {"attn": ATTN_KW, "bf16": BF16_KW}.get(name, MODEL_KW)


def _jax_kw(model_kw):
    """``model_kw`` for JAX's PathModel: its compute dtype a jnp dtype."""
    if model_kw.get("compute_dtype") != "bfloat16":
        return model_kw
    return dict(model_kw, compute_dtype=jnp.bfloat16)


def _pack_kw(name, parsed):
    """The port's packing of a case: a bf16 model's feature tables in
    bf16, and its bias gradients summed over the rows of JAX's padded
    pack (align 8), as JAX's train CLI packs them."""
    if name != "bf16":
        return {}
    return dict(compute_dtype=torch.bfloat16,
                scan_rows=scan_pair_rows(parsed, align=8))


def _case_inputs(name):
    """(parsed, ids, mask) of a case: a tiny design of
    tests/test_graph_shard.py's generator (seed 7, all paths padded to a
    multiple of 4), or its merged designs (seed 5, K = 4 designs of 8 ids
    each, grouped (K, B))."""
    if name != "merged":
        parsed = _tiny_parsed_design(np.random.default_rng(7))
        n = int(parsed["num_paths"])
        ids, mask = jtrainer.pad_batch(np.arange(n), -(-n // 4) * 4)
        return parsed, np.array(ids), np.array(mask)
    rng = np.random.default_rng(5)
    parsed_list = [_tiny_parsed_design(rng) for _ in range(4)]
    merged = merge_parsed_designs(parsed_list)
    assert merged["num_nodes"] == jax_merge(parsed_list)["num_nodes"]
    ids = np.zeros((4, 8), np.int32)
    mask = np.zeros((4, 8), np.float32)
    for i, uni in enumerate(merged["path_ids_per_design"]):
        uni = np.asarray(uni)[:8]
        ids[i, : len(uni)] = uni
        mask[i, : len(uni)] = 1.0
    return merged, ids, mask


def _jax_init(model_kw):
    """(JAX model, jittered init) of the cases with ``model_kw``: the
    parameters' shapes do not depend on the design, so the single
    design's init serves the merged designs too."""
    parsed, ids, _mask = _case_inputs("gp_only")
    model = JaxPathModel(**model_kw)
    design = jax_pack_design(parsed, map_size=16, align=8)
    return model, jax_params(model, design, jnp.asarray(ids))["params"]


def _jax_reference(model, init, parsed, ids, mask, shape, batch_axis):
    """JAX's sharded step on the padded pack (align 8) of ``parsed`` from
    the init on a virtual CPU mesh of ``shape``: the first step's loss
    (taken before the update, so any optimizer's) and its gradients (an
    SGD(1) step's parameter change, as ``__graft_entry__.py`` reads
    them). A bf16 model's pack is bf16, as JAX's train CLI packs it."""
    design = jax_pack_design(parsed, map_size=16, align=8,
                             compute_dtype=model.compute_dtype or jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    mesh = jgs.make_2d_mesh(*shape)
    sharded = jgs.shard_design(mesh, design)
    tx = optax.sgd(1.0)
    state = jtrainer.TrainState(
        params=params, batch_stats={}, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), best_f1=jnp.zeros(()),
        best_r2=jnp.zeros(()))
    step = jgs.make_graph_sharded_train_step(
        model, tx, mesh, batch_axis=batch_axis, donate=False)
    new, mets = step(state, sharded, jnp.asarray(ids), jnp.asarray(mask))
    grads = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
        params, new.params)
    return float(mets["loss"]), params_from_flax(grads)


def _single_steps(parsed, state_dict, ids, mask, model_kw, pack_kw):
    """The port's single-process segment steps (``train_step``): each
    step's loss and the first step's gradients; and first, at the init,
    the walk alone (the child's :func:`walk`)."""
    model = PathModel(parsed["cell_feat"].shape[1],
                      parsed["net_feat"].shape[1], **model_kw)
    model.load_state_dict(state_dict)
    state = init_state(model, make_optimizer(LR), "cpu")
    design = pack_design(parsed, map_size=16, device="cpu", segment=True,
                         **pack_kw)
    walked = walk(model, design.graph)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    losses, grads = [], None
    for t in range(STEPS):
        losses.append(float(train_step(state, design, ids, mask)["loss"]))
        if t == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return losses, grads, walked


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: JAX's sharded reference, the port's single-process steps
    and every rank's result of the one child run, which runs beside the
    first two."""
    tmp = str(tmp_path_factory.mktemp("graph_shard"))
    inits = {attn: _jax_init(ATTN_KW if attn else MODEL_KW)
             for attn in (False, True)}
    states = {attn: params_from_flax(init)
              for attn, (_m, init) in inits.items()}
    inputs = {name: _case_inputs(name) for name in CASES}
    cases = {name: dict(parsed=parsed, model_kw=_model_kw(name), lr=LR,
                        state={k: v.numpy()
                               for k, v in states[name == "attn"].items()},
                        batch=(ids, mask), shape=shape,
                        batch_axis=batch_axis, steps=STEPS,
                        walk=name in WALK_CASES,
                        pack=_pack_kw(name, parsed))
             for (name, (shape, batch_axis)), (parsed, ids, mask)
             in zip(CASES.items(), inputs.values())}
    with open(os.path.join(tmp, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PRTP_")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen([sys.executable, CHILD, tmp], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        refs, singles = {}, {}
        for name, (shape, batch_axis) in CASES.items():
            parsed, ids, mask = inputs[name]
            attn = name == "attn"
            init = inits[attn][1]
            model = JaxPathModel(**_jax_kw(_model_kw(name)))
            loss, grads = _jax_reference(model, init, parsed, ids, mask,
                                         shape, batch_axis)
            design = (name if name in ("merged", "attn", "bf16")
                      else "single")
            if design not in singles:  # gp_only's steps are dp_gp's
                singles[design] = _single_steps(
                    parsed, states[attn], ids, mask, _model_kw(name),
                    _pack_kw(name, parsed))
            refs[name] = dict(jax_loss=loss, jax_grads=grads,
                              single=singles[design])
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    assert "RESULT ok" in out
    for name, (shape, _b) in CASES.items():
        refs[name]["ranks"] = [
            torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"),
                       weights_only=False)
            for r in range(shape[0] * shape[1])]
    return refs


def _assert_grads(got, want, what):
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(
            np.asarray(got[key], np.float64), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * (np.abs(w).max() or 1.0), err_msg=f"{what} {key}")


def _tight_vs_jax(key):
    """The leaves on which the port's single-process bf16 step equals
    JAX's to float32 rounding (measured: 1e-6 of JAX's bf16-to-float32
    distance or less): the walk's and the head's weights. The layout
    CNN, ``fcn`` and the head's biases are not: JAX's compiled bf16 CNN
    keeps float32 intermediates past flax's roundings, and its sharded
    step sums the bias products' float32 partials where its one-device
    step sums them in bf16 (1-5% of that distance apart)."""
    return key.startswith("gnn.") or (key.startswith("mlp_")
                                      and key.endswith(".weight"))


def _jax_gaps(runs):
    """Per leaf, JAX's bf16-to-float32 distance: the mean distance of
    JAX's bf16 sharded step's first gradients from its float32 twin's
    (the ``dp_gp`` case's)."""
    want32 = runs["dp_gp"]["jax_grads"]
    return {key: float(np.abs(np.asarray(w, np.float64) - np.asarray(
        want32[key], np.float64)).mean())
        for key, w in runs["bf16"]["jax_grads"].items()}


def _assert_bf16_grads(got, want, gaps, what, tight=lambda key: True):
    """bf16 first-step gradients against a bf16 reference ``want``. The
    leaves ``tight`` picks within
    F4_MEAN x JAX's bf16-to-float32 distance (``gaps``, :func:`_jax_gaps`)
    in mean distance and F4_MAX x the leaf's max
    |g| everywhere: the dp ranks' cotangents are combined before any
    bf16 rounding, as JAX's partitioner sums them (F4). The others, the
    leaves whose single-process step is not JAX's (:func:`_tight_vs_jax`),
    within 0.1 x the leaf's max |g| (tests/test_torch_bf16_model.py's
    bound for a leaf)."""
    for key, w in want.items():
        w, g = np.asarray(w, np.float64), np.asarray(got[key], np.float64)
        scale = np.abs(w).max() or 1.0
        if not tight(key):
            np.testing.assert_allclose(g, w, rtol=0, atol=0.1 * scale,
                                       err_msg=f"{what} {key}")
            continue
        gap = gaps[key]
        mean, worst = float(np.abs(g - w).mean()), float(np.abs(g - w).max())
        assert mean <= F4_MEAN * gap and worst <= F4_MAX * scale, (
            f"{what} {key}: mean distance {mean:.3g} ({mean / (gap or 1):.3g}"
            f" x JAX's bf16-to-float32 {gap:.3g}; allowed {F4_MEAN} x), max "
            f"{worst / scale:.3g} x max |g| (allowed {F4_MAX} x)")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax_sharded_step(runs, name):
    """Every rank's first step against JAX's sharded step on the same
    mesh shape: the loss at rtol 1e-4, the gradients at rtol 1e-3, atol
    1e-4 x max |g|. In bf16 (JAX's padded scan's rounding) the gradients
    are held by :func:`_assert_bf16_grads` against JAX's bf16 sharded
    step: JAX's partitioner sums the dp ranks' float32 cotangents before
    the bf16 roundings, and the port's ``dp_train_step`` backpropagates
    the whole batch on every rank (F4), so the walk's leaves and the
    head's weights are held at F4's bound; before that repair each rank rounded its own
    cotangents, which moved the walk's leaves by up to 5% and
    ``mlp_fuse``'s second weight by 21% of JAX's bf16-to-float32
    distance."""
    ref = runs[name]
    for out in ref["ranks"]:
        np.testing.assert_allclose(out["losses"][0], ref["jax_loss"],
                                   rtol=LOSS_RTOL)
        if name == "bf16":
            _assert_bf16_grads(out["grads"], ref["jax_grads"],
                               _jax_gaps(runs), "bf16 vs JAX", _tight_vs_jax)
        else:
            _assert_grads(out["grads"], ref["jax_grads"], f"{name} vs JAX")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_match_single_process(runs, name):
    """STEPS sharded steps against the port's single-process segment steps
    from the same init: each step's loss at rtol 1e-4, the first step's
    gradients at rtol 1e-3, atol 1e-4 x max |g|. In bf16 the first step
    alone, every leaf's gradient by :func:`_assert_bf16_grads` against
    the single process's bf16 step at F4's bound: the later steps start
    from parameters
    that Adam moved by about LR whatever the size of a gradient, so an
    element whose bf16 sum rounds the other way on a rank flips a
    weight's step."""
    ref = runs[name]
    losses, grads, _walk = ref["single"]
    grads = {k: g.numpy() for k, g in grads.items()}
    for out in ref["ranks"]:
        if name == "bf16":
            np.testing.assert_allclose(out["losses"][0], losses[0],
                                       rtol=LOSS_RTOL)
            _assert_bf16_grads(out["grads"], grads, _jax_gaps(runs),
                               "bf16 vs single")
            continue
        np.testing.assert_allclose(out["losses"], losses, rtol=LOSS_RTOL)
        _assert_grads(out["grads"], grads, f"{name} vs single")


@pytest.mark.parametrize("name", WALK_CASES)
def test_sharded_walk_matches_single_process(runs, name):
    """The GNN walk alone on every rank's sharded design against one
    process's, for a random h0 and a random cotangent of every row:
    h_final at rtol/atol 1e-5 (every row, the split slots' too: the
    MAX-then-SUM combine), the h0 cotangent and the walk's parameter
    gradients at rtol 2e-4, atol 1e-5 (the compact cotangents summed
    over gp), the bounds of tests/test_torch_segment.py."""
    h, d_h0, grads = runs[name]["single"][2]
    for out in runs[name]["ranks"]:
        got_h, got_d_h0, got_grads = out["walk"]
        np.testing.assert_allclose(got_h, h, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_d_h0, d_h0, rtol=2e-4, atol=1e-5)
        for key, want in grads.items():
            np.testing.assert_allclose(got_grads[key], want, rtol=2e-4,
                                       atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_stay_equal_and_a_slot_is_split(runs, name):
    """Every rank sits at its place of JAX's row-major mesh, holds the
    same parameters after each step (flat Adam's state stays bit-equal:
    the gp ranks' gradients are equal, the dp sum is the same on every
    column) and the same losses; and the design has destination slots
    whose edges lie in both gp blocks (a cell slot: the combine's)."""
    (n_dp, n_gp), _b = CASES[name]
    outs = runs[name]["ranks"]
    assert [o["mesh"] for o in outs] == [(r // n_gp, r % n_gp)
                                         for r in range(n_dp * n_gp)]
    for o in outs[1:]:
        assert o["checksums"] == outs[0]["checksums"]
        assert o["losses"] == outs[0]["losses"]
    assert all(o["split_slots"] > 0 for o in outs)


# ---- in one process: the blocks, the (1, 1) mesh, the CLIs' refusal ----

def _mesh_at(n_gp, gp_rank):
    """A stand-in for a mesh whose gp group is never used."""
    return argparse.Namespace(n_dp=1, n_gp=n_gp, dp_rank=0, gp_rank=gp_rank,
                              dp=None, gp_group=None)


@pytest.mark.parametrize("n_gp", [1, 2, 3])
def test_shard_blocks_partition_every_level(n_gp):
    """The gp blocks of a level's destination-sorted edges partition it:
    their sources and per-slot counts add up to the level's, their
    scatter tables cover each edge once with rows that map back to the
    level's distinct source rows; has_in and net_cnt stay whole."""
    parsed = _case_inputs("gp_only")[0]
    design = pack_design(parsed, map_size=16, device="cpu", segment=True)
    g = design.graph
    shards = [shard_design(_mesh_at(n_gp, r), design).graph
              for r in range(n_gp)]
    for sg in shards:
        assert sg.cell_has_in is g.cell_has_in and sg.net_cnt is g.net_cnt
    split = 0
    for k in range(g.num_pairs):
        for half in ("cell", "net"):
            src = getattr(g, f"{half}_src")[k].numpy()
            off = getattr(g, f"{half}_dst_off")[k].numpy()
            rows = getattr(g, f"{half}_src_rows")[k].numpy()
            parts = [getattr(sg.shard, f"{half}_src")[k].numpy()
                     for sg in shards]
            np.testing.assert_array_equal(np.concatenate(parts), src)
            counts = sum(np.diff(getattr(sg.shard, f"{half}_dst_off")[k]
                                 .numpy()) for sg in shards)
            np.testing.assert_array_equal(counts, np.diff(off))
            for sg, part in zip(shards, parts):
                srows = rows[getattr(sg.shard, f"{half}_src_rows")[k]
                             .numpy()]
                soff = getattr(sg.shard, f"{half}_src_off")[k].numpy()
                np.testing.assert_array_equal(
                    np.repeat(srows, np.diff(soff)), np.sort(part))
            if half == "cell" and k > 0:
                split += split_slot_count(off, n_gp)
    assert all(sg.shard.split_slots == split for sg in shards)
    assert (split > 0) == (n_gp > 1)


def test_shard_design_needs_the_segment_pack():
    """``shard_design`` splits the flat edge tables, which a default pack
    leaves out: it raises, naming ``segment=True``."""
    design = pack_design(_case_inputs("gp_only")[0], map_size=16,
                         device="cpu")
    with pytest.raises(ValueError, match="segment=True"):
        shard_design(_mesh_at(2, 0), design)


def _one_by_one_runs(model_kw, pack_kw, checks=False):
    """On a (1, 1) mesh over a gloo world of one: two steps of
    ``train_step`` and two of ``graph_sharded_train_step`` (at its
    defaults), each from the same init: per run the losses, the last
    gradients and the parameters. ``checks``: the mesh and the step also
    refuse a world of the wrong size and an unsharded design."""
    parsed, ids, mask = _case_inputs("gp_only")
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    design = pack_design(parsed, map_size=16, device="cpu", segment=True,
                         **pack_kw)
    results = []
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_2d_mesh(1, 1)
        if checks:
            assert mesh.shape == {"dp": 1, "gp": 1}
            with pytest.raises(RuntimeError, match="needs 2 ranks"):
                make_2d_mesh(1, 2)
        for sharded in (False, True):
            model = PathModel(10, 3, **model_kw,
                              generator=torch.Generator().manual_seed(0))
            state = init_state(model, make_optimizer(LR), "cpu")
            if sharded:
                d = shard_design(mesh, design)
                mets = [graph_sharded_train_step(state, d, ids, mask, mesh)
                        for _ in range(2)]
            else:
                mets = [train_step(state, design, ids, mask)
                        for _ in range(2)]
            results.append(([float(m["loss"]) for m in mets],
                            state.optimizer.grad.clone(),
                            state.optimizer.flat.clone()))
        if checks:
            with pytest.raises(ValueError, match="shard_design"):
                graph_sharded_train_step(state, design, ids, mask, mesh)
    finally:
        dist.destroy_process_group()
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    return results


def test_one_by_one_mesh_is_the_single_process_step():
    """A (1, 1) mesh over a gloo world of one: the same losses and
    gradients as ``train_step``, bit for bit (one rank's all-reduces
    change nothing and the compact scatter adds the same sums)."""
    (l1, g1, p1), (l2, g2, p2) = _one_by_one_runs(MODEL_KW, {}, checks=True)
    assert l1 == l2
    assert torch.equal(g1, g2) and torch.equal(p1, p2)


def test_one_by_one_mesh_is_the_single_process_step_in_bf16():
    """The bf16 segment model (JAX's padded scan's rounding, every entry
    point at its default) on a (1, 1) mesh: the same losses, gradients
    and parameters as ``train_step`` on the same bf16 pack, bit for bit;
    and they differ from the float32 model's."""
    pack_kw = _pack_kw("bf16", _case_inputs("gp_only")[0])
    (l1, g1, p1), (l2, g2, p2) = _one_by_one_runs(BF16_KW, pack_kw)
    assert l1 == l2
    assert torch.equal(g1, g2) and torch.equal(p1, p2)
    (_l, g32, _p), _sharded = _one_by_one_runs(MODEL_KW, {})
    assert not torch.equal(g1, g32)


def test_clis_refuse_a_2d_mesh_and_name_graph_shard():
    """The CLIs keep refusing a 2-D ``--mesh_shape``, as JAX's do, and
    point at the library API."""
    options = argparse.Namespace(dp=True, mesh_shape=[2, 2])
    with pytest.raises(ValueError, match="1-D") as err:
        requested_ranks(options, "cpu")
    assert "prtp_tpu_torch.parallel.graph_shard" in str(err.value)

