"""The multi-design step (``prtp_tpu_torch/parallel/multi.py``,
``graph.stack_designs``) against the JAX package's vmapped
``make_multidesign_train_step`` and ``make_multidesign_eval_step``
(``prtp_tpu/parallel/multi.py``), on the CPU at small sizes.

JAX pads K designs to one bucket (``bucket_shape``, align 8 here),
stacks them and vmaps its model over them; the port walks the designs'
super-graph once. The designs are ``tests/test_models.py::
_tiny_parsed_design``'s with other level counts (2, 3, 2 and 1 level
pairs), so that the bucket pads some designs with whole level pairs; a
batch row holds a design's own path ids, padded with id 0 and mask 0.

- float32, with reg, ``cls``, ``--attn`` (2 heads) and the segment
  reduce: the evaluation's predictions and metrics at 1e-5, the first
  step's gradients within 2e-4 x each leaf's max |g|, and 3 flat-Adam
  steps' losses (rtol 1e-5) and parameters (rtol 1e-4, atol 5e-5,
  ``tests/test_torch_cls.py``'s bounds); the loss is the masked sum over all K x B entries over
  the global count (the mean of the designs' losses weighted by their
  counts), as ``tests/test_multidesign.py::
  test_multidesign_matches_singles`` pins it, and the step is
  ``trainer.train_step`` on the super-graph, bit for bit.
- bf16 (JAX's padded scan's rounding): on grid designs whose every
  float32 sum is exact, the walk's h, its twelve MLP gradients and h0's
  cotangent bit for bit against ``jax.jit(jax.grad(...))`` of JAX's
  padded-scan ``TimeGNN`` vmapped over the stacked designs, whose bias
  gradients are one bf16 reduce over all the designs' padded rows
  (windows of 32 that span designs) and whose weight gradients are one
  product over them, rounded once a pair (read from the compiled HLO);
  on the random designs the model's evaluation and 2 steps at
  ``tests/test_torch_bf16_model.py``'s bounds.
- The design-sharded step at dp 2 (two gloo ranks in one child run,
  ``tests/_torch_multi_child.py``, started while JAX compiles) against
  JAX's step with ``mesh=make_mesh(2)``: float32 at the bounds above and
  against the port's unsharded step, bf16 at the bf16 bounds, without
  and with the layout CNN (every gradient outside the walk the ranks'
  bf16 gradients summed and rounded again, as JAX's); every rank's
  parameters stay equal.
- The U-Net refused with JAX's message; K not divisible by the mesh, and
  designs JAX cannot stack, refused.
"""

import functools
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

from prtp_tpu import trainer as jtrainer
from prtp_tpu.graph import bucket_shape
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.graph import pack_leveled_graph as jax_pack_padded
from prtp_tpu.graph import stack_designs as jax_stack_designs
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.models.gnn import TimeGNN as JaxTimeGNN
from prtp_tpu.parallel import multi as jmulti
from prtp_tpu.parallel.mesh import make_mesh
from prtp_tpu_torch import test as port_test
from prtp_tpu_torch.graph import (merge_parsed_designs, pack_design,
                                  pack_leveled_graph_exact, scan_level_rows,
                                  stack_designs, stack_level_rows)
from prtp_tpu_torch.models import PathModel, TimeGNN
from prtp_tpu_torch.ops import KERNELS
from prtp_tpu_torch.ops.bf16 import BF16, column_sums_bf16
from prtp_tpu_torch.parallel import Mesh
from prtp_tpu_torch.parallel.multi import (entry_losses,
                                           multidesign_eval_step,
                                           multidesign_train_step)
from prtp_tpu_torch.trainer import init_state, make_optimizer, train_step
from prtp_tpu_torch.utils.convert import params_from_flax

from helpers import make_random_leveled_graph
from test_torch_bf16 import _grid, assert_near_jax_bf16
from test_torch_bf16_eval import OUT
from test_torch_bf16_model import _jax_state, _port_flat
from test_torch_bf16_scan_grad import (_on_rows, _to_rows,
                                       grid_levels_design, grid_params)
from test_torch_convert import jax_params
from test_torch_graph_shard import _assert_bf16_grads, _tight_vs_jax

import _torch_threads  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_multi_child.py")
MODEL_KW = dict(out_dim=16, hidden_dim=32, cnn_outdim=8, map_size=16,
                global_dim=8)
VARIANTS = {"reg": {}, "cls": dict(nlabels=2),
            "attn": dict(flag_attn=True, num_heads=2),
            "segment": dict(gnn_reduce="segment")}
# the designs' level sizes: 2, 3, 2 and 1 level pairs
LEVELS = [(4, 6, 5, 7), (5, 3, 6, 4, 3, 5), (4, 6, 5), (3, 4)]
ALIGN, B, LR, STEPS, BF16_STEPS = 8, 8, 1e-3, 3, 2
# each design's gradients within this x its leaf's max |g|
GRAD_ATOL = 2e-4
# the final parameters' atol, tests/test_torch_cls.py's: Adam divides a
# gradient element that float32 cancellation leaves near 0 by its own
# size, which turns its rounding into up to 3.3e-5 of a step's move
# (measured in --attn's Conv_2)
PARAM_ATOL = 5e-5
to_np = functools.partial(jax.tree_util.tree_map, np.asarray)


def _task(name):
    return "cls" if name == "cls" else "reg"


def _parsed(rng, sizes):
    """``tests/test_models.py::_tiny_parsed_design`` with the level sizes
    ``sizes``: its endpoints the last level's nodes."""
    g = make_random_leveled_graph(rng, level_sizes=sizes, cell_feat_dim=10,
                                  net_feat_dim=3)
    n = g["num_nodes"]
    endpoints = np.asarray(g["levels"][-1][0], dtype=np.int64)
    num_paths = len(endpoints)
    arrival = rng.normal(size=n).astype(np.float32)
    required = arrival + rng.normal(size=n).astype(np.float32)
    return dict(
        g, arrival_time=arrival, required_time=required,
        is_critical=(required - arrival < 0).astype(np.int32),
        path_endpoint=endpoints,
        path_level=np.full(num_paths, len(g["levels"]) - 1, np.float32),
        mask_coo=np.stack([np.repeat(np.arange(num_paths), 3),
                           rng.integers(0, 256, size=3 * num_paths)]),
        num_paths=num_paths,
        cnn_input=rng.normal(size=(2, 64, 64)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _designs():
    rng = np.random.default_rng(5)
    return tuple(_parsed(rng, sizes) for sizes in LEVELS)


def _batch(parsed_list):
    """``(ids, mask)`` ``(K, B)``: row k design k's own paths, padded with
    id 0 and mask 0."""
    ids = np.zeros((len(parsed_list), B), np.int32)
    mask = np.zeros((len(parsed_list), B), np.float32)
    for k, p in enumerate(parsed_list):
        n = min(B, int(p["num_paths"]))
        ids[k, :n] = np.arange(n)
        mask[k, :n] = 1.0
    return ids, mask


# the model of the design-sharded bf16 case: without the layout CNN, whose
# bf16 under jax.jit keeps float32 intermediates past flax's roundings and
# sets 2 of the 32 predictions an ulp apart (tests/test_torch_bf16_model.py
# holds it), which would hide the walk's and the head's roundings
NO_CNN = dict(use_cnn=False)


def _kw(name):
    return dict(MODEL_KW, **(NO_CNN if name == "no_cnn" else VARIANTS[name]))


@functools.lru_cache(maxsize=None)
def _jax_stack(dtype=None):
    """JAX's stacked packs of the designs on their bucket (align 8),
    bf16 in a bf16 model."""
    parsed = _designs()
    bucket = bucket_shape(parsed, align=ALIGN)
    return jax_stack_designs([
        jax_pack_design(p, map_size=16, align=ALIGN, pad_to=bucket,
                        compute_dtype=dtype or jnp.float32, cnn_patches=False)
        for p in parsed])


@functools.lru_cache(maxsize=None)
def _attn_tree():
    """A jittered JAX init (jitted) of the ``--attn`` model, as a numpy
    tree."""
    parsed = _designs()[0]
    pack = jax_pack_design(parsed, map_size=16, align=ALIGN,
                           cnn_patches=False)
    ids = jnp.arange(parsed["num_paths"], dtype=jnp.int32)
    return jax_params(JaxPathModel(**_kw("attn")), pack, ids)["params"]


def _init(name):
    """The variant's init, cut from the ``--attn`` model's (one init to
    compile): reg's and the segment reduce's without ``fc_attn2``;
    ``cls``'s with a second output column drawn like the first (numpy
    seed 9); ``no_cnn``'s without the layout branch (``cnn``, ``fcn_*``
    and the rows of ``mlp_fuse``'s first kernel that read it, its hidden
    width cut to twice its input's)."""
    params = _attn_tree()
    if name == "attn":
        return params
    gnn = dict(params["gnn"], pair_step={
        k: v for k, v in params["gnn"]["pair_step"].items()
        if k != "fc_attn2"})
    params = dict(params, gnn=gnn)
    fuse = params["mlp_fuse"]
    if name == "cls":
        rng = np.random.default_rng(9)
        kernel = fuse["fc1"]["kernel"]
        extra = (kernel.std() * rng.normal(size=kernel.shape)).astype(
            np.float32)
        params["mlp_fuse"] = dict(fuse, fc1={
            "kernel": np.concatenate([kernel, extra], axis=1),
            "bias": np.concatenate([fuse["fc1"]["bias"],
                                    -fuse["fc1"]["bias"]])})
    if name == "no_cnn":
        out, cnn = MODEL_KW["out_dim"], MODEL_KW["cnn_outdim"]
        kernel = fuse["fc0"]["kernel"]
        rows = np.concatenate([kernel[:out], kernel[out + cnn:]])
        hidden = 2 * len(rows)  # mlp_fuse's hidden width: twice its input
        params = {k: v for k, v in params.items()
                  if k not in ("cnn", "fcn_kernel", "fcn_bias")}
        params["mlp_fuse"] = {
            "fc0": {"kernel": rows[:, :hidden],
                    "bias": fuse["fc0"]["bias"][:hidden]},
            "fc1": {"kernel": fuse["fc1"]["kernel"][:hidden],
                    "bias": fuse["fc1"]["bias"]}}
    return params


def _jax_model(name, dtype=None):
    return JaxPathModel(**_kw(name), compute_dtype=dtype)


def _mesh(sharded):
    return make_mesh(2) if sharded else None


@functools.lru_cache(maxsize=None)
def _jax_eval(name, dtype=None):
    """JAX's ``make_multidesign_eval_step`` at the init: ``(preds,
    metrics)`` as numpy values."""
    params = jax.tree_util.tree_map(jnp.asarray, _init(name))
    ids, mask = (jnp.asarray(x) for x in _batch(_designs()))
    step = jmulti.make_multidesign_eval_step(_jax_model(name, dtype),
                                             _task(name))
    preds, mets = step(_jax_state(params, optax.sgd(1.0)), _jax_stack(dtype),
                       ids, mask)
    return np.asarray(preds), {k: float(v) for k, v in mets.items()}


@functools.lru_cache(maxsize=None)
def _jax_steps(name, dtype=None, sharded=False, steps=STEPS):
    """JAX's ``make_multidesign_train_step`` with its flat Adam from the
    init (``sharded``: on ``make_mesh(2)``): each step's metrics, the
    state before each step and after the last, and the first step's
    gradients, read from Adam's first moment after it (``(1 - b1) g``,
    divided back: 1e-7 of each element)."""
    tx = jtrainer.make_optimizer(LR, flat=True)
    step = jmulti.make_multidesign_train_step(
        _jax_model(name, dtype), tx, _task(name), mesh=_mesh(sharded),
        donate=False)
    ids, mask = (jnp.asarray(x) for x in _batch(_designs()))
    state = _jax_state(_init(name), tx)
    states, mets = [], []
    for _ in range(steps):
        states.append(state)
        state, m = step(state, _jax_stack(dtype), ids, mask)
        mets.append({k: float(v) for k, v in m.items()})
    mu = np.asarray((states + [state])[1].opt_state["mu"], np.float64)
    leaves, treedef = jax.tree_util.tree_flatten(states[0].params)
    parts, off = [], 0
    for leaf in leaves:
        parts.append((mu[off: off + leaf.size] / (1 - 0.9)).reshape(
            leaf.shape))
        off += leaf.size
    grads = params_from_flax(jax.tree_util.tree_unflatten(treedef, parts))
    return mets, states + [state], {k: v.numpy() for k, v in grads.items()}


def _port(name, dtype=None):
    """The port's model from the variant's init, its flat-Adam state and
    its stack of the designs (align 8)."""
    kw = _kw(name)
    model = PathModel(10, 3, compute_dtype=dtype, **kw)
    model.load_state_dict(params_from_flax(_init(name)))
    state = init_state(model, make_optimizer(LR), "cpu")
    stacked = stack_designs(
        _designs(), align=ALIGN, map_size=16, device="cpu",
        compute_dtype=torch.bfloat16 if dtype else torch.float32,
        segment=kw.get("gnn_reduce") == "segment")
    ids, mask = (torch.from_numpy(x) for x in _batch(_designs()))
    return model, state, stacked, ids, mask


def _assert_metrics(got, want, what):
    for key in ("loss", "r2"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what} {key}")
    for key in ("tp", "fp", "tn", "fn"):
        assert float(got[key]) == float(want[key]), f"{what} {key}"


def _assert_grads(got, want, what):
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(
            np.asarray(got[key], np.float64), w, rtol=0,
            atol=GRAD_ATOL * (np.abs(w).max() or 1.0), err_msg=f"{what} {key}")


def _assert_params(got_params, want_params, what):
    """Final parameters: every element within 2 x LR x STEPS (Adam moves
    one by about LR a step at most), and all but one in 10,000 of each
    leaf within rtol 1e-4, atol PARAM_ATOL: Adam moves an element whose
    gradient lies within float32 rounding of 0 by up to LR either way
    (measured once: 1.45e-4 in one of Conv_1's 100,352)."""
    for key, got in got_params.items():
        want = np.asarray(want_params[key], np.float64)
        got = np.asarray(got, np.float64)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR * STEPS,
                                   err_msg=f"{what} {key}")
        off = np.abs(got - want) > 1e-4 * np.abs(want) + PARAM_ATOL
        assert off.sum() <= -(-got.size // 10_000), (
            f"{what} {key}: {int(off.sum())} of {got.size} elements beyond "
            f"rtol 1e-4, atol {PARAM_ATOL}")


# ---- float32, one process ----

@pytest.mark.parametrize("name", list(VARIANTS))
def test_multidesign_steps_match_jax(name):
    """The evaluation at the init (predictions and metrics at 1e-5), the
    first step's gradients (2e-4 x max |g|), then STEPS flat-Adam steps'
    losses and metrics and the final parameters against JAX's vmapped
    steps; the walk's kernels launch 0 times on the CPU."""
    task = _task(name)
    model, state, stacked, ids, mask = _port(name)
    want_preds, want_mets = _jax_eval(name)
    preds, mets = multidesign_eval_step(model, stacked, ids, mask, task)
    assert preds.shape == want_preds.shape
    np.testing.assert_allclose(preds.numpy(), np.asarray(want_preds),
                               rtol=1e-5, atol=1e-5)
    _assert_metrics(mets, want_mets, "eval")
    want_mets, want_states, want_grads = _jax_steps(name)
    for t, want in enumerate(want_mets):
        got = multidesign_train_step(state, stacked, ids, mask, task)
        if t == 0:
            _assert_grads({k: p.grad.numpy()
                           for k, p in model.named_parameters()},
                          want_grads, name)
        _assert_metrics(got, want, f"step {t}")
        assert sum(float(got[k]) for k in ("tp", "fp", "tn", "fn")) == \
            float(mask.sum())
    _assert_params({k: p.numpy() for k, p in model.state_dict().items()},
                   params_from_flax(to_np(want_states[-1].params)), name)
    assert state.step == STEPS
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def test_multidesign_loss_is_the_designs_masked_mean():
    """JAX's ``test_multidesign_matches_singles``: the multi-design loss
    is the masked per-path loss summed over all K x B entries over the
    global count, i.e. each design's loss (``test.evaluate`` on it packed
    alone) weighted by its count; and the step is ``train_step`` on the
    designs' super-graph with the same path rows, bit for bit (loss,
    metrics, gradients, parameters)."""
    model, state, stacked, ids, mask = _port("reg")
    _preds, mets = multidesign_eval_step(model, stacked, ids, mask)
    total = 0.0
    for parsed, row, m in zip(_designs(), ids, mask):
        design = pack_design(parsed, map_size=16, device="cpu")
        total += float(port_test.evaluate(model, design, row, m)[1]["loss"]) \
            * float(m.sum())
    np.testing.assert_allclose(float(mets["loss"]),
                               total / float(mask.sum()), rtol=1e-5)
    twin, twin_state, _s, _i, _m = _port("reg")
    design, rows = stacked.rows(0, len(stacked), ids)
    for _ in range(2):
        got = multidesign_train_step(state, stacked, ids, mask)
        want = train_step(twin_state, design, rows, mask, rounding="scan")
        for key in want:
            assert torch.equal(got[key], want[key]), key
        assert torch.equal(state.optimizer.grad, twin_state.optimizer.grad)
        assert torch.equal(state.optimizer.flat, twin_state.optimizer.flat)


# ---- bf16 ----

@pytest.mark.parametrize("k,pn,counts", [
    (2, 8, None), (3, 16, (16, 10, 3)), (4, 24, None), (3, 40, (40, 0, 17)),
    (8, 128, (100,) * 8), (8, 130, None), (5, 7, None), (40, 3, None)])
def test_stacked_column_sums_are_xla_bf16_reduce(k, pn, counts):
    """``column_sums_bf16`` of K designs' rows laid out on a bucket of pn
    rows (``(pn, counts)``) against XLA's CPU reduce of the stacked
    ``(K, pn, C)`` bf16 array over its first two dimensions, jitted as
    ``jax.grad`` of the vmapped scan emits it; designs with fewer rows
    than the bucket (zero rows after theirs), and both dimensions below,
    at and above a window of 32: 0 elements different."""
    rng = np.random.default_rng(k * 1000 + pn)
    counts = counts or (pn,) * k
    x = np.zeros((k, pn, 24), np.float32)
    for d, c in enumerate(counts):
        x[d, :c] = rng.normal(size=(c, 24))
    want = np.asarray(jax.jit(lambda a: jax.lax.reduce(
        a, jnp.bfloat16(0), jax.lax.add, (0, 1)))(
            jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    v = torch.tensor(np.concatenate([x[d, :c] for d, c in enumerate(counts)]))
    got = column_sums_bf16([v.to(BF16), v[:, :8].to(BF16)],
                           [(pn, counts)] * 2)
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), want[:8])


# grid designs of 2 and 3 level pairs (one without its last net level):
# the designs of a stack, all four on a bucket of 48 rows (each level
# two windows of 32 with 8 zero rows before), and a dp rank's two small
# ones on 8 (summed in order)
GRID_LEVELS = [(40, 36, 45, 38), (35, 44, 30, 41, 33, 37), (42, 39, 34),
               (38, 45, 36, 40)]
SMALL_LEVELS = [(6, 5, 7, 4), (5, 6, 4, 7, 3, 5)]
GRID_BLOCKS = {"four": (GRID_LEVELS, 8), "two": (SMALL_LEVELS, 8)}


def _grid_designs(levels):
    designs = []
    for seed, sizes in enumerate(levels):
        d = grid_levels_design(list(sizes), seed=seed)
        n, paths = d["num_nodes"], sizes[-1]
        d.update(arrival_time=np.zeros(n, np.float32),
                 required_time=np.zeros(n, np.float32),
                 is_critical=np.zeros(n, np.int32),
                 path_endpoint=d["levels"][-1][0],
                 path_level=np.zeros(paths, np.float32),
                 mask_coo=np.zeros((2, 0), np.int64), num_paths=paths,
                 cnn_input=np.zeros((2, 8, 8), np.float32))
        designs.append(d)
    return designs


@pytest.mark.parametrize("block,reduce", [
    ("four", "mailbox"), ("two", "mailbox"), ("four", "segment")])
def test_grid_stacked_walk_is_jax_vmapped_scan_bit_for_bit(block, reduce):
    """The bf16 walk of a stack's super-graph (the port's multi-design
    walk) against ``jax.jit(jax.grad(...))`` of JAX's padded-scan
    ``TimeGNN(mlp_dtype=bfloat16)`` vmapped over the designs stacked on
    one bucket, on grid designs of different level counts (a design with
    fewer pairs runs padded pairs there): h, the twelve MLP gradients and
    h0's cotangent, 0 elements different. Where the bucket's levels are
    longer than a window, summing the bias gradients over the
    super-graph's levels as one design's (on its own bucket) differs. ``segment``: the same
    with the segment reduce (JAX's ``reduce_mode="segment"``)."""
    levels, align = GRID_BLOCKS[block]
    designs = _grid_designs(levels)
    bucket = bucket_shape(designs, align=align)
    rows_pn = scan_level_rows(designs, align)
    assert rows_pn == (bucket["pn_c"], bucket["pn_n"])
    rng = np.random.default_rng(4)
    params = grid_params(rng)
    h0s = [_grid(rng, (d["num_nodes"] + 1, OUT), 32, 1 / 8) for d in designs]
    cots = [_grid(rng, (d["num_nodes"] + 1, OUT), 32, 1 / 8)
            for d in designs]
    # JAX: the padded packs stacked, the walk vmapped
    packs = [jax_pack_padded(d, align=align, pad_to=bucket,
                             compute_dtype=jnp.bfloat16) for d in designs]
    num_rows = packs[0][2]
    graphs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                    *[g for g, _r, _n in packs])
    h0 = jnp.asarray(np.stack([_to_rows(h, r, num_rows)
                               for h, (_g, r, _n) in zip(h0s, packs)]))
    cot = jnp.asarray(np.stack([_to_rows(c, r, num_rows)
                                for c, (_g, r, _n) in zip(cots, packs)]))
    gnn = JaxTimeGNN(out_dim=OUT, hidden_dim=32, fused_vjp=False,
                     mlp_dtype=jnp.bfloat16, reduce_mode=reduce)

    def walk(p, h0):
        return jax.vmap(lambda g, h: gnn.apply({"params": p}, g, h))(
            graphs, h0)

    def walk_and_grads(p, h):
        hf, pull = jax.vjp(walk, p, h)
        return hf, pull(cot)

    want_h, (d_p, d_h0) = jax.jit(walk_and_grads)(params, h0)
    want_h = np.asarray(want_h)
    want = {key: v.numpy()
            for key, v in params_from_flax({"gnn": to_np(d_p)}).items()}
    # the port: one walk of the super-graph
    merged = merge_parsed_designs(designs)

    def port(scan_rows):
        graph, rows, n_rows = pack_leveled_graph_exact(
            merged, "cpu", compute_dtype=torch.bfloat16, scan_rows=scan_rows,
            segment=reduce == "segment")
        assert graph.stacked
        model = TimeGNN(10, 3, torch.Generator().manual_seed(0),
                        out_dim=OUT, hidden_dim=32, mlp_dtype="bfloat16",
                        reduce_mode=reduce)
        model.load_state_dict({key[len("gnn."):]: v for key, v in
                               params_from_flax({"gnn": to_np(params)})
                               .items()})
        h0_t = torch.tensor(_to_rows(np.concatenate(
            [h[:-1] for h in h0s] + [np.zeros((1, OUT), np.float32)]),
            rows, n_rows), requires_grad=True)
        cot_t = torch.tensor(_to_rows(np.concatenate(
            [c[:-1] for c in cots] + [np.zeros((1, OUT), np.float32)]),
            rows, n_rows))
        hf = model(graph, h0_t, rounding="scan")
        (hf * cot_t).sum().backward()
        grads = {f"gnn.{key}": p.grad.numpy()
                 for key, p in model.named_parameters()}
        return (_on_rows(hf.detach().numpy(), rows, n_rows)[:-1],
                _on_rows(h0_t.grad.numpy(), rows, n_rows)[:-1], grads)

    h, dh0, grads = port(stack_level_rows(designs, rows_pn))
    starts = np.cumsum([0] + [d["num_nodes"] for d in designs])
    for i, (_g, r, _n) in enumerate(packs):
        nodes = slice(starts[i], starts[i + 1])
        np.testing.assert_array_equal(h[nodes], want_h[i][r],
                                      err_msg=f"h of design {i}")
        np.testing.assert_array_equal(dh0[nodes], np.asarray(d_h0[i])[r],
                                      err_msg=f"h0's cotangent, design {i}")
    assert sorted(grads) == sorted(want) and len(want) == 12
    for key in want:
        np.testing.assert_array_equal(grads[key], want[key], err_msg=key)
    if max(rows_pn) > 32:  # the windows cut each design's rows
        _h, _d, unpadded = port(stack_level_rows(
            [merged], scan_level_rows([merged], align)))
        assert any((unpadded[key] != want[key]).any()
                   for key in want if key.endswith("bias"))


# a bf16 step's loss: the port's bf16 predictions are JAX's but for one
# ulp in 2 of the 32 (the same 2 where the port's evaluation of each
# design alone differs from JAX's jitted model), which moves the
# 21-entry loss by 4.4e-4 of itself (measured)
BF16_LOSS_RTOL = 1e-3


def _load_jax_state(model, state, jstate):
    """The port's parameters and flat Adam state set to JAX's."""
    model.load_state_dict(params_from_flax(to_np(jstate.params)))
    opt = jstate.opt_state
    state.optimizer.load_state_dict({
        "mu": _port_flat(opt["mu"], jstate.params, model),
        "nu": _port_flat(opt["nu"], jstate.params, model),
        "count": int(opt["count"])})


@functools.lru_cache(maxsize=None)
def _no_cnn_f32_grads():
    """The first gradients of the ``no_cnn`` model's float32 multi-design
    step, the port's: within 6.3e-7 x max |g| of JAX's (measured; the
    same walk and head as ``reg``'s, held against JAX in
    :func:`test_multidesign_steps_match_jax`), which moves a leaf's
    bf16-to-float32 distance by 2.5e-5 of itself."""
    _model, state, stacked, ids, mask = _port("no_cnn")
    multidesign_train_step(state, stacked, ids, mask)
    return {k: p.grad.numpy().copy()
            for k, p in state.model.named_parameters()}


def _f32_gaps(want16):
    """JAX's bf16-to-float32 distance of each leaf of the ``no_cnn``
    model's first gradients, its float32 side the float32 step's
    (:func:`_no_cnn_f32_grads`; one device's and the design-sharded
    step's agree to float32 rounding)."""
    want32 = _no_cnn_f32_grads()
    return {key: float(np.abs(np.asarray(w, np.float64) - np.asarray(
        want32[key], np.float64)).mean()) for key, w in want16.items()}


@pytest.mark.parametrize("name", ["reg", "no_cnn"])
def test_bf16_multidesign_matches_jax(name):
    """The bf16 model (JAX's padded scan's rounding) on the random
    designs, BF16_STEPS steps, each from JAX's state before it (Adam
    moves a weight by about LR whatever its gradient's size, so a flipped
    sign would compound). ``no_cnn`` (the model without its layout CNN):
    the evaluation's predictions equal to JAX's, the losses at rtol 1e-5,
    the first step's gradients at F4's bound on the walk's leaves and the
    head's weights (``_assert_bf16_grads``; measured 0) and 0.1 x max
    |g| on the head's biases. ``reg``: with the layout CNN, whose bf16
    under ``jax.jit`` is not the port's, the predictions within 4 bf16
    ulps of max |out| of JAX's and within REL_GAP x JAX's float32
    distance, the losses at rtol BF16_LOSS_RTOL, every leaf within 0.1 x
    max |g| (``tests/test_torch_bf16_model.py``'s bound for a leaf; its
    0.02 for a product's weight holds only where the predictions are
    JAX's bit for bit, and here 2 of 32 are an ulp apart: Conv_1's
    weight moves by 0.034 x)."""
    from test_torch_bf16_model import _bf16_ulp

    model, state, stacked, ids, mask = _port(name, "bfloat16")
    want = _jax_eval(name, jnp.bfloat16)[0]
    got = multidesign_eval_step(model, stacked, ids, mask)[0].numpy()
    if name == "no_cnn":
        np.testing.assert_array_equal(got, want)
    else:
        ulp = _bf16_ulp(float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= 4 * ulp
        assert_near_jax_bf16(got, want, _jax_eval(name)[0], "predictions")
    jmets, jstates, want16 = _jax_steps(name, jnp.bfloat16,
                                        steps=BF16_STEPS)
    for t, want_mets in enumerate(jmets):
        _load_jax_state(model, state, jstates[t])
        mets = multidesign_train_step(state, stacked, ids, mask)
        np.testing.assert_allclose(
            float(mets["loss"]), want_mets["loss"],
            rtol=1e-5 if name == "no_cnn" else BF16_LOSS_RTOL,
            err_msg=f"step {t}")
        if t:
            continue
        grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
        if name == "no_cnn":
            _assert_bf16_grads(grads, want16, _f32_gaps(want16), name,
                               _tight_vs_jax)
        else:
            _assert_bf16_grads(grads, want16, {}, name, lambda key: False)


# ---- the design-sharded step at dp 2 ----

# per case: the model and its compute dtype
SHARDED = {"f32": ("reg", None), "bf16": ("no_cnn", "bfloat16"),
           "bf16_cnn": ("reg", "bfloat16")}
# each design-sharded rank's designs at dp 2
BLOCKS = ((0, 2), (2, 4))


def _jax_block_grads(name, dtype):
    """``jax.jit(jax.grad(...))`` of each block's share of JAX's
    multi-design loss at the init, a design-sharded device's gradient
    before the sum: its designs' masked squared errors (vmapped, as
    ``prtp_tpu/parallel/multi.py`` runs them) over the global count, as
    ``metrics.mse_loss`` divides."""
    model = _jax_model(name, dtype)
    params = jax.tree_util.tree_map(jnp.asarray, _init(name))
    stack = _jax_stack(dtype)
    ids, mask = (jnp.asarray(x) for x in _batch(_designs()))
    count = jnp.maximum(mask.sum(), 1.0)

    def share(p, designs, ids, mask):
        preds = jmulti._batched_forward(model, p, designs, ids)
        endpoints = jax.vmap(lambda d, i: d.path_endpoint[i])(designs, ids)
        arrival = jax.vmap(lambda d, e: d.arrival_time[e])(designs,
                                                           endpoints)
        return (((preds.reshape(-1) - arrival.reshape(-1)) ** 2)
                * mask.reshape(-1)).sum() / count

    grad = jax.jit(jax.grad(share))
    return [params_from_flax(to_np(grad(
        params, jax.tree_util.tree_map(lambda a: a[lo:hi], stack),
        ids[lo:hi], mask[lo:hi]))) for lo, hi in BLOCKS]


def _port_block_grads(name, dtype):
    """The port's counterpart of :func:`_jax_block_grads`: each block's
    share of the loss, as ``multidesign_train_step`` forms it on a rank
    (the block's super-graph, the global count), backpropagated alone on
    one thread, as the child's ranks run (the CPU's convolution weight
    gradients add in another order on more)."""
    model, state, stacked, ids, mask = _port(name, dtype)
    count = mask.reshape(-1).float().sum().clamp_min(1.0)
    grads, threads = [], torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for lo, hi in BLOCKS:
            state.optimizer.zero_grad()
            design, rows = stacked.rows(lo, hi, ids[lo:hi])
            preds = model(design, rows, rounding="scan")
            local = (entry_losses("reg", preds, design, rows)
                     * mask[lo:hi].reshape(-1).float()).sum()
            (local / count).backward()
            grads.append({k: p.grad.clone()
                          for k, p in model.named_parameters()})
    finally:
        torch.set_num_threads(threads)
    return grads


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The child run of every case (two gloo ranks, started first) and,
    computed here meanwhile, JAX's design-sharded step on a 2-device mesh
    (first gradients in float32 and bf16, the float32 steps and the
    evaluation), the port's unsharded float32 steps, and JAX's and the
    port's per-block bf16 gradients of the model with its layout CNN."""
    tmp = str(tmp_path_factory.mktemp("multi"))
    cases = {name: dict(parsed=list(_designs()), task="reg", lr=LR,
                        model_kw=dict(_kw(model), compute_dtype=dtype),
                        state={k: v.numpy() for k, v in
                               params_from_flax(_init(model)).items()},
                        batch=_batch(_designs()), align=ALIGN, steps=STEPS)
             for name, (model, dtype) in SHARDED.items()}
    with open(os.path.join(tmp, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PRTP_")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen([sys.executable, CHILD, tmp], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ref = {"f32": _jax_steps("reg", sharded=True),
               "bf16": _jax_steps("no_cnn", jnp.bfloat16, True, 1),
               "bf16_cnn": _jax_steps("reg", jnp.bfloat16, True, 1),
               "eval": _jax_eval("reg"),
               "jax_blocks": _jax_block_grads("reg", jnp.bfloat16),
               "port_blocks": _port_block_grads("reg", "bfloat16")}
        _m, single, _s, ids, mask = _port("reg")
        ref["single"] = [float(multidesign_train_step(
            single, _s, ids, mask)["loss"]) for _ in range(STEPS)]
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    assert "RESULT ok" in out
    ref["ranks"] = {name: [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"),
                                      weights_only=False) for r in range(2)]
                    for name in SHARDED}
    return ref


def test_design_sharded_step_matches_jax_sharded_step(sharded):
    """Each rank at dp 2 (2 designs a rank) against JAX's step with
    ``mesh=make_mesh(2)``: float32, the evaluation's predictions and
    metrics (1e-5, against JAX's unsharded eval step, whose sharded run
    equals it to float32 rounding), the first gradients (2e-4 x max |g|), STEPS steps'
    losses and metrics and the final parameters; bf16 (the model without
    its layout CNN, ``NO_CNN``), the first step's loss (rtol 1e-5) and
    gradients, against JAX's design-sharded bf16 step, which sums each
    device's bf16 gradients over the devices and rounds the sum to bf16
    again, the walk's pair by pair inside its scan (read from the
    compiled HLO): the walk's leaves and the head's weights within F4's
    bound (``tests/test_torch_graph_shard.py``: 1e-3 x JAX's
    bf16-to-float32 distance in mean distance, 1e-4 x max |g|; measured
    0), the other leaves, the head's biases, within 0.1 x max |g| (the
    port's bf16 bias sums are not JAX's in one process either)."""
    want_preds, want_eval = sharded["eval"]
    want_mets, want_states, want_grads = sharded["f32"]
    for out in sharded["ranks"]["f32"]:
        np.testing.assert_allclose(out["preds"], np.asarray(want_preds),
                                   rtol=1e-5, atol=1e-5)
        _assert_metrics(out["eval"], want_eval, "sharded eval")
        _assert_grads(out["grads"], want_grads, "sharded")
        np.testing.assert_allclose(out["losses"],
                                   [m["loss"] for m in want_mets], rtol=1e-5)
        _assert_params(out["params"],
                       params_from_flax(to_np(want_states[-1].params)),
                       "sharded")
    mets16, _states, want16 = sharded["bf16"]
    for out in sharded["ranks"]["bf16"]:
        np.testing.assert_allclose(out["losses"][0], mets16[0]["loss"],
                                   rtol=1e-5)
        _assert_bf16_grads(out["grads"], want16, _f32_gaps(want16),
                           "sharded bf16", _tight_vs_jax)


def test_design_sharded_bf16_rounds_the_ranks_sum(sharded):
    """The bf16 model with its layout CNN (``reg``) at dp 2: every
    gradient outside the walk (the layout CNN, ``fcn``, ``mlp_alpha``,
    ``mlp_fuse``) is the sum over the ranks of each rank's bf16 gradient
    of its designs' share of the loss, rounded to bf16 again. JAX's
    ``mesh=make_mesh(2)`` step computes that: within 1e-6 x max |g| of
    the rounded sum of its per-block gradients (:func:`_jax_block_grads`;
    the first-moment readback errs by 1e-7), while the unrounded sum
    lies over 100 x that bound away (3e-4 to 3e-3 x, measured). The port
    computes it bit for bit from its own per-block gradients. The walk's
    leaves are summed pair by pair inside the scan (held on the CNN-free
    model above). Against JAX's step, whose compiled bf16 CNN is not the
    port's, every leaf within 0.1 x max |g| and the loss at
    BF16_LOSS_RTOL, :func:`test_bf16_multidesign_matches_jax`'s bounds
    for this model."""
    want_mets, _states, want = sharded["bf16_cnn"]
    jax_blocks, port_blocks = sharded["jax_blocks"], sharded["port_blocks"]
    ranks = sharded["ranks"]["bf16_cnn"]
    for key, w in want.items():
        if key.startswith("gnn."):
            continue
        w = np.asarray(w, np.float64)
        bound = 1e-6 * (np.abs(w).max() or 1.0)
        total = jax_blocks[0][key] + jax_blocks[1][key]
        np.testing.assert_allclose(total.to(BF16).double().numpy(), w,
                                   rtol=0, atol=bound, err_msg=f"JAX {key}")
        assert np.abs(total.double().numpy() - w).max() > 100 * bound, key
        mine = (port_blocks[0][key] + port_blocks[1][key]).to(BF16).float()
        for out in ranks:
            np.testing.assert_array_equal(out["grads"][key], mine.numpy(),
                                          err_msg=f"port {key}")
    for out in ranks:
        np.testing.assert_allclose(out["losses"][0], want_mets[0]["loss"],
                                   rtol=BF16_LOSS_RTOL)
        _assert_bf16_grads(out["grads"], want, {}, "sharded bf16 cnn",
                           lambda key: False)


@pytest.mark.parametrize("name", list(SHARDED))
def test_design_sharded_ranks_stay_equal(sharded, name):
    """Both ranks hold the same parameters after each step and print the
    same losses; in float32 the losses are the port's unsharded steps'
    (rtol 1e-5)."""
    ranks = sharded["ranks"][name]
    assert ranks[0]["checksums"] == ranks[1]["checksums"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_array_equal(ranks[0]["preds"], ranks[1]["preds"])
    if name == "f32":
        np.testing.assert_allclose(ranks[0]["losses"], sharded["single"],
                                   rtol=1e-5)


# ---- refusals ----

def test_unet_is_refused_with_jax_message():
    """Both steps refuse a U-Net model, with JAX's NotImplementedError
    text; a U-Net without its CNN (``use_cnn=False``) is not refused."""
    with pytest.raises(NotImplementedError) as jax_err:
        jmulti.make_multidesign_train_step(
            JaxPathModel(unet=True, **MODEL_KW), optax.sgd(1.0))
    unet = PathModel(10, 3, unet=True, **MODEL_KW)
    _m, state, stacked, ids, mask = _port("reg")
    state.model = unet
    with pytest.raises(NotImplementedError) as err:
        multidesign_train_step(state, stacked, ids, mask)
    assert str(err.value) == str(jax_err.value)
    with pytest.raises(NotImplementedError, match="BatchNorm running stats"):
        multidesign_eval_step(unet, stacked, ids, mask)
    no_cnn = PathModel(10, 3, unet=True, use_cnn=False, **MODEL_KW)
    preds, _mets = multidesign_eval_step(no_cnn, stacked, ids, mask)
    assert preds.shape == ids.shape


def test_design_axis_not_divisible_by_the_mesh_is_refused():
    """K = 4 designs on a mesh of 3 ranks is refused before any
    collective, as JAX's sharding of the design axis refuses it; ids
    of another K are refused too."""
    model, state, stacked, ids, mask = _port("reg")
    with pytest.raises(ValueError, match="divisible by the mesh's 3"):
        multidesign_train_step(state, stacked, ids, mask, mesh=Mesh(3, 0))
    with pytest.raises(ValueError, match="divisible by the mesh's 3"):
        multidesign_eval_step(model, stacked, ids, mask, mesh=Mesh(3, 1))
    with pytest.raises(ValueError, match=r"\(K, B\) with K = 4"):
        multidesign_eval_step(model, stacked, ids[:3], mask[:3])


def _refused(what):
    """Two parsed designs JAX cannot stack."""
    a, b = _designs()[:2]
    if what == "feature widths":
        b = dict(b, cell_feat=np.concatenate(
            [b["cell_feat"], b["cell_feat"][:, :1]], axis=1))
    if what == "raster shape":
        b = dict(b, cnn_input=b["cnn_input"][:, :32, :32])
    if what == "merged":
        b = merge_parsed_designs([a, b])
    return [a, b]


@pytest.mark.parametrize("what", ["feature widths", "raster shape",
                                  "merged"])
def test_stack_designs_refuses_what_jax_cannot_stack(what):
    """``stack_designs`` refuses designs of other feature widths or raster
    shapes (JAX: "designs must share a treedef", or ``jnp.stack``'s shape
    error) and a merged super-graph."""
    with pytest.raises(ValueError, match="merged super-graph" if
                       what == "merged" else what):
        stack_designs(_refused(what), device="cpu")
