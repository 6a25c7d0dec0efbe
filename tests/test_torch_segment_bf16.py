"""bf16 under the segment reduce (``PathModel(gnn_reduce="segment",
compute_dtype="bfloat16")``, with and without ``--attn``) in the port
against the JAX package's segment model, on the CPU at small sizes.

JAX runs the segment reduce only through its padded scan (its exact walk
asserts the mailbox reduce, ``prtp_tpu/models/gnn.py:311-312``), so the
port's bf16 segment walk rounds as that scan does, forward and backward:
its three pair-step MLPs are flax's ``MLP(dtype=bfloat16)`` as XLA
compiles them and their ``jax.grad`` (``ops/fused_gnn.py::_mlp``,
``_mlp_grads``), the bias gradients bf16 sums over the scan's padded
level rows, and the carry, the scores and every reduce float32.

- On grid designs whose every float32 sum is exact (one grid-valued
  source a mailbox), h_final, the twelve MLP gradients and h0's
  cotangent bit for bit against ``jax.jit`` of JAX's padded-scan segment
  ``TimeGNN(mlp_dtype=bfloat16, reduce_mode="segment")``, on levels
  shorter and longer than XLA's summation window of 32 rows.
- On a random design with levels longer than a window, with 0 and 2
  heads: h and each gradient (``fc_attn2``'s too) within ``REL_GAP`` x
  the distance between JAX's bf16 and float32 segment scans, in mean
  distance. The segment sums run in another order than XLA's
  scatter-add, so where a sum is rounded to bf16 after it (an MLP's
  input), an element can round an ulp the other way: a bound on the
  largest element could not tell that from a misplaced rounding.
- The bf16 segment ``PathModel`` through ``test.evaluate_design`` and
  ``test.evaluate`` against JAX's model on its padded pack, with and
  without ``--attn``, and two train steps (one design, a merged
  super-graph) against
  JAX's ``make_train_step``, at ``tests/test_torch_bf16_model.py``'s
  bounds; every entry point's default rounding is the scan's.
- The bf16 pack with the flat edge tables against JAX's bf16 padded
  pack; ``rounding="fused"`` under the segment reduce in bf16 raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu import trainer as jtrainer
from prtp_tpu.graph import merge_parsed_designs as jax_merge
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.graph import pack_leveled_graph as jax_pack_padded
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.models.gnn import TimeGNN as JaxTimeGNN
from prtp_tpu_torch import test as port_test
from prtp_tpu_torch import trainer
from prtp_tpu_torch.data.random_design import make_random_design
from prtp_tpu_torch.graph import (merge_parsed_designs, pack_design,
                                  pack_leveled_graph_exact, scan_pair_rows)
from prtp_tpu_torch.models import PathModel, TimeGNN
from prtp_tpu_torch.utils.convert import params_from_flax

from test_torch_bf16 import (BF, REL_GAP, _grid, _np,  # noqa: F401
                             assert_near_jax_bf16, no_launches)
from test_torch_bf16_eval import HID, OUT, _grid_design
from test_torch_bf16_model import (BATCH, LR, MODEL_KW, _bf16_ulp,
                                   _jax_state, _port_flat, _wide_parsed)
from test_torch_bf16_scan_grad import (GROUPED_LEVELS, _on_rows, _to_rows,
                                       grid_levels_design, grid_params)
from test_torch_convert import jax_params

import _torch_threads  # noqa: F401  (one torch thread a worker)

# JAX's padded pack's alignment: its levels pad to multiples of 8 rows,
# which the bias gradients' bf16 sums count
ALIGN = 8
KW = dict(MODEL_KW, gnn_reduce="segment")
STEPS = 2
LOSS_RTOL = 1e-4


def _port_gnn(params, cell_feat_dim, nh=0, dtype="bfloat16"):
    gnn = TimeGNN(cell_feat_dim, 3, torch.Generator().manual_seed(0),
                  out_dim=OUT, hidden_dim=HID, flag_attn=nh > 0,
                  num_heads=max(nh, 1), mlp_dtype=dtype,
                  reduce_mode="segment")
    state = params_from_flax({"gnn": jax.tree_util.tree_map(np.asarray,
                                                            params)})
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()})
    return gnn


def _jax_walk(parsed, params, h0n, cot, nh=0, dtype=jnp.bfloat16):
    """JAX's padded-scan segment walk (pack aligned to ALIGN) under
    ``jax.jit``: h_final, the gradients of ``sum(h * cot)`` and h0's
    cotangent, per node."""
    g, rows, num_rows = jax_pack_padded(parsed, align=ALIGN)
    model = JaxTimeGNN(out_dim=OUT, hidden_dim=HID, flag_attn=nh > 0,
                       num_heads=max(nh, 1), mlp_dtype=dtype,
                       reduce_mode="segment")
    g_cot = jnp.asarray(_to_rows(cot, rows, num_rows))

    def loss(p, h0):
        h = model.apply({"params": p}, g, h0)
        return (h * g_cot).sum(), h

    (_l, h), (d_p, d_h0) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(_to_rows(h0n, rows, num_rows)))
    out = {k: v.numpy() for k, v in params_from_flax(
        {"gnn": jax.tree_util.tree_map(np.asarray, d_p)}).items()}
    out["d_h0"] = _on_rows(np.asarray(d_h0), rows, num_rows)[:-1]
    out["h"] = _on_rows(np.asarray(h), rows, num_rows)[:-1]
    return out


def _port_walk(parsed, params, h0n, cot, nh=0, dtype="bfloat16"):
    """The port's segment walk on its exact pack, with JAX's padded level
    rows, at the model's default rounding: as :func:`_jax_walk`."""
    graph, rows, num_rows = pack_leveled_graph_exact(
        parsed, "cpu", scan_rows=scan_pair_rows(parsed, align=ALIGN),
        segment=True)
    gnn = _port_gnn(params, parsed["cell_feat"].shape[1], nh, dtype)
    h0 = torch.tensor(_to_rows(h0n, rows, num_rows), requires_grad=True)
    hf = gnn(graph, h0)
    (hf * torch.tensor(_to_rows(cot, rows, num_rows))).sum().backward()
    out = {f"gnn.{k}": p.grad.numpy() for k, p in gnn.named_parameters()}
    out["d_h0"] = _on_rows(h0.grad.numpy(), rows, num_rows)[:-1]
    out["h"] = _on_rows(hf.detach().numpy(), rows, num_rows)[:-1]
    return out


@pytest.mark.parametrize("which", ["short", "long"])
def test_grid_segment_walk_is_jax_padded_scan_bit_for_bit(which):
    """On a grid design (``tests/test_torch_bf16_eval.py``'s, levels of
    4-7 rows; or levels of 40-80 rows, padded to 48-80, whose bias sums
    span windows), every float32 sum exact: the port's bf16 segment walk
    against JAX's padded-scan segment walk, 0 elements different in h,
    the twelve MLP gradients and h0's cotangent. The port's float32 walk
    differs."""
    parsed = (_grid_design() if which == "short"
              else grid_levels_design(GROUPED_LEVELS))
    rng = np.random.default_rng(4)
    params = grid_params(rng)
    n = parsed["num_nodes"]
    h0n = _grid(rng, (n + 1, OUT), 32, 1 / 8)
    cot = _grid(rng, (n + 1, OUT), 32, 1 / 8)
    want = _jax_walk(parsed, params, h0n, cot)
    got = _port_walk(parsed, params, h0n, cot)
    f32 = _port_walk(parsed, params, h0n, cot, dtype=None)
    assert sorted(got) == sorted(want) and len(want) == 14
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert sum((f32[k] != want[k]).any() for k in want) >= 10


@functools.lru_cache(maxsize=None)
def _walk_case():
    """A random design whose levels (36-70 rows) are longer than a
    window, and jittered weights of a 2-head ``--attn`` walk, whose tree
    holds the softmax walk's (every leaf but ``fc_attn2``'s)."""
    parsed = make_random_design([40, 50, 70, 40, 60, 36], cell_feat_dim=10,
                                net_feat_dim=3, map_size=16, cnn_hw=64,
                                mask_nnz_per_path=10, seed=2)
    g_jax = jax_pack_padded(parsed, align=ALIGN)[0]
    v = jax.jit(JaxTimeGNN(out_dim=OUT, hidden_dim=HID, flag_attn=True,
                           num_heads=2, reduce_mode="segment").init)(
        jax.random.PRNGKey(0), g_jax)
    leaves, treedef = jax.tree_util.tree_flatten(v)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    params = jax.tree_util.tree_unflatten(
        treedef, [l + 0.1 * jax.random.normal(k, l.shape, l.dtype)
                  for l, k in zip(leaves, keys)])["params"]
    return parsed, params["pair_step"]


@pytest.mark.parametrize("nh", [0, 2])
def test_segment_walk_matches_jax_padded_scan(nh):
    """A random design whose levels (36-70 rows) are longer than a
    window, jittered weights, random h0 and cotangent: h, each gradient
    (``fc_attn2``'s with 2 heads) and h0's cotangent of the port's bf16
    segment walk within REL_GAP x the distance between JAX's bf16 and
    float32 segment scans, in mean distance."""
    parsed, params = _walk_case()
    if not nh:
        params = {k: v for k, v in params.items() if k != "fc_attn2"}
    rng = np.random.default_rng(8)
    n = parsed["num_nodes"]
    h0n = (0.3 * rng.normal(size=(n + 1, OUT))).astype(np.float32)
    cot = rng.normal(size=(n + 1, OUT)).astype(np.float32)
    params = {"pair_step": params}
    want = {dt: _jax_walk(parsed, params, h0n, cot, nh, dt)
            for dt in (jnp.bfloat16, None)}
    got = _port_walk(parsed, params, h0n, cot, nh)
    assert sorted(got) == sorted(want[None])
    assert len(got) == (15 if nh else 14)
    for key in got:
        assert_near_jax_bf16(got[key], want[jnp.bfloat16][key],
                             want[None][key], key)


def test_segment_bf16_pack_is_jax_padded_pack():
    """``pack_design(..., segment=True, compute_dtype=bfloat16)`` packs
    the feature tables and the raster in bf16, as JAX's padded pack does
    (its ``compute_dtype``): each level's feature rows equal JAX's bit for
    bit, and the flat edge tables are packed beside them."""
    parsed = _wide_parsed()
    design = pack_design(parsed, map_size=16, device="cpu",
                         compute_dtype=BF, segment=True)
    jg = jax_pack_design(parsed, map_size=16, align=ALIGN,
                         compute_dtype=jnp.bfloat16, cnn_patches=False)
    g = design.graph
    assert g.cell_src is not None and design.cnn_input.dtype == BF
    np.testing.assert_array_equal(
        _np(design.cnn_input), np.asarray(jg.cnn_input, np.float32)
        .transpose(0, 3, 1, 2))
    for half in ("cell", "net"):
        want = np.asarray(getattr(jg.graph, f"{half}_feat_lvl"), np.float32)
        for k, got in enumerate(getattr(g, f"{half}_feat_lvl")):
            assert got.dtype == BF
            np.testing.assert_array_equal(_np(got), want[k, :got.shape[0]],
                                          err_msg=f"{half} level pair {k}")


# ---- the model ----

VARIANTS = {"reg": {}, "attn": dict(flag_attn=True, num_heads=2)}


@functools.lru_cache(maxsize=None)
def _init():
    """The 120-path design, JAX's padded float32 pack of it and a
    jittered init of the ``--attn`` model, whose tree holds the other
    variants' (every leaf but ``fc_attn2``'s)."""
    parsed = _wide_parsed()
    padded = jax_pack_design(parsed, map_size=KW["map_size"], align=ALIGN,
                             cnn_patches=False)
    variables = jax_params(JaxPathModel(**KW, **VARIANTS["attn"]), padded,
                           jnp.arange(padded.num_paths, dtype=jnp.int32))
    return parsed, padded, variables


def _model_case(name):
    """The variant's design (parsed, JAX's padded pack), its keywords
    and its parameters."""
    parsed, padded, variables = _init()
    params = variables["params"]
    if name != "attn":
        params = dict(params, gnn=dict(params["gnn"], pair_step={
            k: v for k, v in params["gnn"]["pair_step"].items()
            if k != "fc_attn2"}))
    return parsed, padded, dict(KW, **VARIANTS.get(name, {})), {
        "params": params}


def _port_model(kw, variables, dtype="bfloat16"):
    model = PathModel(10, 3, compute_dtype=dtype, **kw)
    model.load_state_dict(params_from_flax(variables["params"]))
    return model


@pytest.mark.parametrize("name", list(VARIANTS))
def test_segment_bf16_model_evaluates_as_jax(name):
    """The bf16 segment model on every path of a 120-path design, through
    ``test.evaluate_design`` (which packs it) and ``test.evaluate`` at the
    default rounding, against JAX's jitted bf16 segment ``PathModel`` on
    its padded pack: within 4 bf16 ulps of max |out| of JAX's predictions
    (the bound of ``tests/test_torch_bf16_model.py``: an element whose
    float32 sum was taken in another order rounds an ulp the other way
    and moves what follows), and within REL_GAP x the distance of JAX's
    float32 model, in mean distance."""
    parsed, padded, kw, variables = _model_case(name)
    pids = jnp.arange(padded.num_paths, dtype=jnp.int32)
    want = {dt: np.asarray(jax.jit(JaxPathModel(compute_dtype=dt, **kw).apply)(
        {"params": variables["params"]}, padded, pids))
        for dt in (jnp.bfloat16, None)}
    model = _port_model(kw, variables)
    got, _mets = port_test.evaluate_design(
        model, dict(parsed, path2level=parsed["path_level"].astype(np.int64)),
        device="cpu")
    design = pack_design(parsed, map_size=kw["map_size"], device="cpu",
                         segment=True)
    ids, mask = port_test.pad_batch(np.arange(design.num_paths),
                                    design.num_paths, "cpu")
    preds, _m = port_test.evaluate(model, design, ids, mask)
    np.testing.assert_array_equal(preds.numpy(), got)
    ulp = _bf16_ulp(float(np.abs(want[jnp.bfloat16]).max()))
    worst = float(np.abs(got - want[jnp.bfloat16]).max())
    assert worst <= 4 * ulp, f"{worst / ulp} ulps"
    assert_near_jax_bf16(got, want[jnp.bfloat16], want[None], "predictions")


def _merged_case():
    """Two designs merged into one super-graph, JAX's padded pack of it,
    the reg variant's parameters and grouped (K, B) batches of JAX's
    iterator."""
    designs = [make_random_design(sizes, cell_feat_dim=10, net_feat_dim=3,
                                  map_size=16, cnn_hw=64,
                                  mask_nnz_per_path=10, seed=s)
               for s, sizes in enumerate([[12, 40, 10, 36], [9, 30, 12, 44]])]
    merged = merge_parsed_designs(designs)
    assert merged["num_nodes"] == jax_merge(designs)["num_nodes"]
    padded = jax_pack_design(merged, map_size=16, align=ALIGN,
                             cnn_patches=False)
    rng = np.random.default_rng(0)
    batches = [(np.asarray(i), np.asarray(m)) for i, m in
               jtrainer.iterate_grouped_batches(
                   merged["path_ids_per_design"], BATCH, rng)]
    return (merged, padded, *_model_case("reg")[2:], batches)


def _single_case(name):
    parsed, padded, kw, variables = _model_case(name)
    rng = np.random.default_rng(0)
    batches = [(np.asarray(i), np.asarray(m)) for i, m in
               jtrainer.iterate_batches(np.arange(parsed["num_paths"]), 16,
                                        rng)]
    return parsed, padded, kw, variables, batches


@pytest.mark.parametrize("name", ["reg", "merged"])
def test_segment_bf16_train_steps_match_jax(name):
    """STEPS steps of the bf16 segment model (flat Adam, ``train_step`` at
    its default rounding) against JAX's ``make_train_step`` on its bf16
    segment model and padded pack, each port step from JAX's state
    before it (parameters, Adam's moments and count). The first step's
    gradients at the bounds of ``tests/test_torch_bf16_model.py``: the
    walk's leaves within REL_GAP x JAX's bf16-to-float32 distance, every
    leaf within 0.1 x its max |g| and every weight of a product within
    0.02 x. Each step's loss within rtol LOSS_RTOL of JAX's bf16 loss
    (measured up to 3.5e-5; the mailbox model's test, which measured
    equal losses, holds them at 1e-5): the segment sums run in another
    order than XLA's scatter-add, an element of h then rounds an ulp the
    other way at the head's bf16 cast, and a prediction near 0 an ulp
    apart moves a 4-path loss by that much. ``merged``: a super-graph of
    two designs on grouped (K, B) batches. (``--attn`` changes only the
    walk, whose gradients ``test_segment_walk_matches_jax_padded_scan``
    holds with 2 heads.)"""
    parsed, padded, kw, variables, batches = (
        _merged_case() if name == "merged" else _single_case(name))
    tx = jtrainer.make_optimizer(LR, flat=True)
    step16 = jtrainer.make_train_step(
        JaxPathModel(compute_dtype=jnp.bfloat16, **kw), tx, "reg",
        donate=False)

    def value_and_grad(dt):
        model = JaxPathModel(compute_dtype=dt, **kw)

        def loss_fn(q, ids, mask):
            preds = model.apply({"params": q}, padded, ids)
            return jtrainer._task_loss_and_metrics("reg", preds, padded, ids,
                                                   mask)[0]
        return jax.jit(jax.value_and_grad(loss_fn))

    jax_vg = {dt: value_and_grad(dt) for dt in (jnp.bfloat16, None)}
    model = _port_model(kw, variables)
    state = trainer.init_state(model, trainer.make_optimizer(LR), "cpu")
    design = pack_design(parsed, map_size=kw["map_size"], device="cpu",
                         compute_dtype=BF, segment=True,
                         scan_rows=scan_pair_rows(parsed, align=ALIGN))
    jstate = _jax_state(variables["params"], tx)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    assert len(batches) >= STEPS
    for t, (ids, mask) in enumerate(batches[:STEPS]):
        jids, jmask = jnp.asarray(ids), jnp.asarray(mask)
        model.load_state_dict(params_from_flax(to_np(jstate.params)))
        opt = jstate.opt_state
        state.optimizer.load_state_dict({
            "mu": _port_flat(opt["mu"], jstate.params, model),
            "nu": _port_flat(opt["nu"], jstate.params, model),
            "count": int(opt["count"])})
        if t == 0:
            want = {dt: params_from_flax(to_np(f(jstate.params, jids,
                                                 jmask)[1]))
                    for dt, f in jax_vg.items()}
        jstate, jmets = step16(jstate, padded, jids, jmask)
        mets = trainer.train_step(state, design,
                                  torch.from_numpy(ids.astype(np.int64)),
                                  torch.from_numpy(mask.copy()))
        loss, want_loss = float(mets["loss"]), float(jmets["loss"])
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL,
                                   err_msg=f"step {t}")
        if t == 0:
            for key, p in model.named_parameters():
                assert p.dtype == p.grad.dtype == torch.float32, key
                w16 = _np(want[jnp.bfloat16][key])
                bound = (0.02 if p.ndim > 1 else 0.1) * np.abs(w16).max()
                np.testing.assert_allclose(_np(p.grad), w16, rtol=0,
                                           atol=bound, err_msg=key)
                if key.startswith("gnn."):
                    assert_near_jax_bf16(p.grad, w16, want[None][key],
                                         f"gradient of {key}")


# ---- the rounding's API ----

def test_segment_bf16_refuses_the_fused_rounding():
    """A bf16 segment model resolves the default rounding (None) to the
    scan's and refuses ``"fused"``, naming JAX's assertion, at the model
    and through ``trainer.train_step``; the float32 segment model and the
    bf16 mailbox model keep both, the mailbox model's default the fused
    walk's. An unknown reduce is refused."""
    seg = TimeGNN(10, 3, torch.Generator(), mlp_dtype="bfloat16",
                  reduce_mode="segment")
    assert seg.resolve_rounding(None) == seg.resolve_rounding("scan") == "scan"
    with pytest.raises(ValueError, match="311-312"):
        seg.resolve_rounding("fused")
    f32 = TimeGNN(10, 3, torch.Generator(), reduce_mode="segment")
    assert [f32.resolve_rounding(r) for r in (None, "fused", "scan")] == [
        "scan", "fused", "scan"]
    mailbox = TimeGNN(10, 3, torch.Generator(), mlp_dtype="bfloat16")
    assert [mailbox.resolve_rounding(r) for r in (None, "fused", "scan")] == [
        "fused", "fused", "scan"]
    with pytest.raises(ValueError, match="rounding"):
        f32.resolve_rounding("bf16")
    with pytest.raises(ValueError, match="reduce_mode"):
        TimeGNN(10, 3, torch.Generator(), reduce_mode="scatter")
    parsed = _wide_parsed()
    model = PathModel(10, 3, compute_dtype="bfloat16", **KW)
    state = trainer.init_state(model, trainer.make_optimizer(LR), "cpu")
    design = pack_design(parsed, map_size=16, device="cpu", compute_dtype=BF,
                         segment=True)
    ids, mask = trainer.pad_batch(np.arange(8), 8, "cpu")
    with pytest.raises(ValueError, match="mailbox reduce"):
        trainer.train_step(state, design, ids, mask, rounding="fused")
    assert torch.isfinite(trainer.train_step(state, design, ids, mask)["loss"])
