"""The walk's second bf16 rounding, ``rounding="scan"``, against the JAX
package's padded scan, on the CPU.

Under ``--compute_dtype bfloat16`` JAX evaluates through its padded
scan in most places (its test CLI always; validation unless
``--exact_levels`` with at most one validation design). The scan's
``_PairStep`` runs each pair-step MLP as flax's ``MLP(dtype=bfloat16)``:
each Dense's product rounded to bf16, its bias sum rounded again, the
hidden ReLU in bf16; its fused exact walk keeps those products float32.
Compiled (the scan's body always is; ``_PairStep`` under ``jax.jit``),
XLA keeps the output layer's bias sum in float32, since its only reader
is the half's float32 sum: it drops a rounding to bf16 whose value is
converted straight back (excess precision, its default). The port's
walk computes either (``ops/fused_gnn.py``):

- bit for bit, on inputs whose float32 sums are exact (few mantissa
  bits, as in ``tests/test_torch_bf16.py``): the pair-step MLP against
  flax's, alone and inside a jitted float32 sum, and a two-pair walk,
  whose mailboxes hold one grid-valued source each, against JAX's
  ``_PairStep`` run pair by pair under ``jax.jit``: so the only roundings
  left are the MLPs' and the promotions of the two half sums;
- on random inputs, the tiny walk and the whole model against JAX's
  ``_PairStep`` walk and padded-scan ``PathModel``: the port's mean
  distance at most ``REL_GAP`` x the distance between JAX's own two
  bf16 paths (padded scan and fused exact walk) on the same inputs;
- the walk's backward runs in this rounding (its gradients against
  JAX's: ``tests/test_torch_bf16_scan_grad.py``);
- the train CLI picks the rounding by JAX's rule.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.graph import pack_leveled_graph_exact as jax_pack_exact
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.models.gnn import TimeGNN as JaxTimeGNN
from prtp_tpu.models.mlp import MLP as JaxMLP
from prtp_tpu_torch.graph import pack_design, pack_leveled_graph_exact
from prtp_tpu_torch.models import PathModel, TimeGNN
from prtp_tpu_torch.ops.bf16 import BF16
from prtp_tpu_torch.ops.fused_gnn import _mlp, check_rounding
from prtp_tpu_torch.train import eval_rounding
from prtp_tpu_torch.utils.convert import params_from_flax

from test_torch_bf16 import (REL_GAP, _differ, _grid, _np,  # noqa: F401
                             no_launches)
from test_torch_bf16_model import MODEL_KW, _wide_parsed
from test_torch_convert import jax_params

OUT, HID = 16, 32


def _port_gnn(params, cell_feat_dim, net_feat_dim=3):
    gnn = TimeGNN(cell_feat_dim, net_feat_dim,
                  torch.Generator().manual_seed(0), out_dim=OUT,
                  hidden_dim=HID, mlp_dtype="bfloat16")
    state = params_from_flax({"gnn": params})
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()})
    return gnn


def _grid_mlp(rng, din):
    """flax MLP((HID, OUT)) parameters on a grid: kernels multiples of
    1/16 in [-1, 1], biases of 1/128 in [-4, 4]. With inputs multiples of
    1/8 in [-4, 4] and din <= 16, the first product is a multiple of
    2^-7 below 2^6 (13 bits: exact in float32, rounded by bf16), the
    hidden a multiple of 2^-7, the second product a multiple of 2^-11
    below 2^12 (23 bits): every float32 sum is exact in any order."""
    return {"fc0": {"kernel": _grid(rng, (din, HID), 16, 1 / 16),
                    "bias": _grid(rng, (HID,), 512, 1 / 128)},
            "fc1": {"kernel": _grid(rng, (HID, OUT), 16, 1 / 16),
                    "bias": _grid(rng, (OUT,), 512, 1 / 128)}}


def _torch_mlp(p):
    return (torch.tensor(p["fc0"]["kernel"].T.copy()),
            torch.tensor(p["fc0"]["bias"]),
            torch.tensor(p["fc1"]["kernel"].T.copy()),
            torch.tensor(p["fc1"]["bias"]))


@pytest.mark.parametrize("din", [10, 16, 3])
def test_pair_step_mlp_scan_rounding_is_flax_bit_for_bit(din):
    """``_mlp`` with ``scan=True`` against ``_PairStep``'s flax
    ``MLP((hidden, out), dtype=bfloat16)``, at the widths of the three
    pair-step MLPs, 0 elements different: rounded to bf16, the MLP's
    output; plus a float32 term ``t``, the jitted ``mlp(x) + t`` (which
    keeps the output's bias sum float32, where flax op by op rounds it:
    most elements differ). The fused rounding (float32 products) differs
    in most elements, so the test sees the products' rounding too."""
    rng = np.random.default_rng(din)
    p = _grid_mlp(rng, din)
    x = _grid(rng, (64, din), 32, 1 / 8)
    t = _grid(rng, (64, OUT), 32, 1 / 8)
    mlp = JaxMLP((HID, OUT), dtype=jnp.bfloat16)
    want = mlp.apply({"params": p}, jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    want_sum = jax.jit(lambda p, x, t: mlp.apply({"params": p}, x) + t)(
        p, jnp.asarray(x), jnp.asarray(t))
    assert want_sum.dtype == jnp.float32
    assert _differ(want_sum, _np(want) + t) > want.size // 2
    tp = _torch_mlp(p)
    w16 = (tp[0].to(BF16), tp[2].to(BF16))
    got = _mlp(tp, torch.tensor(x), w16, scan=True)
    assert got.dtype == torch.float32
    assert _differ(got.to(BF16), want) == 0
    assert _differ(got + torch.tensor(t), want_sum) == 0
    fused = _mlp(tp, torch.tensor(x), w16)
    assert fused.dtype == torch.float32
    assert _differ(fused.to(BF16), want) > want.size // 2


def _grid_design():
    """Four levels (two pairs) whose every cell and net input comes from
    a level-0 node: each mailbox of pair 1 holds one source, whose h is
    relu(h0), a grid value; so the softmax and the mean return it
    exactly. Level 3's nets read level 0 from below their pair's cell
    block (the prior-row gather)."""
    rng = np.random.default_rng(3)
    sizes = [6, 5, 7, 4]
    ids = np.split(np.arange(sum(sizes)), np.cumsum(sizes)[:-1])
    empty = np.zeros(0, np.int64)
    src_l1 = rng.integers(0, sizes[0], sizes[1])
    src_l2 = rng.integers(0, sizes[0], sizes[2])
    src_l3 = rng.integers(0, sizes[0], sizes[3])
    n = sum(sizes)
    return {
        "num_nodes": n,
        "levels": [(i, empty, empty) for i in ids],
        "cell_feat": _grid(rng, (n, 10), 32, 1 / 8),
        "net_feat": _grid(rng, (n, 3), 32, 1 / 8),
        "cell_edges": (src_l2, ids[2]),
        "net_edges": (np.concatenate([src_l1, src_l3]),
                      np.concatenate([ids[1], ids[3]])),
    }


def test_grid_walk_scan_rounding_is_jax_pair_step_bit_for_bit():
    """The port's bf16 walk with ``rounding="scan"`` against JAX's
    ``TimeGNN(mlp_dtype=bfloat16, fused_vjp=False)`` on the exact pack
    under ``jax.jit``, which runs ``_PairStep`` pair by pair, compiled as
    the scan's body is: the pair-step MLPs round as the padded scan's,
    and each half's sum promotes as jnp promotes ``h_self + gate *
    fc_cell_neigh(neigh)`` (a float32 ``gate``) and ``fc_net_self(
    net_feat) + neigh_n`` (a float32 ``neigh_n``) to float32. On the grid
    design every other operation is exact, so h is equal bit for bit.
    The fused rounding differs, and so does ``_PairStep`` op by op (flax
    rounds the MLPs' outputs there)."""
    parsed = _grid_design()
    graph, _rows, num_rows = pack_leveled_graph_exact(parsed, "cpu")
    g_jax, _r, num_rows_jax = jax_pack_exact(parsed)
    assert num_rows == num_rows_jax and graph.num_pairs == 2
    assert graph.gather_rows[1].numel() > graph.cell_mail[1].numel()
    rng = np.random.default_rng(4)
    params = {"pair_step": {name: _grid_mlp(rng, din) for name, din in (
        ("fc_cell_self", 10), ("fc_cell_neigh", OUT), ("fc_net_self", 3))}}
    h0 = _grid(rng, (num_rows + 1, OUT), 32, 1 / 8)
    jax_gnn = JaxTimeGNN(out_dim=OUT, hidden_dim=HID, fused_vjp=False,
                         mlp_dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(jax_gnn.apply)({"params": params}, g_jax,
                                             jnp.asarray(h0)))
    eager = jax_gnn.apply({"params": params}, g_jax, jnp.asarray(h0))
    gnn = _port_gnn(jax.tree_util.tree_map(np.asarray, params), 10)
    with torch.no_grad():
        got = gnn(graph, torch.tensor(h0), rounding="scan")
        fused = gnn(graph, torch.tensor(h0))
    assert got.dtype == torch.float32
    assert _differ(got, want) == 0
    assert _differ(fused, want) > 0
    assert _differ(eager, want) > 0


def _rounding_gap(got, scan, fused, what):
    """The port's mean distance from JAX's padded-scan bf16 ``scan``,
    at most REL_GAP x the distance between JAX's two bf16 paths."""
    got, scan, fused = _np(got), _np(scan), _np(fused)
    assert got.shape == scan.shape == fused.shape, what
    assert np.all(np.isfinite(got)), what
    gap = float(np.abs(scan - fused).mean())
    dist = float(np.abs(got - scan).mean())
    assert gap > 0, f"{what}: JAX's two bf16 paths agree, the test is blind"
    assert dist <= REL_GAP * gap, (
        f"{what}: {dist:.3g} from JAX's padded scan, whose distance from "
        f"its fused walk is {gap:.3g} (allowed {REL_GAP} x)")
    return dist, gap


def test_walk_scan_rounding_matches_jax_scan_walk():
    """On a random design, jittered weights and a random h0: the port's
    bf16 walk with ``rounding="scan"`` against JAX's jitted ``_PairStep``
    walk,
    and with the fused rounding against JAX's fused exact walk, each
    within REL_GAP x the distance between JAX's two."""
    parsed = _wide_parsed()
    graph = pack_design(parsed, map_size=16, device="cpu").graph
    g_jax = jax_pack_design(parsed, map_size=16, exact_levels=True,
                            cnn_patches=False).graph
    variables = jax.jit(JaxTimeGNN(out_dim=OUT, hidden_dim=HID).init)(
        jax.random.PRNGKey(0), g_jax)
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    params = jax.tree_util.tree_unflatten(
        treedef, [l + 0.1 * jax.random.normal(k, l.shape, l.dtype)
                  for l, k in zip(leaves, keys)])["params"]
    h0 = (0.3 * np.random.default_rng(8).normal(
        size=(graph.num_rows + 1, OUT))).astype(np.float32)
    want = {fused: np.asarray(jax.jit(JaxTimeGNN(
        out_dim=OUT, hidden_dim=HID, fused_vjp=fused,
        mlp_dtype=jnp.bfloat16).apply)({"params": params}, g_jax,
                                       jnp.asarray(h0)))
        for fused in (False, True)}
    gnn = _port_gnn(jax.tree_util.tree_map(np.asarray, params), 10)
    with torch.no_grad():
        got = {r: gnn(graph, torch.tensor(h0), rounding=r)
               for r in ("scan", "fused")}
    _rounding_gap(got["scan"], want[False], want[True], "h, scan")
    _rounding_gap(got["fused"], want[True], want[False], "h, fused")


@pytest.mark.parametrize("name", ["reg", "attn"])
def test_model_scan_rounding_matches_jax_padded_scan(name):
    """The whole bf16 model on every path of a 120-path design: the
    port's ``rounding="scan"`` against JAX's ``PathModel`` on its padded
    pack (the padded scan, as JAX's test CLI evaluates), within REL_GAP x
    the distance from JAX's same model on its exact pack (the fused
    walk); the port's fused rounding holds the other way round."""
    kw = dict(MODEL_KW, **({"flag_attn": True, "num_heads": 2}
                           if name == "attn" else {}))
    parsed = _wide_parsed()
    exact = jax_pack_design(parsed, map_size=16, exact_levels=True,
                            cnn_patches=False)
    padded = jax_pack_design(parsed, map_size=16, align=8, cnn_patches=False)
    pids = jnp.arange(exact.num_paths, dtype=jnp.int32)
    variables = jax_params(JaxPathModel(**kw), exact, pids)
    jmodel = JaxPathModel(compute_dtype=jnp.bfloat16, **kw)
    scan = np.asarray(jmodel.apply(variables, padded, pids))
    fused = np.asarray(jmodel.apply(variables, exact, pids))
    model = PathModel(10, 3, compute_dtype="bfloat16", **kw)
    model.load_state_dict(params_from_flax(variables["params"]))
    design = pack_design(parsed, map_size=16, device="cpu")
    ids = torch.arange(design.num_paths)
    with torch.no_grad():
        got = {r: model(design, ids, rounding=r) for r in ("scan", "fused")}
    _rounding_gap(got["scan"], scan, fused, f"{name} predictions, scan")
    _rounding_gap(got["fused"], fused, scan, f"{name} predictions, fused")


def test_walk_backward_refuses_flax_rounding():
    """A bf16 walk with ``rounding="scan"`` has a backward, whose MLP
    gradients differ from the fused rounding's; in float32 both roundings
    are one function, gradients included. A rounding that names neither
    is refused."""
    parsed = _wide_parsed()
    design = pack_design(parsed, map_size=16, device="cpu")
    for dtype in ("bfloat16", None):
        grads = {}
        for rounding in ("scan", "fused"):
            model = PathModel(10, 3, compute_dtype=dtype, **MODEL_KW)
            out = model(design, torch.arange(design.num_paths),
                        rounding=rounding)
            out.sum().backward()
            grads[rounding] = model.gnn.fc_cell_self.fc0.weight.grad
            assert torch.isfinite(grads[rounding]).all()
        same = torch.equal(grads["scan"], grads["fused"])
        assert same == (dtype is None), dtype
    with pytest.raises(ValueError, match="rounding"):
        check_rounding("bf16")


@pytest.mark.parametrize("exact_levels,n_val,want", [
    (False, 1, "scan"), (False, 3, "scan"), (True, 0, "fused"),
    (True, 1, "fused"), (True, 2, "scan")])
def test_validation_rounding_follows_jax_rule(exact_levels, n_val, want):
    """JAX validates bf16 through its fused exact walk only under
    ``--exact_levels`` with at most one validation design
    (``prtp_tpu/train.py:154-206``); ``--scan_groups`` without it packs
    for the grouped scan, which rounds as the padded scan does."""
    options = argparse.Namespace(exact_levels=exact_levels, scan_groups=2)
    assert eval_rounding(options, [f"d{i}" for i in range(n_val)]) == want
