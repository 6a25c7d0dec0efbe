"""The walk's backward in the padded scan's bf16 rounding (F2b), against
the JAX package's ``jax.jit(jax.grad(...))`` of its padded-scan
``TimeGNN(mlp_dtype=bfloat16)``, on the CPU.

JAX's train CLI steps through its padded scan unless ``--exact_levels``;
there the pair-step MLPs are flax's ``MLP(dtype=bfloat16)``, and their
gradients are what XLA compiles of ``jax.grad`` (read from the compiled
HLO): cotangents rounded to bf16 where a bf16 value's convert is
transposed, weight gradients rounded, the input cotangent left float32,
and each bias gradient a bf16 sum whose every partial sum rounds, in the
tree order of XLA's CPU reduce (windows of 32 over the padded level's
rows). The port computes that in ``ops/fused_gnn.py::_mlp_grads`` and
``ops/bf16.py::column_sums_bf16``:

- the bias sums alone, bit for bit against a jitted bf16 ``lax.reduce``
  at every shape class of the tree, zero rows of a padded table included;
- on a grid design whose every float32 sum is exact, the twelve MLP
  gradients and h0's cotangent bit for bit;
- on a random design with levels longer than a window, and with
  ``--attn``: each gradient (the twelve, ``fc_attn2``'s and h0's
  cotangent) within ``REL_GAP`` x the distance between JAX's scan and
  fused-walk gradients, in mean distance, since a loose bound cannot see
  a misplaced rounding.

h0's cotangent is compared on the design's rows: JAX's scan also writes
one into the gather's dummy row, which the model never reads.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.graph import auto_scan_groups as jax_auto_scan_groups
from prtp_tpu.graph import bucket_shape
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.graph import pack_leveled_graph as jax_pack_padded
from prtp_tpu.graph import pack_leveled_graph_exact as jax_pack_exact
from prtp_tpu.graph import pack_leveled_graph_grouped as jax_pack_grouped
from prtp_tpu.models.gnn import TimeGNN as JaxTimeGNN
from prtp_tpu_torch.data.random_design import make_random_design
from prtp_tpu_torch.graph import (pack_leveled_graph_exact, scan_level_rows,
                                  scan_pair_rows)
from prtp_tpu_torch.models import TimeGNN
from prtp_tpu_torch.ops.bf16 import BF16, column_sums_bf16
from prtp_tpu_torch.train import train_rounding, train_scan_rows
from prtp_tpu_torch.utils.convert import params_from_flax

from test_torch_bf16 import REL_GAP, _grid
from test_torch_bf16_eval import HID, OUT, _grid_design, _grid_mlp

# the JAX padded pack's alignment: levels of 40-70 rows pad to 48-72,
# which moves XLA's summation windows against the port's 40-70 rows
ALIGN = 8


@pytest.mark.parametrize("n,rows", [(0, 0), (1, 1), (7, 7), (32, 32),
                                    (33, 33), (40, 72), (100, 100),
                                    (64, 128), (1100, 1100), (1030, 1200)])
def test_column_sums_are_xla_bf16_reduce(n, rows):
    """``column_sums_bf16`` against XLA's CPU reduce of a bf16 column,
    jitted as ``jax.grad`` emits it (``lax.reduce`` with ``lax.add`` in
    bf16), on ``rows`` rows whose last ``rows - n`` are zeros; 0
    elements different. A float32 sum rounded once differs."""
    rng = np.random.default_rng(n)
    v = rng.normal(size=(n, 24)).astype(np.float32)
    padded = np.zeros((rows, 24), np.float32)
    padded[:n] = v
    want = np.asarray(jax.jit(lambda x: jax.lax.reduce(
        x, jnp.bfloat16(0), jax.lax.add, (0,)))(
            jnp.asarray(padded, jnp.bfloat16)).astype(jnp.float32))
    v16 = torch.tensor(v).to(BF16)
    got = column_sums_bf16([v16, v16[:, :8]], [rows, rows])
    assert got[0].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), want[:8])
    if n > 2:
        once = v16.float().sum(0).to(BF16).float().numpy()
        assert (once != want).any()


def _on_rows(a, rows, num_rows):
    """Per node, the rows ``rows`` of a state-shaped array, and the
    dummy row last."""
    return np.concatenate([a[rows], a[num_rows:num_rows + 1]])


def _to_rows(per_node, rows, num_rows):
    out = np.zeros((num_rows + 1,) + per_node.shape[1:], per_node.dtype)
    out[rows] = per_node[:-1]
    out[num_rows] = per_node[-1]
    return out


def _jax_grads(parsed, params, h0n, cot, fused, nh=0, scan_groups=1):
    """JAX's gradients of ``sum(TimeGNN(bf16)(h0) * cot)``: the padded
    scan (``fused=False``, on a pack aligned to ALIGN), with
    ``scan_groups`` > 1 its grouped scan, or the fused exact walk,
    ``jax.jit(jax.grad(...))``; h0 and its cotangent per node."""
    if fused:
        g, rows, num_rows = jax_pack_exact(parsed)
    elif scan_groups > 1:
        g, rows, num_rows = jax_pack_grouped(parsed, num_groups=scan_groups,
                                             align=ALIGN)
    else:
        g, rows, num_rows = jax_pack_padded(parsed, align=ALIGN)
    model = JaxTimeGNN(out_dim=OUT, hidden_dim=HID, fused_vjp=fused,
                       flag_attn=nh > 0, num_heads=max(nh, 1),
                       mlp_dtype=jnp.bfloat16)
    g_cot = jnp.asarray(_to_rows(cot, rows, num_rows))

    def loss(p, h0):
        return (model.apply({"params": p}, g, h0) * g_cot).sum()

    d_p, d_h0 = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(_to_rows(h0n, rows, num_rows)))
    out = {k: v.numpy() for k, v in params_from_flax(
        {"gnn": jax.tree_util.tree_map(np.asarray, d_p)}).items()}
    out["d_h0"] = _on_rows(np.asarray(d_h0), rows, num_rows)[:-1]
    return out


def _port_grads(parsed, params, h0n, cot, rounding, nh=0, scan_rows=None):
    """The port's gradients of the same sum, its walk in ``rounding``,
    its design packed with ``scan_rows`` (default: JAX's padded level
    rows)."""
    graph, rows, num_rows = pack_leveled_graph_exact(
        parsed, "cpu",
        scan_rows=scan_rows or scan_pair_rows(parsed, align=ALIGN))
    gnn = TimeGNN(parsed["cell_feat"].shape[1], parsed["net_feat"].shape[1],
                  torch.Generator().manual_seed(0), out_dim=OUT,
                  hidden_dim=HID, flag_attn=nh > 0, num_heads=max(nh, 1),
                  mlp_dtype="bfloat16")
    state = params_from_flax({"gnn": jax.tree_util.tree_map(np.asarray,
                                                            params)})
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()})
    h0 = torch.tensor(_to_rows(h0n, rows, num_rows), requires_grad=True)
    hf = gnn(graph, h0, rounding=rounding)
    (hf * torch.tensor(_to_rows(cot, rows, num_rows))).sum().backward()
    out = {f"gnn.{k}": p.grad.numpy() for k, p in gnn.named_parameters()}
    out["d_h0"] = _on_rows(h0.grad.numpy(), rows, num_rows)[:-1]
    return out


def test_grid_walk_scan_grads_are_jax_bit_for_bit():
    """On the grid design of ``tests/test_torch_bf16_eval.py`` (each
    mailbox one grid-valued source, grid weights, h0 and cotangent; every
    float32 sum exact), the port's scan-rounding gradients against JAX's
    padded scan: 0 elements different, in each of the twelve MLP tensors
    and h0's cotangent. The fused rounding's differ."""
    parsed = _grid_design()
    rng = np.random.default_rng(4)
    params = {"pair_step": {name: _grid_mlp(rng, din) for name, din in (
        ("fc_cell_self", 10), ("fc_cell_neigh", OUT), ("fc_net_self", 3))}}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    n = parsed["num_nodes"]
    h0n = _grid(rng, (n + 1, OUT), 32, 1 / 8)
    cot = _grid(rng, (n + 1, OUT), 32, 1 / 8)
    want = _jax_grads(parsed, params, h0n, cot, fused=False)
    got = _port_grads(parsed, params, h0n, cot, "scan")
    fused = _port_grads(parsed, params, h0n, cot, "fused")
    assert sorted(got) == sorted(want) and len(want) == 13
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert sum((fused[k] != want[k]).any() for k in want) >= 6


def grid_levels_design(sizes, seed=3):
    """A design of the level ``sizes`` (an even count) whose every cell
    and net input comes from a level-0 node, as in ``_grid_design``: each
    mailbox holds one grid-valued source, so every float32 sum of the
    walk and its backward is exact; grid-valued features."""
    rng = np.random.default_rng(seed)
    ids = np.split(np.arange(sum(sizes)), np.cumsum(sizes)[:-1])
    empty = np.zeros(0, np.int64)
    n = sum(sizes)
    src = [rng.integers(0, sizes[0], len(i)) for i in ids]
    return {
        "num_nodes": n,
        "levels": [(i, empty, empty) for i in ids],
        "cell_feat": _grid(rng, (n, 10), 32, 1 / 8),
        "net_feat": _grid(rng, (n, 3), 32, 1 / 8),
        "cell_edges": (np.concatenate(src[2::2]), np.concatenate(ids[2::2])),
        "net_edges": (np.concatenate(src[1::2]), np.concatenate(ids[1::2])),
    }


def grid_params(rng):
    """The walk's grid-valued MLPs (``_grid_mlp``), as a flax tree."""
    return jax.tree_util.tree_map(jnp.asarray, {"pair_step": {
        name: _grid_mlp(rng, din) for name, din in (
            ("fc_cell_self", 10), ("fc_cell_neigh", OUT),
            ("fc_net_self", 3))}})


# levels padded to 8 rows: cells 40, 64, 48, nets 80, 64, 48; JAX's best
# two groups are pair 0 and pairs 1-2, whose nets pad to 64, not 80
GROUPED_LEVELS = [40, 80, 64, 60, 44, 42]


@pytest.mark.parametrize("scan_groups", [2, 0])
def test_grouped_scan_grads_are_jax_bit_for_bit(scan_groups):
    """``--scan_groups 2`` and ``0`` (auto): JAX packs its grouped scan,
    whose levels pad to their group's largest, so its bias gradients sum
    other rows than one bucket for the whole design. On a grid design
    whose groups pad differently from the whole, the port's gradients
    with ``scan_pair_rows`` against JAX's grouped scan: 0 elements
    different in the twelve MLP tensors and h0's cotangent; with the
    whole design's bucket, a bias gradient differs."""
    parsed = grid_levels_design(GROUPED_LEVELS)
    groups = scan_groups or jax_auto_scan_groups(
        *[[len(parsed["levels"][li][0]) for li in range(p, 6, 2)]
          for p in (0, 1)], align=ALIGN)
    assert groups == 2
    rows = scan_pair_rows(parsed, scan_groups, ALIGN)
    bucket = scan_level_rows([parsed], ALIGN)
    assert rows == ((40, 80), (64, 64), (64, 64)) and bucket == (64, 80)
    rng = np.random.default_rng(4)
    params = grid_params(rng)
    n = parsed["num_nodes"]
    h0n = _grid(rng, (n + 1, OUT), 32, 1 / 8)
    cot = _grid(rng, (n + 1, OUT), 32, 1 / 8)
    want = _jax_grads(parsed, params, h0n, cot, fused=False,
                      scan_groups=groups)
    got = _port_grads(parsed, params, h0n, cot, "scan", scan_rows=rows)
    one_bucket = _port_grads(parsed, params, h0n, cot, "scan")
    assert sorted(got) == sorted(want) and len(want) == 13
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    differ = [k for k in want if (one_bucket[k] != want[k]).any()]
    assert differ and all(k.endswith(".bias") for k in differ), differ


@pytest.mark.parametrize("nh", [0, 2])
def test_walk_scan_grads_match_jax_padded_scan(nh):
    """A random design whose levels (36-70 rows) are longer than XLA's
    summation window, jittered weights, random h0 and cotangent: each of
    the port's scan-rounding gradients lies within REL_GAP x the
    distance between JAX's padded-scan and fused-walk gradients of its
    padded scan's, in mean distance (``--attn`` with 2 heads too, whose
    ``fc_attn2`` stays float32 in both); the port's fused rounding holds
    the same way against JAX's fused walk."""
    parsed = make_random_design([40, 50, 70, 40, 60, 36], cell_feat_dim=10,
                                net_feat_dim=3, map_size=16, cnn_hw=64,
                                mask_nnz_per_path=10, seed=2)
    g_jax = jax_pack_exact(parsed)[0]
    v = jax.jit(JaxTimeGNN(out_dim=OUT, hidden_dim=HID, flag_attn=nh > 0,
                           num_heads=max(nh, 1)).init)(
        jax.random.PRNGKey(0), g_jax)
    leaves, treedef = jax.tree_util.tree_flatten(v)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    params = jax.tree_util.tree_unflatten(
        treedef, [l + 0.1 * jax.random.normal(k, l.shape, l.dtype)
                  for l, k in zip(leaves, keys)])["params"]
    rng = np.random.default_rng(8)
    n = parsed["num_nodes"]
    h0n = (0.3 * rng.normal(size=(n + 1, OUT))).astype(np.float32)
    cot = rng.normal(size=(n + 1, OUT)).astype(np.float32)
    want = {f: _jax_grads(parsed, params, h0n, cot, f, nh)
            for f in (False, True)}
    got = {f: _port_grads(parsed, params, h0n, cot,
                          "fused" if f else "scan", nh)
           for f in (False, True)}
    assert len(want[False]) == (14 if nh else 13)
    for key in want[False]:
        for f in (False, True):
            a, b, other = got[f][key], want[f][key], want[not f][key]
            assert a.dtype == np.float32 and np.all(np.isfinite(a)), key
            gap = float(np.abs(b - other).mean())
            dist = float(np.abs(a - b).mean())
            assert gap > 0, f"{key}: JAX's two bf16 walks agree"
            assert dist <= REL_GAP * gap, (
                f"{key}, {'fused' if f else 'scan'}: {dist:.3g} from JAX, "
                f"whose two bf16 walks lie {gap:.3g} apart")


def test_scan_level_rows_are_jax_bucket():
    """``scan_level_rows`` over designs equals the cell and net level
    rows of JAX's ``bucket_shape``, at its default alignment and at 8."""
    designs = [make_random_design(sizes, cell_feat_dim=10, net_feat_dim=3,
                                  map_size=16, cnn_hw=64, seed=s)
               for s, sizes in enumerate([[40, 50, 70], [12, 150, 9, 30]])]
    for align in (128, 8):
        want = bucket_shape(designs, align=align)
        assert scan_level_rows(designs, align) == (want["pn_c"],
                                                   want["pn_n"])


@pytest.mark.parametrize("scan_groups", [1, 2, 3, 0])
def test_scan_pair_rows_are_jax_packs(scan_groups):
    """``scan_pair_rows`` against the level rows of JAX's ``pack_design``
    at ``--scan_groups`` 1, 2, 3 and 0 (auto), at its default alignment
    and at 8: per pair, its group's padded cell and net rows (the grouped
    scan's ``pn_c``, ``pn_n``), or the padded scan's for every pair."""
    parsed = make_random_design([12, 150, 9, 30, 70, 40, 5, 8],
                                cell_feat_dim=10, net_feat_dim=3,
                                map_size=16, cnn_hw=64, seed=1)
    for align in (128, 8):
        g = jax_pack_design(parsed, map_size=16, align=align,
                            scan_groups=scan_groups, cnn_patches=False).graph
        want = [(sub.pn_c, sub.pn_n) for sub in getattr(g, "groups", [g])
                for _ in range(sub.num_pairs)]
        assert scan_pair_rows(parsed, scan_groups, align) == tuple(want)
    assert len(set(scan_pair_rows(parsed, 3, 8))) > 1


def test_train_scan_rows_follow_jax_packing():
    """The train CLI's packer sums the bias gradients over the rows of
    the scan JAX's train steps run: the bucket unless ``--scan_groups``,
    the design's grouped scan under ``--scan_groups 2`` or ``0`` (the
    rows that ``test_grouped_scan_grads_are_jax_bit_for_bit`` holds),
    none under ``--exact_levels``."""
    parsed = make_random_design([40, 300, 64, 60, 44, 42], cell_feat_dim=10,
                                net_feat_dim=3, map_size=16, cnn_hw=64,
                                seed=3)

    def rows(**kw):
        options = argparse.Namespace(**dict(
            dict(exact_levels=False, scan_groups=1), **kw))
        return train_scan_rows(options, parsed, bucket=(128, 512))

    assert rows() == ((128, 512),) * 3
    grouped = ((128, 384), (128, 128), (128, 128))
    assert rows(scan_groups=2) == rows(scan_groups=0) == grouped
    assert rows(exact_levels=True, scan_groups=2) is None


@pytest.mark.parametrize("exact_levels,scan_groups,want", [
    (False, 1, "scan"), (False, 0, "scan"), (False, 3, "scan"),
    (True, 1, "fused")])
def test_train_rounding_follows_jax_rule(exact_levels, scan_groups, want):
    """JAX's train steps take its fused exact walk only under
    ``--exact_levels``; otherwise its padded or grouped scan
    (``prtp_tpu/train.py:154-171``)."""
    options = argparse.Namespace(exact_levels=exact_levels,
                                 scan_groups=scan_groups)
    assert train_rounding(options) == want
