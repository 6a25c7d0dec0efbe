"""The segment reduce (``gnn_reduce='segment'``) in the port against the
JAX package, on the CPU at small sizes: the plain segment ops against
``prtp_tpu/ops/segment.py``, the three kernels' plain versions and the
segment walk's ``mailbox_scatter`` calls against the JAX expressions
they replace, the packer's flat edge tables, the
segment walk forward and backward against JAX's
``TimeGNN(reduce_mode="segment")`` on its padded pack (JAX runs the
segment reduce only on its padded scan) and against the port's mailbox
walk, a segment PathModel's evaluation and train steps against JAX's
``make_train_step``, and the refusals.

The segment reduce sums a level's edges in the packer's order, XLA in
its scatter order, so float32 values agree to rounding: each tolerance
is stated in its test.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.graph import pack_leveled_graph as jax_pack_padded
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.models.gnn import TimeGNN as JaxTimeGNN
from prtp_tpu.models.gnn import _PairStep as JaxPairStep
from prtp_tpu.ops import segment as jseg
from prtp_tpu_torch import test as port_test
from prtp_tpu_torch.graph import (merge_parsed_designs, pack_design,
                                  pack_leveled_graph_exact)
from prtp_tpu_torch.models import PathModel, TimeGNN
from prtp_tpu_torch.ops import KERNELS
from prtp_tpu_torch.ops import segment as seg
from prtp_tpu_torch.ops import segment_kernels as kern
from prtp_tpu_torch.ops.fused_gnn import MLP_NAMES
from prtp_tpu_torch.ops.segment_walk import _scatter_add, segment_gnn_forward
from prtp_tpu_torch.utils.convert import params_from_flax, params_to_flax

from helpers import make_random_leveled_graph
from test_models import _tiny_parsed_design
from test_torch_convert import jax_params, small_parsed
from test_torch_train import assert_steps_match_jax

import _torch_threads  # noqa: F401  (one torch thread a worker)

OUT, HID = 16, 32
MODEL_KW = dict(out_dim=16, hidden_dim=32, cnn_outdim=8, map_size=16,
                global_dim=8, gnn_reduce="segment")


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors the kernel wrappers run their plain versions."""
    yield
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


# ---- the plain segment ops against prtp_tpu/ops/segment.py ----

def _segment_case(seed=0, e=60, s=9, d=5):
    """JAX's conventions: edges into s - 1 real slots, slots 2 and 5
    empty, 7 padded edges at the dummy slot s - 1 reading a zero row."""
    rng = np.random.default_rng(seed)
    data = (2 * rng.normal(size=(e, d))).astype(np.float32)
    ids = rng.choice([i for i in range(s - 1) if i not in (2, 5)], size=e)
    ids[-7:] = s - 1
    data[-7:] = 0.0
    return data, ids.astype(np.int32), s


@pytest.mark.parametrize("name", ["segment_sum", "segment_max",
                                  "segment_mean", "segment_softmax_sum",
                                  "segment_softmax_sum_fused"])
def test_plain_segment_ops_match_jax(name):
    """Each op against its JAX original, padding edges and empty segments
    included (an empty segment's max is 0, its softmax sum 0): rtol 1e-6,
    atol 1e-6 (float32 sums in another order)."""
    data, ids, s = _segment_case()
    want = np.asarray(getattr(jseg, name)(jnp.asarray(data), jnp.asarray(ids),
                                          s))
    got = getattr(seg, name)(torch.from_numpy(data), torch.from_numpy(ids), s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got[[2, 5]].any()


# ---- the kernels' plain versions against the JAX expressions ----

def _csr_case(seed=1, rows=40, s=12, d=8):
    """A node state and a destination-sorted edge table with its CSR
    offsets: slots 0, 4 and 11 empty, in-degrees 1 to 5."""
    rng = np.random.default_rng(seed)
    h = (2 * rng.normal(size=(rows, d))).astype(np.float32)
    deg = rng.integers(1, 6, size=s)
    deg[[0, 4, 11]] = 0
    slot = np.repeat(np.arange(s), deg).astype(np.int32)
    src = rng.integers(0, rows, size=slot.shape[0]).astype(np.int32)
    off = np.searchsorted(slot, np.arange(s + 1)).astype(np.int32)
    return h, src, slot, off


def test_segment_softmax_sum_plain_matches_jax():
    """out is ``segment_softmax_sum_fused(h[src])``, and no statistics
    without ``partial``; ``partial`` gives the numerator, mx JAX's clamped
    ``segment_max`` and den the sum of the shifted exps. rtol/atol
    1e-6."""
    h, src, slot, off = _csr_case()
    s = off.shape[0] - 1
    msg = jnp.asarray(h)[jnp.asarray(src)]
    want = np.asarray(jseg.segment_softmax_sum_fused(msg, slot, s))
    want_mx = np.asarray(jseg.segment_max(msg, slot, s))
    want_den = np.asarray(jseg.segment_sum(
        jnp.exp(msg - want_mx[slot]), slot, s))
    t = [torch.from_numpy(x) for x in (h, src, off)]
    out, mx, den = kern.segment_softmax_sum(*t)
    assert mx is None and den is None
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    numer, mx, den = kern.segment_softmax_sum(*t, partial=True)
    np.testing.assert_allclose(mx.numpy(), want_mx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(den.numpy(), want_den, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        numer.numpy(), want * np.maximum(want_den, 1e-12), rtol=1e-5,
        atol=1e-5)
    assert not out[[0, 4, 11]].any() and not den[[0, 4, 11]].any()


def test_segment_mean_plain_matches_jax():
    """``segment_sum(h[src]) / net_cnt`` (cnt: the in-degree, at least 1),
    and the undivided sums without cnt: rtol/atol 1e-6."""
    h, src, slot, off = _csr_case(seed=2)
    s = off.shape[0] - 1
    cnt = np.maximum(np.diff(off), 1).astype(np.float32)
    sums = np.asarray(jseg.segment_sum(jnp.asarray(h)[jnp.asarray(src)],
                                       slot, s))
    t = [torch.from_numpy(x) for x in (h, src, off)]
    got = kern.segment_mean(*t, torch.from_numpy(cnt))
    np.testing.assert_allclose(got.numpy(), sums / cnt[:, None], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(kern.segment_mean(*t, None).numpy(), sums,
                               rtol=1e-6, atol=1e-6)


def _net_case(seed, special=False, rows=50, n0=30, s=12, d=8):
    """A node state h (rows, d) whose net level holds rows [n0, n0 + s),
    its destination-sorted edges from rows below n0 (slots 0, 4 and 11
    empty, in-degrees 1 to 5), cnt (the in-degree, at least 1), has_in
    (s, 1) and pre (s, d); with ``special`` NaN and signed zeros in pre
    and in the level's old rows."""
    rng = np.random.default_rng(seed)
    h = (2 * rng.normal(size=(rows, d))).astype(np.float32)
    pre = (2 * rng.normal(size=(s, d))).astype(np.float32)
    deg = rng.integers(1, 6, size=s)
    deg[[0, 4, 11]] = 0
    slot = np.repeat(np.arange(s), deg).astype(np.int32)
    src = rng.integers(0, n0, size=slot.shape[0]).astype(np.int32)
    off = np.searchsorted(slot, np.arange(s + 1)).astype(np.int32)
    if special:
        for t in (pre, h[n0: n0 + s]):
            t[::3, 0] = np.nan
            t[1::3, 1] = -0.0
            t[2::3, 1] = 0.0
    cnt = np.maximum(deg, 1).astype(np.float32)
    return h, src, slot, off, cnt, (deg > 0)[:, None], pre, n0


def _old_net_half(h, src, off, cnt, pre, has_in, n0):
    """The segment walk's net half as it was written before the update
    mode took it (``segment_mean``, then five PyTorch ops)."""
    pn_n = pre.shape[0]
    new_n = F.relu(pre + kern.segment_mean(h, src, off, cnt))
    if has_in is not None:
        new_n = torch.where(has_in, new_n, F.relu(h[n0: n0 + pn_n]))
    h[n0: n0 + pn_n] = new_n


@pytest.mark.parametrize("special", [False, True], ids=["normal", "nan_zero"])
@pytest.mark.parametrize("dgl_parity", [True, False])
def test_net_update_plain_is_the_old_net_half(dgl_parity, special):
    """:func:`net_update` on the CPU (its plain version) writes the bits
    of the walk's former net half, NaN and the sign of zero included,
    and touches no other row."""
    h, src, _slot, off, cnt, has_in, pre, n0 = _net_case(7, special)
    t = [torch.from_numpy(x) for x in (src, off, cnt, pre)]
    mask = torch.from_numpy(has_in) if dgl_parity else None
    got, want = torch.from_numpy(h.copy()), torch.from_numpy(h.copy())
    kern.net_update(got, *t, mask, n0)
    _old_net_half(want, *t, mask, n0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[:n0], torch.from_numpy(h[:n0]))


@pytest.mark.parametrize("dgl_parity", [True, False])
def test_net_update_matches_jax_net_half(dgl_parity):
    """:func:`net_update` against JAX's segment net half
    (``prtp_tpu/models/gnn.py:200-204``: ``segment_sum`` of ``h[net_src]``
    over ``net_cnt``, ``relu(fc_net_self + neigh_n)``, then JAX's own
    ``_PairStep._masked_update``), ``fc_net_self``'s output given as
    ``pre``; slots without in-edges keep ``relu(old)`` under
    ``dgl_parity``: rtol/atol 1e-6 (float32 sums in another order)."""
    h, src, slot, off, cnt, has_in, pre, n0 = _net_case(8)
    s = off.shape[0] - 1
    sums = jseg.segment_sum(jnp.asarray(h)[jnp.asarray(src)],
                            jnp.asarray(slot), s + 1)[:s]
    h_new = jax.nn.relu(jnp.asarray(pre) + sums / jnp.asarray(cnt)[:, None])
    step = SimpleNamespace(dgl_parity=dgl_parity)
    want = np.asarray(JaxPairStep._masked_update(
        step, jnp.asarray(h), h_new, n0, jnp.asarray(has_in[:, 0])))
    got = torch.from_numpy(h.copy())
    kern.net_update(got, *(torch.from_numpy(x) for x in (src, off, cnt, pre)),
                    torch.from_numpy(has_in) if dgl_parity else None, n0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if dgl_parity:  # the empty slots kept relu(old)
        np.testing.assert_array_equal(
            got.numpy()[n0 + np.array([0, 4, 11])],
            np.maximum(h[n0 + np.array([0, 4, 11])], 0))


def _golden_parsed():
    from test_torch_graph import golden_parsed
    return golden_parsed()


@pytest.mark.parametrize("which", ["golden", "prior", "merged"])
def test_no_net_source_lies_in_its_own_level(which):
    """The premise of the update mode's write into h in place: no net
    level's source row lies in its own rows ``[net_off[k], net_off[k] +
    S_k)`` (all lie below them), on the committed golden design, a
    random design with prior rows and a merged super-graph."""
    if which == "golden":
        parsed = _golden_parsed()
    elif which == "prior":
        parsed = _prior_parsed()
    else:
        rng = np.random.default_rng(5)
        parsed = merge_parsed_designs([_tiny_parsed_design(rng)
                                       for _ in range(3)])
    g = pack_leveled_graph_exact(parsed, device="cpu", segment=True)[0]
    if which == "prior":  # net drivers below their pair's cell level
        assert any((g.net_src[k] < g.cell_off[k]).any()
                   for k in range(g.num_pairs))
    for k in range(g.num_pairs):
        s = g.net_dst_off[k].shape[0] - 1
        assert s == g.net_feat_lvl[k].shape[0]
        assert not ((g.net_src[k] >= g.net_off[k])
                    & (g.net_src[k] < g.net_off[k] + s)).any(), k
        assert (g.net_src[k] < g.net_off[k]).all(), k


@pytest.mark.parametrize("mode", ["recompute", "stats"])
def test_segment_softmax_sum_bwd_plain_matches_jax_vjp(mode):
    """The per-edge cotangent against ``jax.vjp`` of
    ``segment_softmax_sum_fused`` with respect to the edge messages:
    rtol 1e-5, atol 1e-5 x max |d| (XLA also sends the max's own
    cotangent, which cancels to rounding). Each slot's softmax recomputed
    from h (the unsharded walk) or read from the ``(out, mx, den)`` an
    edge-sharded rank passes (here the partial forward's, divided as the
    combine divides at one rank): the two are bit-equal."""
    h, src, slot, off = _csr_case(seed=3)
    s = off.shape[0] - 1
    g = np.random.default_rng(4).normal(size=(s, h.shape[1])).astype(
        np.float32)
    msg = jnp.asarray(h)[jnp.asarray(src)]
    _, vjp = jax.vjp(lambda m: jseg.segment_softmax_sum_fused(m, slot, s),
                     msg)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = [torch.from_numpy(x) for x in (h, src, off)]
    g_t = torch.from_numpy(g)
    recomputed = kern.segment_softmax_sum_bwd(*t, g_t)
    numer, mx, den = kern.segment_softmax_sum(*t, partial=True)
    read = kern.segment_softmax_sum_bwd(
        *t, g_t, (numer / den.clamp_min(1e-12), mx, den))
    np.testing.assert_array_equal(recomputed.numpy(), read.numpy())
    got = recomputed if mode == "recompute" else read
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("with_cnt", [False, True])
def test_segment_scatter_matches_jax_scatter_add(with_cnt):
    """``dest.at[src].add(contrib)`` of per-edge contributions, through
    the packer's source-sorted tables and ``mailbox_scatter`` as the
    segment walk calls it (``segment_walk._scatter_add``): a cell level's
    (edge ids into the per-edge cotangent) and a net level's (destination
    slots into the slots' cotangent over their counts). rtol/atol
    1e-6."""
    h, src, slot, off = _csr_case(seed=5)
    rng = np.random.default_rng(6)
    dest = rng.normal(size=h.shape).astype(np.float32)
    order = np.argsort(src, kind="stable")
    rows, segid = np.unique(src[order], return_inverse=True)
    seg_off = np.searchsorted(segid, np.arange(len(rows) + 1)).astype(
        np.int32)
    if with_cnt:
        cnt = np.maximum(np.diff(off), 1).astype(np.float32)
        val = rng.normal(size=(off.shape[0] - 1, h.shape[1])).astype(
            np.float32)
        pos, contrib = slot[order], (val / cnt[:, None])[slot]
    else:
        cnt, val = None, rng.normal(size=(len(src), h.shape[1])).astype(
            np.float32)
        pos, contrib = order, val
    want = np.asarray(jnp.asarray(dest).at[jnp.asarray(src)].add(contrib))
    got = torch.from_numpy(dest.copy())
    _scatter_add(got, torch.from_numpy(rows.astype(np.int32)),
                 torch.from_numpy(seg_off),
                 torch.from_numpy(pos.astype(np.int32)),
                 torch.from_numpy(val),
                 None if cnt is None else torch.from_numpy(cnt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---- the packer's flat edge tables ----

def _prior_parsed():
    rng = np.random.default_rng(11)
    return make_random_leveled_graph(rng, level_sizes=(6, 8, 7, 9, 5, 6, 4),
                                     cell_feat_dim=12, max_in=3)


@pytest.mark.parametrize("which", ["prior", "merged"])
def test_flat_edge_tables_hold_the_padded_packs_edges(which):
    """Per level the port's flat tables hold the same (source, slot) edges
    as JAX's padded pack's ``cell_src``/``cell_dst_slot``, sorted by slot
    with CSR offsets; the source-sorted tables cover every edge once, a
    segment a distinct source row; ``has_in`` is the mailbox's; net_cnt
    is JAX's. On a merged super-graph too."""
    if which == "merged":
        rng = np.random.default_rng(5)
        parsed = merge_parsed_designs([_tiny_parsed_design(rng)
                                       for _ in range(3)])
    else:
        parsed = _prior_parsed()
    g, rows, num_rows = pack_leveled_graph_exact(parsed, device="cpu",
                                                 segment=True)
    jg, jrows, jnum = jax_pack_padded(parsed, align=8)
    node_of = {int(r): v for v, r in enumerate(rows) if r < num_rows}
    jnode_of = {int(r): v for v, r in enumerate(jrows) if r < jnum}
    jstride = jg.pn_c + jg.pn_n
    for k in range(g.num_pairs):
        for half, base, jbase, pn_j in (
                ("cell", g.cell_off[k], k * jstride, jg.pn_c),
                ("net", g.net_off[k], k * jstride + jg.pn_c, jg.pn_n)):
            src = getattr(g, f"{half}_src")[k].numpy()
            slot = getattr(g, f"{half}_dst_slot")[k].numpy()
            off = getattr(g, f"{half}_dst_off")[k].numpy()
            assert (np.diff(slot) >= 0).all()
            np.testing.assert_array_equal(
                off, np.searchsorted(slot, np.arange(len(off))))
            got = sorted((node_of[int(a)], node_of[base + int(b)])
                         for a, b in zip(src, slot))
            jsrc = np.asarray(getattr(jg, f"{half}_src")[k])
            jslot = np.asarray(getattr(jg, f"{half}_dst_slot")[k])
            real = jslot != pn_j
            want = sorted((jnode_of[int(a)], jnode_of[jbase + int(b)])
                          for a, b in zip(jsrc[real], jslot[real]))
            assert got == want
            pos = getattr(g, f"{half}_src_pos")[k].numpy()
            urows = getattr(g, f"{half}_src_rows")[k].numpy()
            soff = getattr(g, f"{half}_src_off")[k].numpy()
            edge = np.argsort(src, kind="stable")
            np.testing.assert_array_equal(
                pos, edge if half == "cell" else slot[edge])
            np.testing.assert_array_equal(np.repeat(urows, np.diff(soff)),
                                          src[edge])
            assert (np.diff(urows) > 0).all()
            mail = getattr(g, f"{half}_mail")[k]
            np.testing.assert_array_equal(
                getattr(g, f"{half}_has_in")[k].numpy(),
                (mail != num_rows).any(dim=1, keepdim=True).numpy())
        np.testing.assert_array_equal(
            g.net_cnt[k].numpy(),
            np.asarray(jg.net_cnt[k])[:g.net_cnt[k].shape[0]])


# ---- the walk against JAX's segment TimeGNN on the padded pack ----

def _walk_case(which):
    """(parsed, cell feature width): a design whose net drivers lie in
    the pair's own cell level (``small_parsed``) or one whose edges come
    from any lower level (prior rows, several in-edges a cell)."""
    if which == "no_prior":
        return small_parsed(seed=4), 10
    return _prior_parsed(), 12


def _port_gnn(params, cell_feat_dim, dgl_parity, reduce_mode="segment"):
    gnn = TimeGNN(cell_feat_dim, 3, torch.Generator().manual_seed(0),
                  out_dim=OUT, hidden_dim=HID, dgl_parity=dgl_parity,
                  reduce_mode=reduce_mode)
    state = params_from_flax({"gnn": params})
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()})
    return gnn


@pytest.mark.parametrize("which", ["no_prior", "prior"])
@pytest.mark.parametrize("dgl_parity", [True, False])
def test_segment_walk_matches_jax_segment_timegnn(dgl_parity, which):
    """The port's segment walk (SegmentWalk, the kernels' plain
    versions) against JAX ``TimeGNN(reduce_mode="segment")`` on its padded
    pack (align 8), node by node through the two packers' row maps, with
    jittered weights and a random h0: h_final at rtol/atol 1e-5; for a
    random cotangent of every node's final row, the MLP gradients and the
    h0 cotangent against ``jax.grad`` at rtol 2e-4, atol 1e-5 (the
    bounds of tests/test_fused_gnn.py)."""
    parsed, cfd = _walk_case(which)
    g, rows, num_rows = pack_leveled_graph_exact(parsed, device="cpu",
                                                 segment=True)
    jg, jrows, jnum = jax_pack_padded(parsed, align=8)
    rng = np.random.default_rng(8)
    n = int(parsed["num_nodes"])
    h0_nodes = (0.3 * rng.normal(size=(n, OUT))).astype(np.float32)
    cot = rng.normal(size=(n, OUT)).astype(np.float32)
    h0 = np.zeros((num_rows + 1, OUT), np.float32)
    h0[rows] = h0_nodes
    jh0 = np.zeros((jnum + 1, OUT), np.float32)
    jh0[jrows] = h0_nodes
    model = JaxTimeGNN(out_dim=OUT, hidden_dim=HID, dgl_parity=dgl_parity,
                       reduce_mode="segment")
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jg)
    leaves, treedef = jax.tree_util.tree_flatten(v)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    params = jax.tree_util.tree_unflatten(
        treedef, [l + 0.1 * jax.random.normal(k, l.shape, l.dtype)
                  for l, k in zip(leaves, keys)])["params"]

    def loss(p, h0):
        h = model.apply({"params": p}, jg, h0)
        return (h[jrows] * cot).sum(), h

    (_l, jh), (d_params, d_h0) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(jh0))
    gnn = _port_gnn(jax.tree_util.tree_map(np.asarray, params), cfd,
                    dgl_parity)
    h0_t = torch.from_numpy(h0).requires_grad_()
    h = gnn(g, h0_t)
    np.testing.assert_allclose(h.detach().numpy()[rows],
                               np.asarray(jh)[jrows], rtol=1e-5, atol=1e-5)
    (h[torch.from_numpy(rows)] * torch.from_numpy(cot)).sum().backward()
    want = params_from_flax({"gnn": jax.tree_util.tree_map(np.asarray,
                                                           d_params)})
    got = {f"gnn.{k}": p.grad for k, p in gnn.named_parameters()}
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(h0_t.grad.numpy()[rows],
                               np.asarray(d_h0)[jrows], rtol=2e-4, atol=1e-5)


def test_unsharded_segment_walk_saves_only_out():
    """Off the edge-sharded step the forward keeps each cell reduce's
    output alone, for the ``fc_cell_neigh`` gradients: no shift or
    denominator (the cell cotangent recomputes them from hf)."""
    parsed, cfd = _walk_case("prior")
    g = pack_leveled_graph_exact(parsed, device="cpu", segment=True)[0]
    gnn = TimeGNN(cfd, 3, torch.Generator().manual_seed(3), out_dim=OUT,
                  hidden_dim=HID, reduce_mode="segment")
    params = {name: tuple(getattr(gnn, name).parameters())
              for name in MLP_NAMES}
    h0 = torch.randn((g.num_rows + 1, OUT),
                     generator=torch.Generator().manual_seed(1))
    saved = {}
    with torch.no_grad():
        segment_gnn_forward(params, h0, g, saved=saved)
    assert sorted(saved) == list(range(1, g.num_pairs))
    for k, (out, mx, den) in saved.items():
        assert mx is None and den is None
        assert out.shape == (g.cell_feat_lvl[k].shape[0], OUT)


@pytest.mark.parametrize("which", ["no_prior", "prior"])
def test_segment_walk_matches_the_mailbox_walk(which):
    """The same function by the two reduces of the port, same weights:
    h_final at rtol/atol 1e-5, gradients and the h0 cotangent at rtol
    2e-4, atol 1e-5 (only the sums' order differs); and the hand-written
    backward against torch autograd through the plain forward at the
    same bounds."""
    parsed, cfd = _walk_case(which)
    g = pack_leveled_graph_exact(parsed, device="cpu", segment=True)[0]
    rng = np.random.default_rng(9)
    n1 = g.num_rows + 1
    h0 = torch.from_numpy((0.3 * rng.normal(size=(n1, OUT))).astype(
        np.float32))
    cot = torch.from_numpy(rng.normal(size=(n1, OUT)).astype(np.float32))
    gnns, h0s = {}, {}
    for mode in ("segment", "mailbox"):
        gnns[mode] = TimeGNN(cfd, 3, torch.Generator().manual_seed(3),
                             out_dim=OUT, hidden_dim=HID, reduce_mode=mode)
        with torch.no_grad():  # nonzero biases, the same in both
            for i, p in enumerate(gnns[mode].parameters()):
                p.add_(0.1 * torch.randn(
                    p.shape, generator=torch.Generator().manual_seed(i)))
        h0s[mode] = h0.clone().requires_grad_()
        out = gnns[mode](g, h0s[mode])
        (out * cot).sum().backward()
        if mode == "segment":
            h_seg = out.detach()
    np.testing.assert_allclose(h_seg.numpy(), out.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    plain = {name: tuple(t.detach().clone().requires_grad_()
                         for t in getattr(gnns["segment"], name).parameters())
             for name in MLP_NAMES}
    h0_p = h0.clone().requires_grad_()
    (segment_gnn_forward(plain, h0_p, g) * cot).sum().backward()
    for name in MLP_NAMES:
        for a, b, c in zip(getattr(gnns["segment"], name).parameters(),
                           getattr(gnns["mailbox"], name).parameters(),
                           plain[name]):
            for other in (b.grad, c.grad):
                np.testing.assert_allclose(a.grad.numpy(), other.numpy(),
                                           rtol=2e-4, atol=1e-5, err_msg=name)
    for other in (h0s["mailbox"], h0_p):
        np.testing.assert_allclose(h0s["segment"].grad.numpy(),
                                   other.grad.numpy(), rtol=2e-4, atol=1e-5)


# ---- the segment PathModel against JAX's ----

@pytest.fixture(scope="module")
def tiny_case():
    """tests/test_graph_shard.py's design and model widths
    (``gnn_reduce="segment"``), a jittered JAX init on its padded pack
    (align 8) and 5 batches of 4 paths (JAX's iterator, numpy seed 0)."""
    from prtp_tpu import trainer as jtrainer
    parsed = _tiny_parsed_design(np.random.default_rng(31))
    padded = jax_pack_design(parsed, map_size=16, align=8)
    variables = jax_params(JaxPathModel(**MODEL_KW), padded,
                           jnp.arange(padded.num_paths, dtype=jnp.int32))
    rng = np.random.default_rng(0)
    batches = []
    while len(batches) < 5:
        batches += [(np.asarray(i), np.asarray(m)) for i, m in
                    jtrainer.iterate_batches(np.arange(parsed["num_paths"]),
                                             4, rng)]
    return parsed, padded, variables, batches[:5]


def test_segment_params_are_the_mailbox_tree(tiny_case):
    """The segment model's parameters are JAX's segment PathModel's tree,
    leaf for leaf (``pair_step/fc_*``): ``params_from_flax`` loads them
    and ``params_to_flax`` gives them back exactly."""
    parsed, _padded, variables, _b = tiny_case
    model = PathModel(10, 3, **MODEL_KW)
    state = params_from_flax(variables["params"])
    model.load_state_dict(state)
    back = params_to_flax({k: v for k, v in model.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(variables["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)


def test_segment_model_evaluates_as_jax(tiny_case):
    """``test.evaluate`` of the port's segment PathModel on its exact pack
    against JAX's segment model on the padded pack, every path:
    predictions at rtol/atol 1e-5, through ``evaluate_design`` too."""
    parsed, padded, variables, _b = tiny_case
    pids = np.arange(parsed["num_paths"])
    want = np.asarray(jax.jit(JaxPathModel(**MODEL_KW).apply)(
        {"params": variables["params"]}, padded,
        jnp.asarray(pids, jnp.int32)))
    model = PathModel(10, 3, **MODEL_KW)
    model.load_state_dict(params_from_flax(variables["params"]))
    design = pack_design(parsed, map_size=16, device="cpu", segment=True)
    ids, mask = port_test.pad_batch(pids, len(pids), "cpu")
    with torch.no_grad():
        preds, _mets = port_test.evaluate(model, design, ids, mask)
    np.testing.assert_allclose(preds.numpy(), want, rtol=1e-5, atol=1e-5)
    got, _m = port_test.evaluate_design(
        model, dict(parsed, path2level=parsed["path_level"].astype(np.int64)),
        device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_segment_train_steps_match_jax(tiny_case):
    """5 float32 steps of the segment model against JAX's
    ``make_train_step`` on the padded pack, from the same init: the
    bounds of test_torch_train (first-step gradients rtol 1e-4, atol 1e-5
    x max |g|; losses rtol 1e-5; final parameters atol 2e-5 + rtol
    1e-4)."""
    parsed, padded, variables, batches = tiny_case
    assert_steps_match_jax(parsed, MODEL_KW, variables, padded, batches)


# ---- the refusals ----

def test_segment_walk_needs_the_segment_pack():
    """The packer builds the flat edge tables only on request (the
    mailbox walk reads none of them, only ``has_in``): a segment model on
    a default pack raises, naming ``segment=True``."""
    design = pack_design(small_parsed(seed=4), map_size=16, device="cpu")
    g = design.graph
    assert g.cell_src is None and g.net_src_rows is None
    assert g.cell_has_in[0].dtype == torch.bool
    ids = torch.arange(design.num_paths, dtype=torch.int32)
    with pytest.raises(ValueError, match="segment=True"):
        PathModel(10, 3, **MODEL_KW)(design, ids)
