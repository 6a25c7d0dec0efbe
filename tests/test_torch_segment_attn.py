"""``--attn`` under the segment reduce (``gnn_reduce='segment'``,
``flag_attn``) in the port against the JAX package, on the CPU at small
sizes: the plain ``segment_weighted_softmax_sum`` against
``prtp_tpu/ops/segment.py``, the plain versions of the two kernels
(``segment_attn_sum``, ``segment_attn_bwd``) against the JAX expression
the walk runs and ``jax.vjp`` of it, the segment ``--attn`` walk against
JAX's ``TimeGNN(reduce_mode="segment", flag_attn=True)`` on its padded
pack and against the port's mailbox ``--attn`` walk, and a segment
``--attn`` PathModel's evaluation and train steps against JAX's.

The segment reduce sums a level's edges in the packer's order, XLA in
its scatter order, so float32 values agree to rounding: each tolerance
is stated in its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.graph import pack_leveled_graph as jax_pack_padded
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.models.gnn import TimeGNN as JaxTimeGNN
from prtp_tpu.ops import segment as jseg
from prtp_tpu_torch import test as port_test
from prtp_tpu_torch.graph import pack_design, pack_leveled_graph_exact
from prtp_tpu_torch.models import PathModel, TimeGNN
from prtp_tpu_torch.ops import KERNELS
from prtp_tpu_torch.ops import segment as seg
from prtp_tpu_torch.ops import segment_kernels as kern
from prtp_tpu_torch.ops.fused_gnn import MLP_NAMES
from prtp_tpu_torch.ops.segment_walk import segment_gnn_forward
from prtp_tpu_torch.utils.convert import params_from_flax

from test_models import _tiny_parsed_design
from test_torch_convert import jax_params
from test_torch_segment import (HID, OUT, _csr_case, _segment_case,
                                _walk_case)
from test_torch_train import assert_steps_match_jax

MODEL_KW = dict(out_dim=16, hidden_dim=32, cnn_outdim=8, map_size=16,
                global_dim=8, gnn_reduce="segment", flag_attn=True,
                num_heads=2)


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors the kernel wrappers run their plain versions."""
    yield
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


# ---- the plain op against prtp_tpu/ops/segment.py ----

@pytest.mark.parametrize("heads", ["1d", "1", "2", "4"])
def test_plain_weighted_softmax_sum_matches_jax(heads):
    """``segment_weighted_softmax_sum`` against its JAX original: single
    head with (E,) and (E, 1) scores, and 2 and 4 heads over their own
    value slices; padding edges at the dummy slot and empty slots 2 and
    5 (which give 0): rtol 1e-6, atol 1e-6 (float32 sums in another
    order)."""
    data, ids, s = _segment_case(seed=12, d=8)
    nh = 1 if heads == "1d" else int(heads)
    rng = np.random.default_rng(13)
    scores = (3 * rng.normal(size=(data.shape[0], nh))).astype(np.float32)
    if heads == "1d":
        scores = scores[:, 0]
    want = np.asarray(jseg.segment_weighted_softmax_sum(
        jnp.asarray(data), jnp.asarray(scores), jnp.asarray(ids), s))
    got = seg.segment_weighted_softmax_sum(
        torch.from_numpy(data), torch.from_numpy(scores),
        torch.from_numpy(ids), s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got[[2, 5]].any()


# ---- the kernels' plain versions against the JAX expressions ----

def _attn_case(nh, seed=1, d=8):
    """:func:`test_torch_segment._csr_case` (slots 0, 4 and 11 empty) and
    a score weight w (nh, d) with ``fc_attn2``'s init scale."""
    h, src, slot, off = _csr_case(seed=seed, d=d)
    w = (np.random.default_rng(seed + 40).normal(size=(nh, d))
         / np.sqrt(d)).astype(np.float32)
    return h, src, slot, off, w


def _jax_reduce(slot, s):
    """The walk's JAX expression for the messages m and fc_attn2's kernel
    wk (D, nh): ``segment_weighted_softmax_sum(m, m @ wk, slot, s)``."""
    return lambda m, wk: jseg.segment_weighted_softmax_sum(m, m @ wk, slot,
                                                           s)


@pytest.mark.parametrize("nh", [1, 2, 4])
def test_segment_attn_sum_plain_matches_jax(nh):
    """out is ``segment_weighted_softmax_sum(h[src], h[src] @ w.T)``, and
    no statistics without ``partial``; ``partial`` gives the numerator,
    mx each head's clamped ``segment_max`` of the scores and den the sum
    of their shifted exps, (S, nh). Empty slots give 0. rtol/atol
    1e-6 (the numerator 1e-5: den times out)."""
    h, src, slot, off, w = _attn_case(nh)
    s = off.shape[0] - 1
    msg = jnp.asarray(h)[jnp.asarray(src)]
    sc = msg @ jnp.asarray(w).T
    want = np.asarray(_jax_reduce(slot, s)(msg, jnp.asarray(w).T))
    want_mx = np.asarray(jseg.segment_max(sc, slot, s))
    want_den = np.asarray(jseg.segment_sum(jnp.exp(sc - want_mx[slot]), slot,
                                           s))
    t = [torch.from_numpy(x) for x in (h, src, off, w)]
    out, mx, den = kern.segment_attn_sum(*t)
    assert mx is None and den is None
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    numer, mx, den = kern.segment_attn_sum(*t, partial=True)
    assert mx.shape == den.shape == (s, nh)
    np.testing.assert_allclose(mx.numpy(), want_mx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(den.numpy(), want_den, rtol=1e-6, atol=1e-6)
    dd = np.repeat(np.maximum(want_den, 1e-12), h.shape[1] // nh, axis=1)
    np.testing.assert_allclose(numer.numpy(), want * dd, rtol=1e-5,
                               atol=1e-5)
    assert not out[[0, 4, 11]].any() and not den[[0, 4, 11]].any()
    assert not mx[[0, 4, 11]].any()


@pytest.mark.parametrize("mode", ["recompute", "stats"])
@pytest.mark.parametrize("nh", [1, 2, 4])
def test_segment_attn_bwd_plain_matches_jax_vjp(nh, mode):
    """The per-edge cotangent and ``fc_attn2``'s gradient against
    ``jax.vjp`` of the walk's expression with respect to the messages and
    the kernel: rtol 1e-5, atol 1e-5 x max |d| (XLA also sends the max's
    own cotangent, which cancels to rounding). Each slot's softmax
    recomputed from h (the unsharded walk) or read from the ``(out, mx,
    den)`` an edge-sharded rank passes (here the partial forward's,
    divided as the combine divides at one rank): the two are
    bit-equal."""
    h, src, slot, off, w = _attn_case(nh, seed=3)
    s, d = off.shape[0] - 1, h.shape[1]
    g = np.random.default_rng(4).normal(size=(s, d)).astype(np.float32)
    msg = jnp.asarray(h)[jnp.asarray(src)]
    _, vjp = jax.vjp(_jax_reduce(slot, s), msg, jnp.asarray(w).T)
    want_m, want_wk = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    t = [torch.from_numpy(x) for x in (h, src, off, w)]
    g_t = torch.from_numpy(g)
    recomputed = kern.segment_attn_bwd(*t, g_t)
    numer, mx, den = kern.segment_attn_sum(*t, partial=True)
    read = kern.segment_attn_bwd(*t, g_t, (kern.divide_heads(numer, den), mx,
                                           den))
    for a, b in zip(recomputed, read):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    d_msg, d_w = recomputed if mode == "recompute" else read
    assert d_w.shape == (nh, d)
    np.testing.assert_allclose(d_msg.numpy(), want_m, rtol=1e-5,
                               atol=1e-5 * np.abs(want_m).max())
    np.testing.assert_allclose(d_w.numpy(), want_wk.T, rtol=1e-5,
                               atol=1e-5 * np.abs(want_wk).max())


@pytest.mark.parametrize("mode", ["recompute", "stats"])
@pytest.mark.parametrize("nh", [1, 2, 4])
def test_attn_grad_sum_adds_the_calls_in_order(nh, mode):
    """One ``AttnGradSum`` over three ``segment_attn_bwd`` calls (three
    pairs' tables, one h and w, as the walk's backward makes them): each
    call returns its per-edge cotangent, equal to the plain version's,
    and no ``d_w``; ``finish()`` equals the calls' plain ``d_w`` added in
    call order, bit for bit (each call's plain ``d_w`` is held against
    ``jax.vjp`` by test_segment_attn_bwd_plain_matches_jax_vjp).
    Recomputing or reading the statistics of the partial forward, as
    there. An empty sum finishes as zeros; a sum of another w's shape is
    refused."""
    h, _src, _slot, _off, w = _attn_case(nh, seed=5)
    d = h.shape[1]
    rng = np.random.default_rng(20 + nh)
    t_h, t_w = torch.from_numpy(h), torch.from_numpy(w)
    dw_sum = kern.AttnGradSum(t_w)
    assert not dw_sum.finish().any()
    want = None
    for seed in (6, 7, 8):
        _h, src, _slot, off = _csr_case(seed=seed, d=d)
        s = off.shape[0] - 1
        g = rng.normal(size=(s, d)).astype(np.float32)
        t = [torch.from_numpy(x) for x in (src, off)]
        stats = None
        if mode == "stats":
            numer, mx, den = kern.segment_attn_sum(t_h, *t, t_w, partial=True)
            stats = (kern.divide_heads(numer, den), mx, den)
        d_msg, none = kern.segment_attn_bwd(t_h, *t, t_w, torch.from_numpy(g),
                                            stats, dw_sum)
        assert none is None
        want_m, want_w = kern.segment_attn_bwd_plain(
            t_h, *t, t_w, torch.from_numpy(g), stats)
        np.testing.assert_array_equal(d_msg.numpy(), want_m.numpy())
        want = want_w if want is None else want + want_w
    np.testing.assert_array_equal(dw_sum.finish().numpy(), want.numpy())
    with pytest.raises(ValueError, match="shape"):  # 2 nh heads
        kern.segment_attn_bwd(t_h, *t, torch.zeros((2 * nh, d)),
                              torch.from_numpy(g), None, dw_sum)


# ---- the walk against JAX's segment TimeGNN on the padded pack ----

def _attn_gnn(cell_feat_dim, nh, reduce_mode="segment", seed=0):
    return TimeGNN(cell_feat_dim, 3, torch.Generator().manual_seed(seed),
                   out_dim=OUT, hidden_dim=HID, flag_attn=True,
                   num_heads=nh, reduce_mode=reduce_mode)


@pytest.mark.parametrize("which", ["no_prior", "prior"])
@pytest.mark.parametrize("nh", [1, 2])
def test_segment_attn_walk_matches_jax_segment_timegnn(nh, which):
    """The port's segment ``--attn`` walk (SegmentWalk, the kernels'
    plain versions) against JAX ``TimeGNN(reduce_mode="segment",
    flag_attn=True, num_heads=nh)`` on its padded pack (align 8), node by
    node through the two packers' row maps, with jittered weights and a
    random h0: h_final at rtol/atol 1e-5; for a random cotangent of every
    node's final row, the gradients (``fc_attn2``'s included) and the h0
    cotangent against ``jax.grad`` at rtol 2e-4, atol 1e-5 (the bounds of
    tests/test_torch_segment.py)."""
    parsed, cfd = _walk_case(which)
    g, rows, num_rows = pack_leveled_graph_exact(parsed, device="cpu",
                                                 segment=True)
    jg, jrows, jnum = jax_pack_padded(parsed, align=8)
    rng = np.random.default_rng(18)
    n = int(parsed["num_nodes"])
    h0_nodes = (0.3 * rng.normal(size=(n, OUT))).astype(np.float32)
    cot = rng.normal(size=(n, OUT)).astype(np.float32)
    h0 = np.zeros((num_rows + 1, OUT), np.float32)
    h0[rows] = h0_nodes
    jh0 = np.zeros((jnum + 1, OUT), np.float32)
    jh0[jrows] = h0_nodes
    model = JaxTimeGNN(out_dim=OUT, hidden_dim=HID, flag_attn=True,
                       num_heads=nh, reduce_mode="segment")
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
    gnn = _attn_gnn(cfd, nh)
    state = params_from_flax({"gnn": jax.tree_util.tree_map(np.asarray,
                                                            params)})
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()})
    h0_t = torch.from_numpy(h0).requires_grad_()
    h = gnn(g, h0_t)
    np.testing.assert_allclose(h.detach().numpy()[rows],
                               np.asarray(jh)[jrows], rtol=1e-5, atol=1e-5)
    (h[torch.from_numpy(rows)] * torch.from_numpy(cot)).sum().backward()
    want = params_from_flax({"gnn": jax.tree_util.tree_map(np.asarray,
                                                           d_params)})
    got = {f"gnn.{k}": p.grad for k, p in gnn.named_parameters()}
    assert sorted(got) == sorted(want) and "gnn.fc_attn2.weight" in got
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(h0_t.grad.numpy()[rows],
                               np.asarray(d_h0)[jrows], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("nh", [1, 2])
def test_segment_attn_walk_matches_the_mailbox_attn_walk(nh):
    """The same function by the two reduces of the port, same weights
    (biases and ``fc_attn2`` jittered): h_final at rtol/atol 1e-5,
    gradients and the h0 cotangent at rtol 2e-4, atol 1e-5 (only the
    sums' order differs); and the hand-written backward against torch
    autograd through the plain forward at the same bounds. The forward
    keeps each cell reduce's output alone off the edge-sharded step (the
    backward recomputes the statistics)."""
    parsed, cfd = _walk_case("prior")
    g = pack_leveled_graph_exact(parsed, device="cpu", segment=True)[0]
    rng = np.random.default_rng(19)
    n1 = g.num_rows + 1
    h0 = torch.from_numpy((0.3 * rng.normal(size=(n1, OUT))).astype(
        np.float32))
    cot = torch.from_numpy(rng.normal(size=(n1, OUT)).astype(np.float32))
    gnns, h0s, outs = {}, {}, {}
    for mode in ("segment", "mailbox"):
        gnns[mode] = _attn_gnn(cfd, nh, mode, seed=3)
        with torch.no_grad():  # nonzero biases, the same in both
            for i, p in enumerate(gnns[mode].parameters()):
                p.add_(0.1 * torch.randn(
                    p.shape, generator=torch.Generator().manual_seed(i)))
        h0s[mode] = h0.clone().requires_grad_()
        outs[mode] = gnns[mode](g, h0s[mode])
        (outs[mode] * cot).sum().backward()
    np.testing.assert_allclose(outs["segment"].detach().numpy(),
                               outs["mailbox"].detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    names = [*MLP_NAMES, "fc_attn2"]
    plain = {name: tuple(t.detach().clone().requires_grad_()
                         for t in getattr(gnns["segment"], name).parameters())
             for name in names}
    plain["fc_attn2"] = plain["fc_attn2"][0]
    h0_p = h0.clone().requires_grad_()
    saved = {}
    (segment_gnn_forward(plain, h0_p, g, saved=saved) * cot).sum().backward()
    assert sorted(saved) == list(range(1, g.num_pairs))
    assert all(mx is None and den is None for _o, mx, den in saved.values())
    for name in names:
        mine = plain[name] if name != "fc_attn2" else (plain[name],)
        for a, b, c in zip(getattr(gnns["segment"], name).parameters(),
                           getattr(gnns["mailbox"], name).parameters(),
                           mine):
            for other in (b.grad, c.grad):
                np.testing.assert_allclose(a.grad.numpy(), other.numpy(),
                                           rtol=2e-4, atol=1e-5, err_msg=name)
    for other in (h0s["mailbox"], h0_p):
        np.testing.assert_allclose(h0s["segment"].grad.numpy(),
                                   other.grad.numpy(), rtol=2e-4, atol=1e-5)


# ---- the segment --attn PathModel against JAX's ----

@pytest.fixture(scope="module")
def attn_case():
    """tests/test_torch_segment.py's tiny design and widths with
    ``flag_attn`` and 2 heads, a jittered JAX init on its padded pack
    (align 8) and 3 batches of 4 paths (JAX's iterator, numpy seed 0)."""
    from prtp_tpu import trainer as jtrainer
    parsed = _tiny_parsed_design(np.random.default_rng(31))
    padded = jax_pack_design(parsed, map_size=16, align=8)
    variables = jax_params(JaxPathModel(**MODEL_KW), padded,
                           jnp.arange(padded.num_paths, dtype=jnp.int32))
    rng = np.random.default_rng(0)
    batches = []
    while len(batches) < 3:
        batches += [(np.asarray(i), np.asarray(m)) for i, m in
                    jtrainer.iterate_batches(np.arange(parsed["num_paths"]),
                                             4, rng)]
    return parsed, padded, variables, batches[:3]


def test_segment_attn_model_evaluates_as_jax(attn_case):
    """``test.evaluate`` of the port's segment ``--attn`` PathModel on its
    exact pack against JAX's on the padded pack, every path: predictions
    at rtol/atol 1e-5, through ``evaluate_design`` too."""
    parsed, padded, variables, _b = attn_case
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


def test_segment_attn_train_steps_match_jax(attn_case):
    """3 float32 steps of the segment ``--attn`` model against JAX's
    ``make_train_step`` on the padded pack, from the same init: the
    bounds of test_torch_train (first-step gradients, ``fc_attn2``'s
    included, rtol 1e-4, atol 1e-5 x max |g|; losses rtol 1e-5; final
    parameters atol 2e-5 + rtol 1e-4)."""
    parsed, padded, variables, batches = attn_case
    assert_steps_match_jax(parsed, MODEL_KW, variables, padded, batches)
