"""The level walk under the segment reduce, forward and backward.

Port of ``prtp_tpu/models/gnn.py::_PairStep.__call__`` with
``reduce_mode='segment'`` (:163-206), the pair step that JAX's
edge-parallel ``(dp, gp)`` step (``prtp_tpu/parallel/graph_shard.py``)
partitions along the edge axis. Per level pair it computes the same
function as the mailbox walk (:mod:`.fused_gnn`), over a level's flat
edge tables (``graph.py``, ``cell_src`` ... ``net_has_in``) instead of
its dense mailbox, with the kernels of :mod:`.segment_kernels`:

- the cell half: ``segment_softmax_sum`` of ``h[cell_src]`` by
  destination slot, read straight from ``h``, or with ``--attn``
  (``fc_attn2`` in ``params``) ``segment_attn_sum``, JAX's
  ``segment_weighted_softmax_sum`` of ``h[cell_src]`` under the scores
  ``fc_attn2(h[cell_src])`` (:178-182); pair 0 drops the neighbour term
  (JAX's ``gate``, :190);
- the net half, which reads ``h`` after the cell half's write: the
  in-edge sum over ``net_cnt``, added to the ``fc_net_self`` MLP's
  output under a ReLU; with ``dgl_parity`` a row without in-edges keeps
  ``relu(old)`` (:152-161), by the level's ``has_in``. Unsharded, one
  launch of ``segment_mean``'s update mode (``net_update``) computes
  the mean and writes the new rows into ``h``; sharded, the partial
  sums' all-reduce comes between, so the mean and the update
  (``net_epilogue``) stay apart.

The pair-step MLPs are the mailbox walk's (``_mlp``, ``_mlp_grads``,
``_relu_split``), so their arithmetic is shared. The backward
(:class:`SegmentWalk`) is the transpose XLA's autodiff takes through
that step: per half in reverse the ReLU split, the MLP gradients, and
the edges' cotangents scattered into ``dh`` by source row with the
mailbox walk's ``mailbox_scatter`` (net: ``g_n[dst] / cnt[dst]`` formed
in the kernel; cell: ``segment_softmax_sum_bwd``'s per-edge cotangent,
or ``segment_attn_bwd``'s, which also adds the pair's share of
``fc_attn2``'s gradient to one sum a backward, reduced after the last
pair).
The net half's
scatter comes first, since its sources include the pair's own cell
rows, which the cell half's cotangent reads. The forward keeps each
cell reduce's ``out`` for the ``fc_cell_neigh`` gradients; the cell
cotangent's kernel recomputes each slot's shift and denominator from
``hf`` (every source row is final once its level is written, so they
are the forward's). Under sharding a rank holds only a block of a slot's
edges, so the forward also keeps the combined ``(mx, den)`` and the
kernel reads them, without a second round of collectives.

Under the 2-D ``(dp, gp)`` mesh (``graph.shard``, set by
``parallel.graph_shard.shard_design``) each rank holds one contiguous
block of every level's destination-sorted edges and the rest replicated,
as JAX's ``P(None, "gp")``; the collectives JAX's partitioner inserts
become explicit all-reduces over the ``gp`` group:

- cell: each rank's partial ``(numer, max, den)``; the max all-reduced
  (MAX), the local sums rescaled to it, then summed (one all-reduce of
  ``[den | numer]``); an empty slot's local max is ``-inf`` and its scale
  0, and a slot empty on every rank gives JAX's 0. Under ``--attn`` the
  max and den are per head, (S, nh), and each head's scale rescales its
  own channels of the numerator;
- net: the partial sums summed, then divided by ``net_cnt``;
- backward: each rank scatters its own edges into a compact buffer of
  the level's distinct source rows, the buffers are summed, and the sum
  is added into ``dh`` (``mailbox_scatter`` with one entry a row), so every
  rank's ``dh`` stays equal; under ``--attn`` each rank's ``fc_attn2``
  gradient (its block's share) is summed over ``gp`` once a step, at the
  end of the backward.

``has_in`` is the whole level's, never a shard's (a row whose in-edges
all lie on another rank must still update).

Under ``--compute_dtype bfloat16`` (``w16``, :func:`fused_gnn.
bf16_weights`) the walk rounds as JAX's padded scan, the only path JAX
runs the segment reduce on (its exact walk asserts the mailbox reduce,
``prtp_tpu/models/gnn.py:311-312``): the three MLPs are
``_mlp(..., scan=True)`` and their gradients ``_mlp_grads(...,
scan=True)``, with the bias gradients summed by
:class:`~prtp_tpu_torch.ops.fused_gnn.MlpGradSums` over the scan's
level rows (``graph.scan_rows``), as the mailbox walk's are. The carry,
the scores, each MLP's float32 output and every reduce, scatter and
all-reduce stay float32, so the kernels take the same inputs as in
float32. The MLPs run replicated under sharding and read only the
whole level's ``dh`` rows, equal on every rank, so their bf16
gradients are too, and need no collective.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .fused_gnn import (MlpGradSums, _flat_of, _mlp, _mlp_grads, _params_of,
                        _relu_split, _w, bf16_weights, mailbox_scatter,
                        restore_walk, save_walk)
from .segment_kernels import (AttnGradSum, divide_heads, net_epilogue,
                              net_update, segment_attn_bwd, segment_attn_sum,
                              segment_mean, segment_softmax_sum,
                              segment_softmax_sum_bwd)


def require_tables(graph, who: str) -> None:
    """Raise unless ``graph`` holds the flat edge tables, which the
    packer builds only on request."""
    if graph.cell_src is None:
        raise ValueError(f"{who} walks the flat edge tables: pack the "
                         "design with pack_design(..., segment=True)")


def combine_softmax(numer, shift, den, shard):
    """``(out, mx, den)`` of the whole level from this rank's partial
    cell reduce (``partial=True``), by two all-reduces over ``shard``'s
    ``gp`` group: the slots' max, then the rescaled ``[den | numer]``.
    ``shift`` and ``den`` are (S, D) for ``segment_softmax_sum`` (a
    softmax a channel) or (S, nh) for ``segment_attn_sum`` (a softmax a
    head, whose scale rescales the head's D / nh channels of the (S, D)
    numerator)."""
    top = torch.where(den > 0, shift,
                      torch.full((), -torch.inf, device=den.device))
    shard.max_(top)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    scale = torch.where(den > 0, torch.exp(shift - top),
                        torch.zeros_like(den))
    (s, heads), d = den.shape, numer.shape[1]
    scaled = numer.view(s, heads, d // heads) * scale[:, :, None]
    both = torch.cat([den * scale, scaled.view(s, d)], dim=1)
    shard.sum_(both)
    den, numer = both.split([heads, d], dim=1)
    den = den.contiguous()
    return divide_heads(numer, den), top, den


def _cell_reduce(h, graph, k, w_attn):
    """``(out, mx, den)`` of pair k's cell reduce, by attention when
    ``w_attn`` (``fc_attn2``'s weight) is given: ``mx`` and ``den`` None
    unless the graph is sharded (the combined statistics)."""
    shard = graph.shard
    tables = shard or graph
    args = (h, tables.cell_src[k], tables.cell_dst_off[k])
    if w_attn is None:
        reduce = segment_softmax_sum
    else:
        reduce, args = segment_attn_sum, args + (w_attn,)
    if shard is None:
        return reduce(*args)
    return combine_softmax(*reduce(*args, partial=True), shard)


def _net_reduce(h, graph, k):
    """Pair k's net mean on an edge-sharded rank: its partial sums,
    summed over the ``gp`` group, over ``net_cnt``."""
    shard = graph.shard
    sums = segment_mean(h, shard.net_src[k], shard.net_dst_off[k], None)
    shard.sum_(sums)
    return sums / graph.net_cnt[k][:, None]


def _scatter_add(dest, rows, seg_off, pos, val, cnt):
    """``dest[rows[s]] += sum of val[pos[e]]`` (over ``cnt[pos[e]]`` when
    given) over each segment's entries, by ``mailbox_scatter`` with one
    slot a row: with ``cnt`` every position reads the net cotangent
    ``val / cnt`` (``n_cell`` 0), without it ``val`` as its cell rows."""
    if cnt is not None:
        mailbox_scatter(dest, rows, seg_off, pos, None, val, cnt, 1, 0)
        return
    mailbox_scatter(dest, rows, seg_off, pos, val,
                    val.new_empty((0, val.shape[1])), val.new_empty((0,)),
                    1, val.shape[0])


def _scatter(dh, graph, half, k, val, cnt):
    """Add a level's edge cotangents into ``dh`` by source row, under
    sharding through the summed compact buffer of the level's distinct
    source rows."""
    rows = getattr(graph, f"{half}_src_rows")[k]
    shard = graph.shard
    if rows.shape[0] == 0:  # a level without edges, on every rank
        return
    if shard is None:
        _scatter_add(dh, rows, getattr(graph, f"{half}_src_off")[k],
                     getattr(graph, f"{half}_src_pos")[k], val, cnt)
        return
    buf = dh.new_zeros((rows.shape[0], dh.shape[1]))
    _scatter_add(buf, getattr(shard, f"{half}_src_rows")[k],
                 getattr(shard, f"{half}_src_off")[k],
                 getattr(shard, f"{half}_src_pos")[k], val, cnt)
    shard.sum_(buf)
    u = rows.shape[0]
    _scatter_add(dh, rows, shard.iota[: u + 1], shard.iota[:u], buf, None)


def segment_gnn_forward(params, h0: torch.Tensor, graph,
                        dgl_parity: bool = True, saved=None,
                        w16=None) -> torch.Tensor:
    """h_final of the walk under the segment reduce. ``params`` maps each
    name of ``MLP_NAMES`` to that MLP's ``(w0, b0, w1, b1)``; h0 (num_rows
    + 1, D) float32 is not modified (the walk writes a copy); graph: a
    :class:`prtp_tpu_torch.graph.LeveledGraphExact` on h0's device, with
    its ``shard`` under the edge-sharded step. ``saved``, a dict, receives
    each pair k > 0's cell reduce ``(out, mx, den)`` for the backward
    (``mx = den = None`` unless sharded). With ``"fc_attn2"`` in
    ``params`` (``--attn``) the cell half reduces by attention. ``w16``
    (:func:`fused_gnn.bf16_weights`): the MLPs in bf16, rounded as JAX's
    padded scan rounds them. Differentiable by torch autograd where every
    tensor lies on the CPU and the graph is not sharded (the plain
    versions); :class:`SegmentWalk` is its hand-written backward."""
    require_tables(graph, "the segment reduce")
    w_attn = params.get("fc_attn2")
    scan = w16 is not None
    h = h0.clone()
    for k in range(graph.num_pairs):
        # ---- cell half (even level 2k) ----
        pn_c = graph.cell_feat_lvl[k].shape[0]
        c0 = graph.cell_off[k]
        pre = _mlp(params["fc_cell_self"], graph.cell_feat_lvl[k],
                   _w(w16, "fc_cell_self"), scan)
        if k > 0:  # level 0 drops the neighbour term
            reduced = _cell_reduce(h, graph, k, w_attn)
            if saved is not None:
                saved[k] = reduced
            pre = pre + _mlp(params["fc_cell_neigh"], reduced[0],
                             _w(w16, "fc_cell_neigh"), scan)
        new = F.relu(pre)
        if dgl_parity:
            new = torch.where(graph.cell_has_in[k], new,
                              F.relu(h[c0: c0 + pn_c]))
        h[c0: c0 + pn_c] = new
        # ---- net half (odd level 2k+1), after the cell half's write ----
        pre = _mlp(params["fc_net_self"], graph.net_feat_lvl[k],
                   _w(w16, "fc_net_self"), scan)
        has_in = graph.net_has_in[k] if dgl_parity else None
        if graph.shard is None:  # the mean and the update in one launch
            net_update(h, graph.net_src[k], graph.net_dst_off[k],
                       graph.net_cnt[k], pre, has_in, graph.net_off[k])
        else:
            net_epilogue(h, pre, _net_reduce(h, graph, k), has_in,
                         graph.net_off[k])
    return h


def segment_gnn_backward(params, hf: torch.Tensor, g: torch.Tensor, graph,
                         saved, dgl_parity: bool = True, w16=None,
                         pair_sum=None):
    """The cotangent of h0 and the MLPs' gradients (a dict like
    ``params``) of the walk whose final state is ``hf``, for the
    cotangent ``g`` of ``hf``; ``saved`` is what the forward kept, ``w16``
    the forward's bf16 weights (None in float32). One ``dh`` carry, a
    copy of ``g``, updated in place pair by pair in reverse. With
    ``"fc_attn2"`` in ``params`` its gradient is summed over the pairs (an
    :class:`AttnGradSum`: on the card one reduce a backward), and on a
    sharded graph over the ``gp`` group once. ``pair_sum``: as for
    :class:`MlpGradSums`."""
    dh = g.clone(memory_format=torch.contiguous_format)
    scan = w16 is not None
    acc = MlpGradSums(params, graph, scan, pair_sum)
    grads = acc.grads
    w_attn = params.get("fc_attn2")
    dw_sum = None if w_attn is None else AttnGradSum(w_attn)
    tables = graph.shard or graph
    for k in reversed(range(graph.num_pairs)):
        acc.pair(k)
        pn_c = graph.cell_feat_lvl[k].shape[0]
        pn_n = graph.net_feat_lvl[k].shape[0]
        c0, n0 = graph.cell_off[k], graph.net_off[k]
        # ---- net half: its block's carry, then its edges' scatter ----
        d_pre_n, d_old_n = _relu_split(dh[n0: n0 + pn_n], hf[n0: n0 + pn_n],
                                       graph.net_has_in[k], dgl_parity)
        acc.add("fc_net_self", _mlp_grads(
            params["fc_net_self"], graph.net_feat_lvl[k], d_pre_n, False,
            _w(w16, "fc_net_self"), scan)[0])
        dh[n0: n0 + pn_n] = 0.0 if d_old_n is None else d_old_n
        _scatter(dh, graph, "net", k, d_pre_n, graph.net_cnt[k])
        # ---- cell half ----
        d_pre_c, d_old_c = _relu_split(dh[c0: c0 + pn_c], hf[c0: c0 + pn_c],
                                       graph.cell_has_in[k], dgl_parity)
        acc.add("fc_cell_self", _mlp_grads(
            params["fc_cell_self"], graph.cell_feat_lvl[k], d_pre_c, False,
            _w(w16, "fc_cell_self"), scan)[0])
        d_msg = None
        if k > 0:
            f, mx, den = saved[k]
            dp_neigh, d_f = _mlp_grads(params["fc_cell_neigh"], f, d_pre_c,
                                       True, _w(w16, "fc_cell_neigh"), scan,
                                       graph.stacked)
            acc.add("fc_cell_neigh", dp_neigh)
            args = (hf, tables.cell_src[k], tables.cell_dst_off[k])
            stats = None if mx is None else (f, mx, den)
            if w_attn is None:
                d_msg = segment_softmax_sum_bwd(*args, d_f, stats)
            else:
                d_msg, _ = segment_attn_bwd(*args, w_attn, d_f, stats, dw_sum)
        dh[c0: c0 + pn_c] = 0.0 if d_old_c is None else d_old_c
        if d_msg is not None:
            _scatter(dh, graph, "cell", k, d_msg, None)
    acc.finish()
    if dw_sum is not None:
        grads["fc_attn2"] = dw_sum.finish()
        if graph.shard is not None:
            graph.shard.sum_(grads["fc_attn2"])
    return dh, grads


class SegmentWalk(torch.autograd.Function):
    """The walk under the segment reduce with its hand-written backward.
    Inputs: the graph, ``dgl_parity``, whether the MLPs run in bf16 and
    ``pair_sum`` (no gradient), h0, then the twelve pair-step tensors in
    ``MLP_NAMES`` order and, with ``--attn``, ``fc_attn2``'s weight
    (``fused_gnn._params_of``). The bf16 weights made for the forward are
    saved for the backward."""

    @staticmethod
    def forward(ctx, graph, dgl_parity, bf16, pair_sum, h0, *flat):
        params = _params_of(flat)
        w16 = bf16_weights(params) if bf16 else None
        saved = {} if any(ctx.needs_input_grad) else None
        hf = segment_gnn_forward(params, h0, graph, dgl_parity, saved, w16)
        ctx.graph, ctx.dgl_parity, ctx.reduced = graph, dgl_parity, saved
        ctx.pair_sum = pair_sum
        save_walk(ctx, hf, flat, w16)
        return hf

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        hf, flat, w16 = restore_walk(ctx)
        dh, grads = segment_gnn_backward(_params_of(flat), hf, g, ctx.graph,
                                         ctx.reduced, ctx.dgl_parity, w16,
                                         ctx.pair_sum)
        ctx.reduced = None
        need = ctx.needs_input_grad
        return (None, None, None, None, dh if need[4] else None,
                *(t if need[5 + i] else None
                  for i, t in enumerate(_flat_of(grads))))


def segment_walk(params, h0: torch.Tensor, graph, dgl_parity: bool = True,
                 bf16: bool = False, pair_sum=None) -> torch.Tensor:
    """:func:`segment_gnn_forward` through :class:`SegmentWalk`: the
    forward launches the same kernels, and autograd takes the
    hand-written backward. ``bf16``: the MLPs in bf16, rounded as JAX's
    padded scan, forward and backward; ``pair_sum``: as for
    ``fused_gnn.MlpGradSums``."""
    return SegmentWalk.apply(graph, dgl_parity, bf16, pair_sum, h0,
                             *_flat_of(params))
