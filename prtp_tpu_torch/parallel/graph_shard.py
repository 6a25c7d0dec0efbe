"""Graph-dimension (edge-parallel) sharding on a 2-D ``(dp, gp)`` mesh.

Port of ``prtp_tpu/parallel/graph_shard.py``. JAX shards every level's
flat edge tables (``cell_src``, ``cell_dst_slot``, ``net_src``,
``net_dst_slot``) along the edge axis of a ``gp`` mesh axis, keeps node
state, features and parameters replicated, shards the path batch on
``dp``, and lets XLA's partitioner turn the segment reductions into
per-shard partial reductions plus a ``psum``. The port runs one process
a rank (``torch.distributed``: NCCL on cards, gloo on the CPU), and the
collectives are explicit, inside the segment walk
(:mod:`prtp_tpu_torch.ops.segment_walk`): per level pair three
all-reduces over ``gp`` in the forward (the cell reduce's max, its
rescaled sums, the net sums) and two in the backward (each half's
compact source-row cotangents); with ``--attn`` (the cell reduce's max
and denominator per head) one more a step, ``fc_attn2``'s gradient,
of which a rank computes only its edges' share. The model must use
``gnn_reduce="segment"``: the mailbox reduce is node-indexed, and on a
sharded design it simply runs replicated, as JAX's would.

:func:`make_2d_mesh` builds the mesh over an initialized world of
``n_dp * n_gp`` ranks, :func:`shard_design` gives a rank its edge
blocks, and :func:`graph_sharded_train_step` is
``make_graph_sharded_train_step``'s step: every rank backpropagates the
whole batch, as ``parallel.dp.dp_train_step`` does, so the gp ranks hold
equal gradients and every rank's flat Adam state stays the same.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..graph import _csr_offsets
from ..ops.segment_walk import require_tables
from ..trainer import train_step
from .dp import dp_train_step
from .mesh import Mesh

GP_AXIS = "gp"
DP_AXIS = "dp"


@dataclass(frozen=True)
class Mesh2D:
    """This rank's place ``(dp_rank, gp_rank)`` in the ``(n_dp, n_gp)``
    mesh, with its data-parallel mesh (the ranks of its column, one a
    batch block) and its ``gp`` process group (the ranks of its row, one
    an edge block)."""

    n_dp: int
    n_gp: int
    dp_rank: int
    gp_rank: int
    dp: Mesh
    gp_group: object

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.n_dp, GP_AXIS: self.n_gp}


def make_2d_mesh(n_dp: int, n_gp: int) -> Mesh2D:
    """The ``(dp, gp)`` mesh over the initialized world of ``n_dp * n_gp``
    ranks: rank r sits at ``(r // n_gp, r % n_gp)``, JAX's row-major
    ``devices.reshape(n_dp, n_gp)``. Every rank creates every row's and
    every column's process group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    need = n_dp * n_gp
    world = dist.get_world_size()
    if n_dp < 1 or n_gp < 1 or world != need:
        raise RuntimeError(f"a ({n_dp}, {n_gp}) mesh needs {need} ranks, "
                           f"the process group has {world}")
    rows = [dist.new_group([i * n_gp + j for j in range(n_gp)])
            for i in range(n_dp)]
    cols = [dist.new_group([i * n_gp + j for i in range(n_dp)])
            for j in range(n_gp)]
    i, j = divmod(dist.get_rank(), n_gp)
    return Mesh2D(n_dp, n_gp, i, j, Mesh(n_dp, i, cols[j]), rows[i])


@dataclass
class EdgeShard:
    """One rank's block of every level's edge tables (``graph.shard``),
    the fields the segment walk reads in place of the whole level's:
    per pair, the block's destination-sorted sources and their CSR
    offsets over all of the level's slots, and its source-sorted scatter
    tables, whose rows index the level's distinct source rows
    (``graph.<half>_src_rows``, the compact buffer the ranks sum).
    ``iota`` (0, 1, ...) serves the compact buffer's add into ``dh``.
    ``split_slots`` counts the cell slots (pairs k > 0) whose edges lie in
    more than one block: the slots the MAX-then-SUM combine is for."""

    cell_src: tuple
    cell_dst_off: tuple
    cell_src_pos: tuple
    cell_src_rows: tuple
    cell_src_off: tuple
    net_src: tuple
    net_dst_off: tuple
    net_src_pos: tuple
    net_src_rows: tuple
    net_src_off: tuple
    iota: torch.Tensor
    group: object
    split_slots: int

    def sum_(self, t: torch.Tensor) -> None:
        """All-reduce ``t`` in place over the ``gp`` group (SUM)."""
        dist.all_reduce(t, group=self.group)

    def max_(self, t: torch.Tensor) -> None:
        """All-reduce ``t`` in place over the ``gp`` group (MAX)."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)


def _block(n: int, parts: int, i: int) -> tuple:
    """Block ``i`` of ``parts`` contiguous blocks of ``n`` items."""
    return n * i // parts, n * (i + 1) // parts


def split_slot_count(off: np.ndarray, parts: int) -> int:
    """How many slots of the CSR offsets ``off`` have edges in more than
    one of ``parts`` contiguous blocks of the edge list."""
    e = int(off[-1])
    cuts = np.array([_block(e, parts, i)[0] for i in range(1, parts)])
    if not len(cuts):
        return 0
    inside = (off[:-1, None] < cuts[None]) & (cuts[None] < off[1:, None])
    return int(inside.any(axis=1).sum())


def _level_block(src, slot, off, full_rows, lo, hi, half):
    """The block ``[lo, hi)`` of one level's destination-sorted edges as
    the walk reads it (numpy): sources, CSR offsets, and the
    source-sorted scatter table with its rows in the compact numbering
    of ``full_rows``."""
    src_b = src[lo:hi]
    off_b = np.clip(off - lo, 0, hi - lo).astype(np.int32)
    order = np.argsort(src_b, kind="stable")
    rows, seg = np.unique(src_b[order], return_inverse=True)
    pos = order if half == "cell" else slot[lo:hi][order]
    return (src_b, off_b, pos.astype(np.int32),
            np.searchsorted(full_rows, rows).astype(np.int32),
            _csr_offsets(seg, len(rows)))


def shard_design(mesh: Mesh2D, design):
    """The design as rank ``mesh.gp_rank`` of the ``gp`` group holds it:
    block ``gp_rank`` of ``n_gp`` contiguous blocks of every level's
    destination-sorted edge list (JAX's ``P(None, "gp")`` on the edge
    axis), every other table replicated, ``net_cnt`` and ``has_in``
    included (a row's in-edges may all lie in another block). Returns a
    copy of ``design`` whose ``graph.shard`` is an :class:`EdgeShard`;
    the replicated tensors are shared, not copied. ``design`` is packed
    with ``segment=True``."""
    g = design.graph
    require_tables(g, "shard_design")
    dev = g.cell_src[0].device
    fields = {f"{half}_{key}": []
              for half in ("cell", "net")
              for key in ("src", "dst_off", "src_pos", "src_rows", "src_off")}
    split = 0
    for k in range(g.num_pairs):
        for half in ("cell", "net"):
            src, slot, off, rows = (
                getattr(g, f"{half}_{key}")[k].cpu().numpy()
                for key in ("src", "dst_slot", "dst_off", "src_rows"))
            lo, hi = _block(len(src), mesh.n_gp, mesh.gp_rank)
            if half == "cell" and k > 0:
                split += split_slot_count(off, mesh.n_gp)
            for key, arr in zip(("src", "dst_off", "src_pos", "src_rows",
                                 "src_off"),
                                _level_block(src, slot, off, rows, lo, hi,
                                             half)):
                fields[f"{half}_{key}"].append(torch.from_numpy(
                    np.ascontiguousarray(arr, np.int32)).to(dev))
    most = max(t.shape[0] for key in ("cell_src_rows", "net_src_rows")
               for t in getattr(g, key))
    shard = EdgeShard(**{k: tuple(v) for k, v in fields.items()},
                      iota=torch.arange(most + 1, dtype=torch.int32,
                                        device=dev),
                      group=mesh.gp_group, split_slots=split)
    return dataclasses.replace(design,
                               graph=dataclasses.replace(g, shard=shard))


def graph_sharded_train_step(state, design, path_ids, mask, mesh: Mesh2D,
                             task: str = "reg",
                             batch_axis: str | None = DP_AXIS) -> dict:
    """One optimizer step over the ``(dp, gp)`` mesh: the path batch
    sharded on ``dp`` (``batch_axis="dp"``: :func:`parallel.dp.
    dp_train_step` over this rank's column: the whole batch's step,
    which gives what JAX's partitioner gives by summing the dp ranks'
    cotangents before the bf16 roundings, the gradient of the column's
    first rank broadcast) or replicated
    (``batch_axis=None``: ``trainer.train_step``, as JAX's gp-only
    mesh), the edge tables of ``design`` (:func:`shard_design`) sharded
    on ``gp``. Every rank passes the same batch and gets the metrics of
    the whole batch; every rank's state stays equal: the walk sums each
    level's partial reductions over ``gp``, and with ``--attn`` also
    ``fc_attn2``'s gradient, one all-reduce a step, since each rank's
    backward gives only its edge block's share of it. A bf16 segment
    model rounds as JAX's padded scan, the rounding of JAX's sharded
    step (the model's default)."""
    if design.graph.shard is None:
        raise ValueError("graph_sharded_train_step takes a design from "
                         "shard_design")
    if batch_axis == DP_AXIS:
        return dp_train_step(state, design, path_ids, mask, mesh.dp, task)
    if batch_axis is None:
        return train_step(state, design, path_ids, mask, task)
    raise ValueError(f"batch_axis {batch_axis!r}: {DP_AXIS!r} or None")
