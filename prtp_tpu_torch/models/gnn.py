"""TimeGNN — the levelized message-passing GNN (exact-levels walk).

Port of ``prtp_tpu/models/gnn.py::TimeGNN`` on its exact-levels path.
Reference semantics per topological level:

- net levels (odd):  ``h[v] = ReLU(fc_net_self(net_feat[v]) +
  mean_{u->v, net} h[u])``
- cell levels (even>0): mailbox softmax-weighted sum of incoming ``h``,
  then ``h[v] = ReLU(fc_cell_self(cell_feat[v]) + fc_cell_neigh(agg))``
- level 0 (PIs): ``h[v] = ReLU(fc_cell_self(cell_feat[v]))``

With ``flag_attn`` (``--attn --num_heads nh``) the cell levels reduce
their mailbox by multi-head attention instead: per-edge scores
``fc_attn2(h[u])`` (a bias-free ``Linear(out_dim, nh)``), a masked
softmax per head over the mailbox, and head i summing its own
``out_dim / nh`` value slice (JAX's ``_attn_sum``).

The walk itself is :func:`prtp_tpu_torch.ops.fused_gnn.exact_walk`: the
forward of ``exact_gnn_forward`` with JAX's hand-written backward
(``fused_vjp=True``, the JAX default), which returns the gradients of
the three pair-step MLPs (and ``fc_attn2``) and of ``h0``. The node-state carry is float32,
``(num_rows + 1, out_dim)``; the last row is the gather dummy. With
``mlp_dtype`` bfloat16 the pair-step MLPs' products take bf16 operands
and give float32 (JAX's ``mlp_dtype`` on the exact path); the carry
stays float32, as at ``prtp_tpu/models/gnn.py:314-321``. With
``rounding="scan"`` they round as JAX's padded scan does instead
(flax's ``MLP(dtype=bfloat16)``, as XLA compiles it and its
``jax.grad``), for the evaluations and the train steps that JAX runs
through it.

With ``reduce_mode="segment"`` (JAX's ``TimeGNN(reduce_mode=...)``;
``PathModel(gnn_reduce=...)``) the walk reduces over each level's flat
edge tables instead of its dense mailbox
(:func:`prtp_tpu_torch.ops.segment_walk.segment_walk`): the same
function, summed in another order; it is the reduce that the 2-D
``(dp, gp)`` edge-sharded step partitions (``parallel/graph_shard.py``).
With ``flag_attn`` its cell levels reduce by JAX's
``segment_weighted_softmax_sum`` under the same ``fc_attn2`` scores. In
bf16 it rounds as JAX's padded scan, the only path on which JAX runs the
segment reduce: its exact walk asserts the mailbox reduce
(``prtp_tpu/models/gnn.py:311-312``), so ``rounding="fused"`` is refused
there.

``rounding=None`` (every entry point's default) resolves by the reduce:
``"fused"`` under the mailbox reduce, ``"scan"`` under the segment
reduce (:meth:`TimeGNN.resolve_rounding`). In float32 the two roundings
are one function.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.bf16 import compute_dtype_of
from ..ops.fused_gnn import MLP_NAMES as PAIR_STEP_MLPS
from ..ops.fused_gnn import check_rounding, exact_walk
from ..ops.segment_walk import segment_walk
from .mlp import MLP, lecun_normal_

REDUCE_MODES = ("mailbox", "segment")


class TimeGNN(nn.Module):
    def __init__(self, cell_feat_dim: int, net_feat_dim: int,
                 generator: torch.Generator, out_dim: int = 128,
                 hidden_dim: int = 256, dgl_parity: bool = True,
                 flag_attn: bool = False, num_heads: int = 1,
                 mlp_dtype=None, reduce_mode: str = "mailbox"):
        super().__init__()
        self.out_dim = out_dim
        self.mlp_dtype = compute_dtype_of(mlp_dtype)
        if reduce_mode not in REDUCE_MODES:
            raise ValueError(f"reduce_mode {reduce_mode!r}: one of "
                             f"{REDUCE_MODES}")
        self.reduce_mode = reduce_mode
        self.dgl_parity = dgl_parity
        self.flag_attn = flag_attn
        # widths mirror the reference (256-wide single hidden layer)
        in_dims = {"fc_cell_self": cell_feat_dim, "fc_cell_neigh": out_dim,
                   "fc_net_self": net_feat_dim}
        for name in PAIR_STEP_MLPS:
            self.add_module(name, MLP(in_dims[name], (hidden_dim, out_dim),
                                      generator))
        if flag_attn:
            # one score column per head, flax's Dense(num_heads,
            # use_bias=False); heads read disjoint out_dim/nh slices
            if num_heads < 1 or out_dim % num_heads:
                raise ValueError(f"num_heads {num_heads} must divide "
                                 f"out_dim {out_dim}")
            self.fc_attn2 = nn.utils.skip_init(nn.Linear, out_dim, num_heads,
                                               bias=False)
            lecun_normal_(self.fc_attn2.weight, out_dim, generator)

    def resolve_rounding(self, rounding: str | None) -> str:
        """The walk's bf16 rounding for ``rounding``: None gives
        ``"scan"`` under the segment reduce, else ``"fused"``; a bf16
        segment walk refuses ``"fused"``, a function JAX does not have."""
        segment = self.reduce_mode == "segment"
        if rounding is None:
            return "scan" if segment else "fused"
        check_rounding(rounding)
        if segment and rounding == "fused" and self.mlp_dtype is not None:
            raise ValueError(
                "rounding='fused' under reduce_mode='segment' in bf16: JAX "
                "runs the segment reduce only through its padded scan; its "
                "exact walk asserts 'exact-levels mode supports the mailbox "
                "reduce' (prtp_tpu/models/gnn.py:311-312). Use "
                "rounding='scan' or None")
        return rounding

    def forward(self, g, h0: torch.Tensor | None = None,
                rounding: str | None = None, pair_sum=None) -> torch.Tensor:
        """The walk's final state ``(num_rows + 1, out_dim)`` from ``h0``
        (zeros if None). ``pair_sum``: a design-sharded rank's sum of its
        bf16 MLP gradients over the ranks (``ops.fused_gnn.
        MlpGradSums``)."""
        if h0 is None:
            dev = g.cell_feat_lvl[0].device
            h0 = torch.zeros((g.num_rows + 1, self.out_dim),
                             dtype=torch.float32, device=dev)
        params = {}
        for name in PAIR_STEP_MLPS:
            mlp = getattr(self, name)
            params[name] = (mlp.fc0.weight, mlp.fc0.bias, mlp.fc1.weight,
                            mlp.fc1.bias)
        if self.flag_attn:
            params["fc_attn2"] = self.fc_attn2.weight
        rounding = self.resolve_rounding(rounding)
        bf16 = self.mlp_dtype is not None
        if self.reduce_mode == "segment":  # the scan's rounding
            return segment_walk(params, h0, g, self.dgl_parity, bf16,
                                pair_sum)
        return exact_walk(params, h0, g, self.dgl_parity, bf16, rounding,
                          pair_sum)
