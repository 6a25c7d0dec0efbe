"""Multi-design training and evaluation, with the design axis sharded.

Port of ``prtp_tpu/parallel/multi.py``. JAX pads K designs to one
bucket, stacks them (``graph.stack_designs``) and ``vmap``s the model
over the designs; with a mesh the design axis is sharded over ``dp``, so
each chip owns whole designs and the gradients are ``psum``'d. The port
walks the designs' super-graph once (:class:`~prtp_tpu_torch.graph.
StackedDesigns`, whose docstring says why), reading per-design path ids
``(K, B)`` as its path rows. A step computes what JAX's vmapped step
computes: the masked per-path loss summed over all K x B entries over
the global count, R² over the flattened K x B predictions, the confusion
counts summed, one optimizer step. The walk rounds as JAX's padded scan
(``rounding="scan"``), the walk JAX's stacked designs take.

With a mesh (``parallel.mesh.Mesh``, one rank a process) rank r takes
the r-th contiguous block of K / n designs, JAX's ``P("dp")`` on the
leading axis, and walks its block's super-graph. Its loss is its block's
masked sum over the global count, so the ranks' gradients sum to the
one-rank gradient. Each device's walk runs on its own designs, so the
sum cannot come before the walk's roundings as in ``parallel.dp``; the
compiled HLO of JAX's design-sharded bf16 step shows where it sits
instead: every bf16 gradient is this rank's bf16 sum over its designs,
summed over the ranks (in float32) and rounded to bf16 again, the walk's
pair by pair inside its scan (the model's ``pair_sum``,
:class:`~prtp_tpu_torch.ops.fused_gnn.MlpGradSums`), every other
parameter's once, after the backward; float32 gradients (a float32
model's, ``fc_attn2``'s) are summed once. A rank packs only its own
block of designs; its predictions and their targets are gathered onto
every rank, and the metrics are the whole stack's.

The U-Net is refused, as JAX refuses it: its BatchNorm statistics are
undefined per vmapped design.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.gnn import PAIR_STEP_MLPS
from ..ops.bf16 import BF16
from ..trainer import loss_and_metrics
from ..utils import metrics as M


def _reject_unet(model):
    if getattr(model, "unet", False) and getattr(model, "use_cnn", True):
        raise NotImplementedError(
            "--unet under the vmapped multi-design step is unsupported: "
            "BatchNorm running stats are undefined per vmapped design. "
            "Use LayoutNet here, or merge the designs into one "
            "super-graph (prtp_tpu.graph.merge_parsed_designs + grouped "
            "path_ids), where BN sees the K rasters as a normal batch.")


def design_block(stacked, path_ids, mesh=None) -> tuple:
    """``(lo, hi)``: the designs this rank owns, all K without a mesh,
    else the rank's contiguous block of K / n. K must match ``path_ids``
    ``(K, B)`` and be divisible by the mesh's size, as JAX's sharding of
    the design axis requires."""
    k = len(stacked)
    if path_ids.dim() != 2 or path_ids.shape[0] != k:
        raise ValueError(f"path_ids {tuple(path_ids.shape)}: (K, B) with "
                         f"K = {k}, the stacked designs")
    if mesh is None:
        return 0, k
    if k % mesh.size:
        raise ValueError(
            f"the design axis is sharded over dp: its global size K = {k} "
            f"should be divisible by the mesh's {mesh.size}")
    per = k // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def _gather(block, mesh):
    """The ranks' blocks along the design axis, in rank order: ``(K,
    ...)`` on every rank."""
    if mesh is None:
        return block
    parts = [torch.empty_like(block) for _ in range(mesh.size)]
    dist.all_gather(parts, block.contiguous(), group=mesh.group)
    return torch.cat(parts)


class _PairSum:
    """The walk's ``pair_sum`` on a design-sharded rank: sums a flat float32
    tensor over the mesh in place; ``pairs``, the level pairs of JAX's
    bucket (every rank's scan runs them all)."""

    def __init__(self, mesh, pairs: int):
        self.mesh, self.pairs = mesh, pairs

    def __call__(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, group=self.mesh.group)


def _sum_gradients(model, opt, mesh) -> None:
    """Sum the ranks' gradients (module doc): a float32 model's in one
    all-reduce; a bf16 model's walk MLPs were summed in its backward, and
    every other parameter's is summed in one all-reduce and rounded to
    bf16, but ``fc_attn2``'s (float32 in the scan)."""
    if model.compute_dtype is None:
        dist.all_reduce(opt.grad, group=mesh.group)
        return
    walk = ({id(p) for name in PAIR_STEP_MLPS
             for p in getattr(model.gnn, name).parameters()}
            if model.use_gnn else set())
    rest = [p for p in model.parameters() if id(p) not in walk]
    flat = torch.cat([p.grad.reshape(-1) for p in rest])
    dist.all_reduce(flat, group=mesh.group)
    attn = (model.gnn.fc_attn2.weight
            if model.use_gnn and model.gnn.flag_attn else None)
    for p, g in zip(rest, flat.split([p.numel() for p in rest])):
        g = g.view_as(p)
        p.grad.copy_(g if p is attn else g.to(BF16))


def entry_losses(task, preds, design, path_ids):
    """The task's loss of each entry, flat: ``task="cls"`` the
    cross-entropy (``metrics.nll``) against the endpoints' labels, any
    other task the squared error against their arrival times."""
    endpoints = design.path_endpoint[path_ids.reshape(-1)].long()
    if task == "cls":
        return M.nll(preds, design.is_critical[endpoints])
    return (preds.reshape(-1) - design.arrival_time[endpoints]) ** 2


def _metrics(task, preds, design, ids, mask, mesh) -> tuple:
    """``(preds, metrics)``: this rank's block of predictions ``(K / n,
    B[, nlabels])`` on ``design``'s path rows ``ids`` and their targets
    gathered onto every rank, and the metrics of all ``(K, B)``."""
    endpoints = design.path_endpoint[ids].long()
    preds, labels, arrival, required = (_gather(t, mesh) for t in (
        preds, design.is_critical[endpoints], design.arrival_time[endpoints],
        design.required_time[endpoints]))
    return preds, loss_and_metrics(task, preds, labels, arrival, required,
                                   mask)[1]


def multidesign_train_step(state, stacked, path_ids, mask, task: str = "reg",
                           mesh=None) -> dict:
    """One optimizer step over the stacked designs (``graph.
    stack_designs``) and per-design path ids and mask ``(K, B)``, JAX's
    ``make_multidesign_train_step``; with ``mesh`` the design axis
    sharded over it. Every rank passes the whole stack and batch and gets
    the same state and metrics."""
    model, opt = state.model, state.optimizer
    _reject_unet(model)
    lo, hi = design_block(stacked, path_ids, mesh)
    design, ids = stacked.rows(lo, hi, path_ids[lo:hi])
    pair_sum = (None if mesh is None or model.compute_dtype is None
                else _PairSum(mesh, stacked.num_pairs))
    model.train()
    opt.zero_grad()
    preds = model(design, ids, rounding="scan", pair_sum=pair_sum)
    count = mask.reshape(-1).float().sum().clamp_min(1.0)
    local = (entry_losses(task, preds, design, ids)
             * mask[lo:hi].reshape(-1).float()).sum()
    (local / count).backward()
    if mesh is not None:
        _sum_gradients(model, opt, mesh)
    opt.step()
    state.step += 1
    return _metrics(task, preds.detach(), design, ids, mask, mesh)[1]


@torch.no_grad()
def multidesign_eval_step(model, stacked, path_ids, mask, task: str = "reg",
                          mesh=None):
    """JAX's ``make_multidesign_eval_step``: ``(preds (K, B[, nlabels]),
    metrics)`` over the stacked designs, the predictions gathered onto
    every rank with ``mesh``."""
    _reject_unet(model)
    lo, hi = design_block(stacked, path_ids, mesh)
    design, ids = stacked.rows(lo, hi, path_ids[lo:hi])
    model.eval()
    return _metrics(task, model(design, ids, rounding="scan"), design, ids,
                    mask, mesh)
