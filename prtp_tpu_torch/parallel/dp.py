"""Data-parallel training and evaluation over the path batch.

Port of ``prtp_tpu/parallel/dp.py``: the math of
``make_shard_map_train_step`` and of ``make_dp_eval_step``. Every rank
holds the whole design and the whole state; only the batch is split
(:func:`shard_batch`). A rank runs the full level walk, the layout CNN
and their backward, and the head on its block. The loss is the rank's
masked sum over the global count of valid entries, so the ranks'
gradients sum to the one-rank gradient; FlatAdam keeps every gradient in
one flat buffer (``trainer.FlatAdam``), so the sum is one all-reduce a
step, then the ``flat_adam`` kernel runs on every rank alike. The
metrics are reduced: the loss's sum and count, R² from the reduced
target sums (its squares around the global mean in a second reduce),
the confusion counts summed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..trainer import task_loss_and_metrics
from ..utils import metrics as M


def shard_batch(path_ids, mask, mesh):
    """This rank's block of a padded batch, JAX's ``P("dp")`` layout: the
    last axis (``(B,)``, or ``(K, B)`` on a merged super-graph) padded
    with masked entries (id 0, mask 0) to a multiple of the mesh's size,
    rank r taking the r-th contiguous block."""
    b = path_ids.shape[-1]
    pad = (-b) % mesh.size
    if pad:
        path_ids = F.pad(path_ids, (0, pad))
        mask = F.pad(mask, (0, pad))
    per = (b + pad) // mesh.size
    block = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return path_ids[..., block], mask[..., block]


def broadcast_state(state, mesh) -> None:
    """Rank 0's parameters (FlatAdam's flat buffer) and module buffers on
    every rank, as JAX's ``device_put(state, replicated(mesh))``
    replicates its state."""
    dist.broadcast(state.optimizer.flat, 0, group=mesh.group)
    for buf in state.model.buffers():
        dist.broadcast(buf, 0, group=mesh.group)


def _all_reduce(t, mesh):
    dist.all_reduce(t, group=mesh.group)
    return t


def dp_train_step(state, design, path_ids, mask, mesh, task: str = "reg",
                  rounding: str | None = None) -> dict:
    """One data-parallel optimizer step: ``trainer.train_step`` on this
    rank's block of the batch (:func:`shard_batch`), the gradients summed
    over the ranks, then the update. Every rank passes the same batch and
    gets the same metrics, those of the whole batch."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad()
    ids, m = shard_batch(path_ids, mask, mesh)
    preds = model(design, ids, rounding=rounding)
    endpoints = design.path_endpoint[ids.reshape(-1)].long()
    labels = design.is_critical[endpoints]
    valid = m.reshape(-1).float()
    if task == "cls":
        per = M.nll(preds, labels)
        pred_labels = preds.detach().reshape(-1, preds.shape[-1]).argmax(-1)
        target = valid.new_zeros(valid.shape)
    else:
        target = design.arrival_time[endpoints]
        per = (preds.reshape(-1) - target) ** 2
        pred_labels = M.judge_critical(preds.detach().reshape(-1),
                                       design.required_time[endpoints])
    local = (per * valid).sum()
    # the global count (and target sum) before the loss can be formed
    count, t_sum = _all_reduce(torch.stack([valid.sum(),
                                            (target * valid).sum()]), mesh)
    n = count.clamp_min(1.0)
    (local / n).backward()
    mean = t_sum / n
    sums = _all_reduce(torch.stack([
        local.detach(), (((target - mean) ** 2) * valid).sum(),
        *M.confusion_counts(pred_labels, labels, valid)]), mesh)
    _all_reduce(opt.grad, mesh)
    opt.step()
    state.step += 1
    loss, ss_tot, tp, fp, tn, fn = sums.unbind()
    r2 = (1.0 - loss / ss_tot.clamp_min(1e-12) if task != "cls"
          else loss.new_zeros(()))
    return {"loss": loss / n, "r2": r2, "tp": tp, "fp": fp, "tn": tn,
            "fn": fn}


def dp_train_steps(state, design, batches, mesh, task: str = "reg",
                   rounding: str | None = None) -> dict:
    """:func:`dp_train_step` for each batch, in order
    (``trainer.train_steps``'s counterpart). Returns each metric stacked
    over the steps."""
    mets = [dp_train_step(state, design, ids, mask, mesh, task, rounding)
            for ids, mask in batches]
    if not mets:
        raise ValueError("dp_train_steps got no batches")
    return {k: torch.stack([m[k] for m in mets]) for k in mets[0]}


@torch.no_grad()
def dp_evaluate(model, design, path_ids, mask, mesh, task: str = "reg",
                rounding: str | None = None):
    """``test.evaluate`` sharded: each rank predicts its block, the
    blocks are gathered, and the metrics are those of the whole batch,
    on every rank. Returns ``(preds, metrics)`` shaped as ``evaluate``'s."""
    model.eval()
    ids, _m = shard_batch(path_ids, mask, mesh)
    local = model(design, ids, rounding=rounding).contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.group)
    axis = path_ids.dim() - 1
    preds = torch.cat(parts, dim=axis).narrow(axis, 0, path_ids.shape[-1])
    return preds, task_loss_and_metrics(task, preds, design, path_ids,
                                        mask)[1]
