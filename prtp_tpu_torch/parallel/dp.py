"""Data-parallel training and evaluation over the path batch.

Port of ``prtp_tpu/parallel/dp.py``: the step of ``make_dp_train_step``
(the single-chip step jitted with the batch sharded over ``dp``) and of
``make_dp_eval_step``. Every rank holds the whole design and the whole
state, and every rank passes the whole batch.

The training step replicates the compute: every rank runs
``trainer.train_step``'s forward, loss and backward on the whole batch
(``trainer.loss_backward``), then takes rank 0's flat gradient
(broadcast) and updates. Where the dp sum sits decides a bf16 step's
bits. XLA's partitioner (read from the compiled HLO of JAX's bf16 step
on the CPU mesh) sums float32 values before every bf16 rounding of the
backward: the walk's output cotangent, the fcn product's float32 weight
cotangent and the head's float32 weight and bias products, each
all-reduced and only then rounded, so its sharded step's gradients
equal its one-device step's to float32 rounding. A rank that
backpropagates the whole batch's loss computes exactly those gradients
with no sum at all: the walk and the layout CNN read only the design,
which every rank holds, so they ran whole on every rank anyway, and the
head's rows are a few hundred. The broadcast keeps every rank's flat
Adam state bit-equal, since on a card the replicated backward may add
in another order on each rank (atomic ``index_add_``, cuDNN's weight
gradients). The metrics are the whole batch's, computed on every rank.
Evaluation is sharded: each rank predicts its block of the batch
(:func:`shard_batch`) and the blocks are gathered.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..trainer import loss_backward, task_loss_and_metrics


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


def root_rank(mesh) -> int:
    """The global rank of the mesh's rank 0 (its group's first)."""
    return 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)


def broadcast_state(state, mesh) -> None:
    """Rank 0's parameters (FlatAdam's flat buffer) and module buffers on
    every rank, as JAX's ``device_put(state, replicated(mesh))``
    replicates its state."""
    src = root_rank(mesh)
    dist.broadcast(state.optimizer.flat, src, group=mesh.group)
    for buf in state.model.buffers():
        dist.broadcast(buf, src, group=mesh.group)


def dp_train_step(state, design, path_ids, mask, mesh, task: str = "reg",
                  rounding: str | None = None) -> dict:
    """One data-parallel optimizer step. Every rank passes the same batch
    and gets the same gradients, state and metrics: those of
    ``trainer.train_step`` on the whole batch, rank 0's gradient
    broadcast before the update (module doc)."""
    mets = loss_backward(state, design, path_ids, mask, task, rounding)
    dist.broadcast(state.optimizer.grad, root_rank(mesh), group=mesh.group)
    state.optimizer.step()
    state.step += 1
    return mets


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
