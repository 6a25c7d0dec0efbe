"""Training engine: the train step over packed designs.

Port of ``prtp_tpu/trainer.py`` for the regression and the
classification task. The loss, the metrics, the parameters (masters)
and Adam's state are float32 whatever the model's compute dtype: a
bfloat16 model's output is float32 and each parameter's gradient
reaches :class:`FlatAdam` as float32. One :func:`train_step` is the
full-graph level walk, the CNN and the fusion head forward, the task's
masked loss on the endpoint batch, the backward (the walk's through its
hand-written :class:`~prtp_tpu_torch.ops.fused_gnn.ExactWalk`) and one
Adam update.
PyTorch runs eagerly, so where JAX jits a step and scans several, the
port calls the step in a Python loop (:func:`train_steps`). The U-Net's
BatchNorm running averages are module buffers that a step's forward
updates, as JAX's step returns its ``batch_stats``; the optimizer holds
parameters only.

Batches are fixed-size padded id vectors with a validity mask, as in
JAX: ``(B,)``, or ``(K, B)`` on a merged super-graph of K designs
(:func:`iterate_grouped_batches`), where the loss and the metrics run
over all K x B entries. Entry points take ``device=`` and default to
``"cuda"``; without a card they raise.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .ops.adam import flat_adam
from .utils import metrics as M


@dataclass
class TrainState:
    """The model (parameters), its optimizer (state), the step count and
    the best F1 and R² seen. The port's modules hold their parameters,
    so the state holds the module and no parameter tree."""

    model: nn.Module
    optimizer: FlatAdam
    step: int = 0
    best_f1: float = 0.0
    best_r2: float = -math.inf


class FlatAdam:
    """Adam over ONE flat parameter vector, run by the ``flat_adam``
    kernel: the math of JAX's ``make_flat_adam`` (coupled L2 weight
    decay, then Adam) in one launch a step.

    At construction every parameter becomes a view of one flat buffer
    (``p.data``) and its ``.grad`` a view of one flat gradient buffer,
    which autograd accumulates into in place; so the update reads and
    writes the vectors where they lie, with no concatenation or copy
    back. Build it after the model is on its device (``init_state``
    does): moving the model later breaks the views."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        params = list(params)
        if not params:
            raise ValueError("FlatAdam got no parameters")
        dev = params[0].device
        if any(p.dtype != torch.float32 or p.device != dev for p in params):
            raise ValueError("FlatAdam takes float32 parameters on one device")
        n = sum(p.numel() for p in params)
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.flat = torch.empty(n, dtype=torch.float32, device=dev)
        self.grad = torch.zeros(n, dtype=torch.float32, device=dev)
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = 0
        off = 0
        with torch.no_grad():
            for p in params:
                m = p.numel()
                view = self.flat[off: off + m].view_as(p)
                view.copy_(p)
                p.data = view
                p.grad = self.grad[off: off + m].view_as(p)
                off += m

    def state_dict(self) -> dict:
        """The moments and the step count (the parameters are the
        model's); ``utils.checkpoint`` saves them."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """Copy saved moments into the buffers in place (never rebind
        them), so that what the update reads stays where it lies."""
        for key in ("mu", "nu"):
            src = state[key]
            if src.shape != self.flat.shape:
                raise ValueError(f"FlatAdam {key}: saved {tuple(src.shape)}"
                                 f", expected {tuple(self.flat.shape)}")
            getattr(self, key).copy_(src)
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        self.grad.zero_()

    def step(self) -> None:
        self.count += 1
        flat_adam(self.flat, self.grad, self.mu, self.nu, self.lr, self.b1,
                  self.b2, self.eps, self.weight_decay, self.count)


def make_optimizer(learning_rate: float, weight_decay: float = 0.0):
    """A factory ``params -> FlatAdam`` that ``init_state`` calls: Adam
    with torch-style (coupled) L2 weight decay over one flat vector. JAX's
    optax chain and its ``make_flat_adam`` (``--flat_adam``) compute the
    same math; the port has only the flat form."""

    def build(params):
        return FlatAdam(params, learning_rate, weight_decay)

    return build


def init_state(model: nn.Module, tx, device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (parameters and buffers) and build its
    optimizer over the parameters with the factory ``tx``
    (:func:`make_optimizer`)."""
    model.to(resolve_device(device))
    return TrainState(model=model, optimizer=tx(list(model.parameters())))


def task_loss_and_metrics(task, preds, design, path_ids, mask):
    """Port of ``_task_loss_and_metrics``: the task's loss
    (differentiable) and the metrics ``loss, r2, tp, fp, tn, fn`` as 0-d
    tensors, computed from the detached predictions. ``task="cls"``: the
    cross-entropy against the endpoints' critical labels, ``argmax``
    labels, r2 0. Any other task is regression: the masked MSE against
    the arrival times, labels where the predicted slack is negative."""
    endpoints = design.path_endpoint[path_ids].long()
    return loss_and_metrics(task, preds, design.is_critical[endpoints],
                            design.arrival_time[endpoints],
                            design.required_time[endpoints], mask)


def loss_and_metrics(task, preds, labels, arrival, required, mask):
    """:func:`task_loss_and_metrics` given each entry's endpoint label,
    arrival and required time, shaped as the batch."""
    p = preds.detach()
    if task == "cls":
        loss = M.cross_entropy_loss(preds, labels, mask)
        r2, pred_labels = p.new_zeros(()), p.argmax(dim=-1)
    else:
        loss = M.mse_loss(preds, arrival, mask)
        r2 = M.r2_score(p, arrival, mask)
        pred_labels = M.judge_critical(p, required)
    tp, fp, tn, fn = M.confusion_counts(pred_labels, labels, mask)
    mets = {"loss": loss.detach(), "r2": r2, "tp": tp, "fp": fp, "tn": tn,
            "fn": fn}
    return loss, mets


def loss_backward(state: TrainState, design, path_ids, mask,
                  task: str = "reg", rounding: str | None = None) -> dict:
    """:func:`train_step` without its update: the forward, the task's
    loss and its backward, after which the parameters' ``.grad``
    (FlatAdam's flat gradient) hold the batch's gradients. Returns the
    metrics."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad()
    preds = model(design, path_ids, rounding=rounding)
    loss, mets = task_loss_and_metrics(task, preds, design, path_ids, mask)
    loss.backward()
    return mets


def train_step(state: TrainState, design, path_ids, mask,
               task: str = "reg", rounding: str | None = None) -> dict:
    """One optimizer step on a batch: forward (BatchNorm in train mode:
    batch statistics, running averages updated), the task's loss,
    backward, update. Returns the step's metrics (0-d tensors on the
    device; reading them waits for the device). The parameters' ``.grad``
    keep this step's gradients until the next step. ``rounding``: the
    walk's bf16 rounding, forward and backward (``"fused"``, JAX's fused
    exact walk, or ``"scan"``, its padded scan; None, the default, the
    model's reduce's: ``models/gnn.py``)."""
    mets = loss_backward(state, design, path_ids, mask, task, rounding)
    state.optimizer.step()
    state.step += 1
    return mets


def train_steps(state: TrainState, design, batches,
                task: str = "reg", rounding: str | None = None) -> dict:
    """One step per ``(path_ids, mask)`` of ``batches``, in order: the
    eager counterpart of JAX's ``make_scan_train_step``. Returns each
    metric stacked over the steps, shape ``(n_steps,)``."""
    mets = [train_step(state, design, ids, mask, task, rounding)
            for ids, mask in batches]
    if not mets:
        raise ValueError("train_steps got no batches")
    return {k: torch.stack([m[k] for m in mets]) for k in mets[0]}


def pad_batch(path_ids, batch_size: int, device="cuda"):
    """Pad a path-id batch to a fixed size; returns (ids int64, mask)."""
    dev = resolve_device(device)
    n = len(path_ids)
    ids = torch.zeros(batch_size, dtype=torch.int64)
    ids[:n] = torch.as_tensor(np.asarray(path_ids, np.int64))
    mask = torch.zeros(batch_size, dtype=torch.float32)
    mask[:n] = 1.0
    return ids.to(dev), mask.to(dev)


def iterate_batches(path_ids, batch_size: int, rng: np.random.Generator,
                    drop_last: bool = False, device="cuda"):
    """Shuffled fixed-size padded batches over a path-id universe, as
    JAX's ``iterate_batches`` draws them from ``rng``: one padded batch
    when the universe fits in one, else shuffled full batches and,
    unless ``drop_last``, the padded rest."""
    dev = resolve_device(device)
    ids = np.asarray(path_ids, np.int64)
    ids = ids[rng.permutation(len(ids))]
    if len(ids) <= batch_size:
        yield pad_batch(ids, batch_size, dev)
        return
    n_full = len(ids) // batch_size
    for i in range(n_full):
        yield pad_batch(ids[i * batch_size: (i + 1) * batch_size],
                        batch_size, dev)
    rem = ids[n_full * batch_size:]
    if len(rem) and not drop_last:
        yield pad_batch(rem, batch_size, dev)


def iterate_grouped_batches(per_design_ids, batch_size: int,
                            rng: np.random.Generator, device="cuda"):
    """Grouped batches over a merged super-graph
    (:func:`prtp_tpu_torch.graph.merge_parsed_designs`), as JAX's
    ``iterate_grouped_batches`` draws them from ``rng``: rounds of
    ``(ids (K, B), mask (K, B))`` where row k draws only from design k's
    universe, each universe shuffled once; a design with fewer batches
    pads out with zero-mask rows once exhausted."""
    dev = resolve_device(device)
    streams = [np.asarray(ids, np.int64)[rng.permutation(len(ids))]
               for ids in per_design_ids]
    n_rounds = max(batch_count(len(s), batch_size, drop_last=False)
                   for s in streams)
    for r in range(n_rounds):
        rows = [pad_batch(s[r * batch_size: (r + 1) * batch_size],
                          batch_size, "cpu") for s in streams]
        yield (torch.stack([i for i, _m in rows]).to(dev),
               torch.stack([m for _i, m in rows]).to(dev))


def batch_count(num_ids: int, batch_size: int, drop_last: bool) -> int:
    if num_ids <= batch_size:
        return 1
    n_full = num_ids // batch_size
    rem = num_ids % batch_size
    return n_full + (1 if rem and not drop_last else 0)


class DesignCache:
    """Packed-design cache: loads and packs a design once per process.

    :meth:`prefetch` loads and packs a design on ONE background thread,
    so host-side work (reading, the level tables, the copies to the
    device) overlaps the steps of the design in training.
    A prefetch failure is not swallowed: it re-raises at :meth:`get`.
    :meth:`close` stops the thread."""

    def __init__(self, pack_fn):
        self._pack = pack_fn
        self._cache = {}
        self._pending = {}
        self._pool = None

    def _load_and_pack(self, loader):
        parsed = loader()
        return (self._pack(parsed), parsed)

    def get(self, key, loader):
        """``(packed, parsed)`` of ``key``, loading it with ``loader()``
        unless cached or prefetched."""
        if key in self._cache:
            return self._cache[key]
        fut = self._pending.pop(key, None)
        if fut is not None:
            self._cache[key] = fut.result()  # re-raises worker errors
        else:
            self._cache[key] = self._load_and_pack(loader)
        return self._cache[key]

    def prefetch(self, key, loader):
        """Schedule load+pack of ``key`` in the background (idempotent)."""
        if key in self._cache or key in self._pending:
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="prtp-prefetch")
        self._pending[key] = self._pool.submit(self._load_and_pack, loader)

    def close(self):
        """Wait for pending prefetches and stop the worker thread."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
