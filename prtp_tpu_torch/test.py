"""Evaluation: the serving path of the port.

Port of ``prtp_tpu/test.py::test`` (its metric part) and of
``prtp_tpu/trainer.py``'s ``make_eval_step``, for the regression task
(the loss, the metrics and ``pad_batch`` live in ``trainer.py``).
:func:`evaluate` runs the model over a batch of paths of a packed
design and returns predictions and metrics; :func:`evaluate_design` packs one parsed design, evaluates
all of its paths and prints the per-level R²/MAPE lines and the case
lines in the JAX driver's formats. Checkpoint loading and the CLI wait
for a torch checkpoint format (the JAX checkpoints are flax msgpack).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import resolve_device
from .graph import pack_design
from .trainer import pad_batch, task_loss_and_metrics
from .utils import metrics as M

__all__ = ["evaluate", "evaluate_design", "pad_batch"]


@torch.no_grad()
def evaluate(model, design, path_ids, mask):
    """Regression (preds, metrics) for a batch of path ids; metrics are
    0-d tensors. (``--task cls`` comes with the variants slice.)"""
    model.eval()
    preds = model(design, path_ids)
    return preds, task_loss_and_metrics(preds, design, path_ids, mask)[1]


def evaluate_design(model, parsed, device="cuda", case_idx: int = 0):
    """Pack ``parsed`` on ``device``, evaluate all of its paths and print
    the JAX driver's per-level and case lines.

    Returns ``(preds, metrics)``: numpy predictions of every path, and
    host floats (``loss, r2, tp, fp, tn, fn, acc, recall, precision,
    f1``, ``runtime`` = evaluation seconds, ``pack_s`` = packing
    seconds)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    design = pack_design(parsed, map_size=model.map_size, device=dev)
    pack_s = time.perf_counter() - t0
    num_paths = int(parsed["num_paths"])
    start = time.perf_counter()
    pids, mask = pad_batch(np.arange(num_paths), design.num_paths, dev)
    preds_t, mets_t = evaluate(model, design, pids, mask)
    preds = preds_t.cpu().numpy()[:num_paths]
    mets = {k: float(v) for k, v in mets_t.items()}
    runtime = time.perf_counter() - start

    levels = np.asarray(parsed["path2level"])
    endpoint = np.asarray(parsed["path_endpoint"], np.int64)
    arrival = torch.from_numpy(np.asarray(parsed["arrival_time"],
                                          np.float32)[endpoint])
    preds_cpu = torch.from_numpy(preds)
    # per-level diagnostics (reference src/test.py:211-216)
    for lvl in np.unique(levels):
        sel = torch.from_numpy(levels == lvl)
        if int(sel.sum()) >= 2:
            r2_l = float(M.r2_score(preds_cpu[sel], arrival[sel]))
            mape_l = float(M.mape(preds_cpu[sel], arrival[sel]))
            print(f"level {lvl}: #={int(sel.sum())}, r2={r2_l}, "
                  f"mape={mape_l}")
    acc, recall, precision, f1 = M.classification_metrics(
        mets["tp"], mets["fp"], mets["tn"], mets["fn"])
    print(f"case {case_idx}, runtime: {runtime}")
    print(f"\ttp: {int(mets['tp'])}  fp: {int(mets['fp'])} "
          f" fn: {int(mets['fn'])}  tn: {int(mets['tn'])} "
          f" precision: {round(precision, 3)}")
    print(f"\tloss:{mets['loss']:.3f}, r2:{mets['r2']:.3f}, acc:{acc:.3f}, "
          f"recall:{recall:.3f}, F1 score:{f1:.3f}")
    mets.update(acc=acc, recall=recall, precision=precision, f1=f1,
                runtime=runtime, pack_s=pack_s)
    return preds, mets
