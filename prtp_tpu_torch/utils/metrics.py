"""Evaluation metrics on tensors.

Port of ``prtp_tpu/utils/metrics.py`` (the reference's torchmetrics
R2Score, confusion-matrix arithmetic and the two task losses). Each
takes an optional validity ``mask`` so padded batch entries do not
contribute, and returns a 0-d tensor (``classification_metrics`` works
on host floats).
"""

from __future__ import annotations

import torch


def _flat_mask(target, mask):
    if mask is None:
        return torch.ones_like(target, dtype=torch.float32)
    return mask.reshape(-1).float()


def r2_score(pred, target, mask=None):
    """1 - SS_res / SS_tot, SS_tot around the masked mean."""
    pred, target = pred.reshape(-1), target.reshape(-1)
    mask = _flat_mask(target, mask)
    n = mask.sum().clamp_min(1.0)
    mean = (target * mask).sum() / n
    ss_res = (((pred - target) ** 2) * mask).sum()
    ss_tot = (((target - mean) ** 2) * mask).sum()
    return 1.0 - ss_res / ss_tot.clamp_min(1e-12)


def mape(pred, target, mask=None):
    """Mean absolute percentage error (a zero target counts as 1)."""
    pred, target = pred.reshape(-1), target.reshape(-1)
    mask = _flat_mask(target, mask)
    n = mask.sum().clamp_min(1.0)
    denom = torch.where(target == 0, torch.ones_like(target), target)
    return ((pred - target) / denom).abs().mul(mask).sum() / n


def mse_loss(pred, target, mask=None):
    """Masked mean-squared error (the reference's loss)."""
    pred, target = pred.reshape(-1), target.reshape(-1)
    mask = _flat_mask(target, mask)
    n = mask.sum().clamp_min(1.0)
    return (((pred - target) ** 2) * mask).sum() / n


def nll(logits, labels):
    """Per entry, the negative max-shifted log-softmax at the label (the
    reference's cls loss before its mean). ``take_along_dim`` broadcasts
    as JAX's ``take_along_axis`` does, so a 1-label head runs here where
    it runs there."""
    logits = logits.reshape(-1, logits.shape[-1])
    top = logits.amax(dim=-1, keepdim=True)
    logp = (logits - torch.log(torch.exp(logits - top).sum(-1, keepdim=True))
            - top)
    return -torch.take_along_dim(logp, labels.reshape(-1, 1).long(),
                                 dim=-1).reshape(-1)


def cross_entropy_loss(logits, labels, mask=None):
    """Masked softmax cross-entropy (the reference's cls loss): the mean
    of :func:`nll` over valid entries."""
    per = nll(logits, labels)
    mask = _flat_mask(per, mask)
    n = mask.sum().clamp_min(1.0)
    return (per * mask).sum() / n


def judge_critical(pred_arrival, required):
    """Label 1 where the predicted slack ``required - arrival`` < 0."""
    return ((required - pred_arrival) < 0).to(torch.int32)


def confusion_counts(pred_labels, labels, mask=None):
    """(tp, fp, tn, fn) counts treating nonzero labels as positive."""
    pred_pos = pred_labels != 0
    pos = labels != 0
    m = (torch.ones_like(labels, dtype=torch.float32) if mask is None
         else mask.float())
    tp = ((pred_pos & pos).float() * m).sum()
    fp = ((pred_pos & ~pos).float() * m).sum()
    tn = ((~pred_pos & ~pos).float() * m).sum()
    fn = ((~pred_pos & pos).float() * m).sum()
    return tp, fp, tn, fn


def classification_metrics(tp, fp, tn, fn):
    """acc/recall/precision/F1 with the reference's zero guards
    (recall = precision = 0 when tp == 0; F1 = 0 when both are 0)."""
    tp, fp, tn, fn = float(tp), float(fp), float(tn), float(fn)
    total = tp + fp + tn + fn
    acc = (tp + tn) / total if total > 0 else 0.0
    recall = tp / (tp + fn) if tp != 0 else 0.0
    precision = tp / (tp + fp) if tp != 0 else 0.0
    f1 = (2 * recall * precision / (recall + precision)
          if (precision != 0 or recall != 0) else 0.0)
    return acc, recall, precision, f1
