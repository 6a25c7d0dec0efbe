"""Segment reductions: a port of ``prtp_tpu/ops/segment.py``.

The plain PyTorch versions of JAX's ops, with JAX's conventions:
``segment_ids`` index destination slots ``[0, num_segments)``, a padded
edge carries the dummy slot ``num_segments - 1`` (and gathers a zero
dummy row), an empty segment's max is 0, not ``-inf``, and a softmax
denominator is clamped at ``1e-12``. No model path calls them: the
pair step under ``reduce_mode='segment'`` (:mod:`.segment_walk`) runs on
the port's exact flat edge tables through the kernels of
:mod:`.segment_kernels`, whose plain versions are built from these.
"""

from __future__ import annotations

import torch


def segment_sum(data, segment_ids, num_segments):
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_max_raw(data, segment_ids, num_segments):
    """``jax.ops.segment_max``: ``-inf`` for an empty segment."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce_(0, idx.expand_as(data), data, "amax")


def segment_max(data, segment_ids, num_segments):
    """Max-reduce; empty segments yield 0 (not -inf)."""
    out = segment_max_raw(data, segment_ids, num_segments)
    return torch.where(torch.isneginf(out), torch.zeros_like(out), out)


def segment_mean(data, segment_ids, num_segments):
    """Mean-reduce with empty segments yielding 0."""
    sums = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(torch.ones_like(data[:, 0]), segment_ids,
                         num_segments)
    return sums / counts.clamp_min(1.0)[:, None]


def softmax_parts(data, segment_ids, num_segments):
    """``(shift, ex)``: each segment's max, 0 where not finite, and
    ``exp(data - shift[segment_ids])``."""
    seg_max = segment_max_raw(data, segment_ids, num_segments)
    shift = torch.where(torch.isfinite(seg_max), seg_max,
                        torch.zeros_like(seg_max))
    return shift, torch.exp(data - shift[segment_ids.long()])


def segment_softmax_sum_fused(data, segment_ids, num_segments):
    """Mailbox softmax-weighted sum, both segment sums in one scatter over
    concatenated features (as JAX fuses them)."""
    _shift, ex = softmax_parts(data, segment_ids, num_segments)
    d = data.shape[1]
    both = segment_sum(torch.cat([ex, ex * data], dim=1), segment_ids,
                       num_segments)
    return both[:, d:] / both[:, :d].clamp_min(1e-12)


def segment_softmax_sum(data, segment_ids, num_segments):
    """Elementwise segment softmax-weighted sum: for each segment s and
    feature d, ``sum_e softmax_{e in s}(data[e, d]) * data[e, d]``."""
    _shift, ex = softmax_parts(data, segment_ids, num_segments)
    denom = segment_sum(ex, segment_ids, num_segments)
    numer = segment_sum(ex * data, segment_ids, num_segments)
    return numer / denom.clamp_min(1e-12)


def segment_weighted_softmax_sum(data, scores, segment_ids, num_segments):
    """Attention-style reduce: per-edge (per-head) scores -> segment
    softmax weights -> weighted sum of ``data``.

    ``scores`` is ``(E,)``/``(E, 1)`` for single-head, or ``(E, H)``
    multi-head, in which case each head softmax-weights its own
    ``D/H``-wide value slice of ``data`` (GAT-style concat). For each
    segment s (per head): ``alpha_e = softmax_{e in s}(scores[e])``,
    ``out[s] = sum_e alpha_e * data[e]``."""
    if scores.dim() == 2 and scores.shape[1] > 1:
        e, d = data.shape
        nh = scores.shape[1]
        if d % nh:
            raise ValueError("data dim must be divisible by num_heads")
        _shift, ex = softmax_parts(scores, segment_ids, num_segments)
        denom = segment_sum(ex, segment_ids, num_segments)
        weighted = (ex[:, :, None] * data.reshape(e, nh, d // nh)).reshape(
            e, d)
        numer = segment_sum(weighted, segment_ids, num_segments)
        out = (numer.reshape(num_segments, nh, d // nh)
               / denom.clamp_min(1e-12)[:, :, None])
        return out.reshape(num_segments, d)
    scores = scores.reshape(-1)
    _shift, ex = softmax_parts(scores, segment_ids, num_segments)
    denom = segment_sum(ex, segment_ids, num_segments)
    numer = segment_sum(ex[:, None] * data, segment_ids, num_segments)
    return numer / denom.clamp_min(1e-12)[:, None]
