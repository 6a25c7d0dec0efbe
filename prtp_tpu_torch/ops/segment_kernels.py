"""The segment reduce's three CUDA kernels and their plain versions.

The pair step under ``reduce_mode='segment'`` (:mod:`.segment_walk`)
runs on the port's exact flat edge tables (``graph.py``: a level's edges
sorted by destination slot, with the slots' CSR offsets, and sorted by
source row for the backward), through:

- :func:`segment_softmax_sum`: JAX's ``segment_softmax_sum_fused`` of
  ``h[src]`` (``prtp_tpu/ops/segment.py:51-63``) read straight from
  ``h``; with ``partial`` (a rank of the edge-sharded step) the
  numerator and each slot's shift and denominator, which the combine
  over ranks needs;
- :func:`segment_mean`: ``segment_sum(h[src], ...) / net_cnt``;
- :func:`segment_softmax_sum_bwd`: the per-edge cotangent of the first,
  recomputing each slot's softmax from ``h`` or reading the combined
  statistics the edge-sharded walk saved.

The backward's scatter-add of per-edge (or per-slot) cotangents into
``dh`` by source row is the mailbox walk's ``mailbox_scatter``
(:mod:`.fused_gnn`) on the packer's source-sorted tables.

The kernels are ``csrc/<name>.cu`` (whose source notes give bound and
design); each plain version computes the JAX expression with the ops of
:mod:`.segment`. For tensors on the CPU a wrapper runs the plain version;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p

import torch

from . import _build
from .fused_gnn import _check_index, _check_rows, _stream
from .gather import device_of
from .segment import segment_sum, softmax_parts

_SOFTMAX_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,
                     c_void_p, c_int64, c_int, c_int, c_void_p]
_MEAN_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_int64,
                  c_int, c_void_p]
_SOFTMAX_BWD_ARGTYPES = [c_void_p] * 8 + [c_int64, c_int, c_void_p]


def _segment_ids(off: torch.Tensor) -> torch.Tensor:
    """The destination slot of each edge of the CSR offsets ``off``."""
    return torch.repeat_interleave(
        torch.arange(off.shape[0] - 1, device=off.device),
        (off[1:] - off[:-1]).long())


def _check_csr(src, off):
    _check_index(src, "src", dim=1)
    _check_index(off, "off", dim=1)
    if off.shape[0] < 1:
        raise ValueError("off must hold at least one offset")


def _softmax_parts_plain(h, src, off):
    """``(numer, mx, den)`` of each slot by the JAX expressions on
    ``h[src]``."""
    s = off.shape[0] - 1
    seg = _segment_ids(off)
    m = h[src.long()]
    shift, ex = softmax_parts(m, seg, s)
    return segment_sum(ex * m, seg, s), shift, segment_sum(ex, seg, s)


def segment_softmax_sum_plain(h, src, off, partial=False):
    """:func:`segment_softmax_sum` by the JAX expressions on
    ``h[src]``."""
    numer, shift, den = _softmax_parts_plain(h, src, off)
    if partial:
        return numer, shift, den
    return numer / den.clamp_min(1e-12), None, None


def segment_softmax_sum(h: torch.Tensor, src: torch.Tensor, off: torch.Tensor,
                        partial: bool = False):
    """The segment reduce's cell half, read straight from the node state:
    for each destination slot s (edges ``[off[s], off[s+1])`` of the
    destination-sorted ``src``) and channel, the softmax over its edges of
    ``h[src]`` weighting ``h[src]`` (``segment_softmax_sum_fused``).
    Returns ``(out, mx, den)``: the result (S, D), and ``mx = den = None``.
    With ``partial`` (a rank of the edge-sharded step): the numerator,
    undivided, the shift (the max, 0 where not finite: 0 for an empty
    slot) and the denominator (0 for an empty slot), each (S, D). h (R, D)
    float32 contiguous, src (E,) and off (S+1,) int32."""
    _check_rows("h", h)
    _check_csr(src, off)
    if device_of("segment_softmax_sum", h, src, off).type == "cpu":
        return segment_softmax_sum_plain(h, src, off, partial)
    s, d = off.shape[0] - 1, h.shape[1]
    out = torch.empty((s, d), dtype=h.dtype, device=h.device)
    mx, den = ((torch.empty_like(out), torch.empty_like(out)) if partial
               else (None, None))
    if s == 0:
        return out, mx, den
    with torch.cuda.device(h.device):
        _build.launch("segment_softmax_sum", _SOFTMAX_ARGTYPES, h.data_ptr(),
                      src.data_ptr(), off.data_ptr(), out.data_ptr(),
                      mx.data_ptr() if partial else 0,
                      den.data_ptr() if partial else 0, s, d, int(partial),
                      _stream(h))
    segment_softmax_sum.launches += 1
    return out, mx, den


segment_softmax_sum.launches = 0


def segment_mean_plain(h, src, off, cnt=None):
    """``segment_sum(h[src], ...)``, divided by ``cnt`` when given."""
    s = off.shape[0] - 1
    sums = segment_sum(h[src.long()], _segment_ids(off), s)
    return sums if cnt is None else sums / cnt[:, None]


def segment_mean(h: torch.Tensor, src: torch.Tensor, off: torch.Tensor,
                 cnt: torch.Tensor | None) -> torch.Tensor:
    """The segment reduce's net half, read straight from the node state:
    for each destination slot s, the sum of ``h[src[e]]`` over its edges
    (in edge order) divided by ``cnt[s]`` (the graph's ``net_cnt``), or
    the sum itself when ``cnt`` is None. h (R, D) float32 contiguous, src
    (E,) and off (S+1,) int32, cnt (S,) float32 -> (S, D)."""
    _check_rows("h", h)
    _check_csr(src, off)
    s, d = off.shape[0] - 1, h.shape[1]
    tensors = [h, src, off]
    if cnt is not None:
        if (cnt.dtype != torch.float32 or not cnt.is_contiguous()
                or cnt.shape != (s,)):
            raise ValueError(f"cnt must be a contiguous float32 ({s},) "
                             f"tensor, got {cnt.dtype} {tuple(cnt.shape)}")
        tensors.append(cnt)
    if device_of("segment_mean", *tensors).type == "cpu":
        return segment_mean_plain(h, src, off, cnt)
    out = torch.empty((s, d), dtype=h.dtype, device=h.device)
    if s == 0:
        return out
    with torch.cuda.device(h.device):
        _build.launch("segment_mean", _MEAN_ARGTYPES, h.data_ptr(),
                      src.data_ptr(), off.data_ptr(),
                      0 if cnt is None else cnt.data_ptr(), out.data_ptr(),
                      s, d, _stream(h))
    segment_mean.launches += 1
    return out


segment_mean.launches = 0


def segment_softmax_sum_bwd_plain(h, src, off, g, stats=None):
    """``d_msg[e] = g[s] * w_e * (1 + x_e - out[s])`` with ``x_e =
    h[src[e]]`` and ``w_e = exp(x_e - mx[s]) / max(den[s], 1e-12)``;
    ``(out, mx, den)`` is ``stats``, or recomputed as
    :func:`segment_softmax_sum_plain` computes them."""
    if stats is None:
        numer, mx, den = _softmax_parts_plain(h, src, off)
        out = numer / den.clamp_min(1e-12)
    else:
        out, mx, den = stats
    seg = _segment_ids(off)
    x = h[src.long()]
    w = torch.exp(x - mx[seg]) / den.clamp_min(1e-12)[seg]
    return (g[seg] * w) * ((1.0 + x) - out[seg])


def segment_softmax_sum_bwd(h: torch.Tensor, src: torch.Tensor,
                            off: torch.Tensor, g: torch.Tensor,
                            stats=None) -> torch.Tensor:
    """The per-edge cotangent (E, D) of :func:`segment_softmax_sum` for
    the output cotangent ``g`` (S, D): edge e of slot s gets ``g[s] * w_e
    * (1 + h[src[e]] - out[s])``, ``w_e`` its softmax weight. Without
    ``stats`` each slot's ``(out, mx, den)`` is recomputed from ``h``, as
    the forward computed it; under the edge-sharded step, where a rank
    holds only a block of a slot's edges, ``stats`` is the slots'
    combined ``(out, mx, den)``, each (S, D). h (R, D) float32 contiguous
    (the final node state: every source row of a level is final once it
    is written), src (E,) and off (S+1,) int32."""
    _check_rows("h", h)
    _check_csr(src, off)
    s, d = off.shape[0] - 1, h.shape[1]
    named = [("g", g)]
    if stats is not None:
        named += list(zip(("out", "mx", "den"), stats))
    for what, t in named:
        _check_rows(what, t)
        if t.shape != (s, d):
            raise ValueError(f"{what} {tuple(t.shape)} must be ({s}, {d})")
    if device_of("segment_softmax_sum_bwd", h, src, off,
                 *(t for _, t in named)).type == "cpu":
        return segment_softmax_sum_bwd_plain(h, src, off, g, stats)
    d_msg = torch.empty((src.shape[0], d), dtype=h.dtype, device=h.device)
    if src.shape[0] == 0:
        return d_msg
    ptrs = [0, 0, 0] if stats is None else [t.data_ptr() for t in stats]
    with torch.cuda.device(h.device):
        _build.launch("segment_softmax_sum_bwd", _SOFTMAX_BWD_ARGTYPES,
                      h.data_ptr(), src.data_ptr(), off.data_ptr(), *ptrs,
                      g.data_ptr(), d_msg.data_ptr(), s, d, _stream(h))
    segment_softmax_sum_bwd.launches += 1
    return d_msg


segment_softmax_sum_bwd.launches = 0
