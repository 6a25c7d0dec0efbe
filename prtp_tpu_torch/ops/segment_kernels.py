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
- :func:`segment_mean`: ``segment_sum(h[src], ...) / net_cnt``, and
  :func:`net_update`, the same kernel's update mode: the net half's
  update of ``h`` (``relu(pre + mean)`` where a row has in-edges, else
  ``relu(old)``) written in place;
- :func:`segment_softmax_sum_bwd`: the per-edge cotangent of the first,
  recomputing each slot's softmax from ``h`` or reading the combined
  statistics the edge-sharded walk saved;
- :func:`segment_attn_sum` (``--attn``): JAX's
  ``segment_weighted_softmax_sum`` of ``h[src]`` with the scores
  ``fc_attn2(h[src])`` (``prtp_tpu/ops/segment.py:86-127``,
  ``prtp_tpu/models/gnn.py:178-182``), read straight from ``h``; with
  ``partial`` the numerator and each slot's per-head shift and
  denominator;
- :func:`segment_attn_bwd`: its per-edge cotangent and ``fc_attn2``'s
  gradient, in the same two modes as :func:`segment_softmax_sum_bwd`;
  the walk adds each pair's gradient into one :class:`AttnGradSum` a
  backward, reduced once after the last pair.

The backward's scatter-add of per-edge (or per-slot) cotangents into
``dh`` by source row is the mailbox walk's ``mailbox_scatter``
(:mod:`.fused_gnn`) on the packer's source-sorted tables.

The kernels are ``csrc/<name>.cu`` (whose source notes give bound and
design); each plain version computes the JAX expression with the ops of
:mod:`.segment`. For tensors on the CPU a wrapper runs the plain version;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from ctypes import addressof, c_int, c_int64, c_void_p

import torch
import torch.nn.functional as F

from . import _build
from .fused_gnn import _check_attn_w, _check_index, _check_rows, _stream
from .gather import device_of
from .segment import segment_sum, softmax_parts

_SOFTMAX_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,
                     c_void_p, c_int64, c_int, c_int, c_void_p]
_MEAN_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_int64,
                  c_int, c_void_p]
_UPDATE_ARGTYPES = [c_void_p] * 6 + [c_int64, c_int64, c_int, c_void_p]
_SOFTMAX_BWD_ARGTYPES = [c_void_p] * 8 + [c_int64, c_int, c_void_p]
_ATTN_ARGTYPES = [c_void_p] * 7 + [c_int64, c_int, c_int, c_int, c_void_p]
_ATTN_BWD_ARGTYPES = [c_void_p] * 10 + [c_int64, c_int, c_int, c_int, c_int,
                                        c_void_p, c_void_p]
_DW_REDUCE_ARGTYPES = [c_void_p, c_void_p, c_int, c_int, c_void_p]
_ATTN_GRID_ARGTYPES = [c_int, c_int, c_void_p]


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


def net_epilogue(h, pre, mean, has_in, n0):
    """The net half's update of ``h``'s rows ``[n0, n0 + S)`` in place
    (``prtp_tpu/models/gnn.py:200-204`` with ``_masked_update``):
    ``relu(pre + mean)`` where ``has_in`` (every row when it is None),
    else ``relu`` of the old row. Five PyTorch ops."""
    new = F.relu(pre + mean)
    if has_in is not None:
        new = torch.where(has_in, new, F.relu(h[n0: n0 + pre.shape[0]]))
    h[n0: n0 + pre.shape[0]] = new


def net_update_plain(h, src, off, cnt, pre, has_in, n0):
    """:func:`net_update` as the walk computed it before the kernel took
    the update: the mean, then :func:`net_epilogue`."""
    net_epilogue(h, pre, segment_mean_plain(h, src, off, cnt), has_in, n0)


def net_update(h: torch.Tensor, src: torch.Tensor, off: torch.Tensor,
               cnt: torch.Tensor, pre: torch.Tensor,
               has_in: torch.Tensor | None, n0: int) -> None:
    """The unsharded walk's net half in one launch of the
    ``segment_mean`` kernel (its update mode, counted under
    :func:`segment_mean`): for each slot s, ``h[n0 + s] = relu(pre[s] +
    mean[s])`` where ``has_in[s]`` (every slot when ``has_in`` is None:
    ``dgl_parity`` off), else ``relu(h[n0 + s])``; ``mean`` is
    :func:`segment_mean` with ``cnt``. Writes h in place. On the card the
    rows have the bits of :func:`net_update_plain`'s ops run there. h
    (R, D) float32 contiguous, whose rows ``[n0, n0 + S)`` no edge
    reads; src (E,) and off (S+1,) int32; cnt (S,) float32; pre (S, D)
    float32 contiguous; has_in (S, 1) bool (the graph's ``net_has_in``)
    or None."""
    _check_rows("h", h)
    _check_rows("pre", pre)
    _check_csr(src, off)
    s, d = off.shape[0] - 1, h.shape[1]
    if (cnt.dtype != torch.float32 or not cnt.is_contiguous()
            or cnt.shape != (s,)):
        raise ValueError(f"cnt must be a contiguous float32 ({s},) tensor, "
                         f"got {cnt.dtype} {tuple(cnt.shape)}")
    if pre.shape != (s, d):
        raise ValueError(f"pre {tuple(pre.shape)} must be ({s}, {d})")
    if not 0 <= n0 <= h.shape[0] - s:
        raise ValueError(f"rows [{n0}, {n0 + s}) must lie in h's "
                         f"{h.shape[0]} rows")
    tensors = [h, src, off, cnt, pre]
    if has_in is not None:
        if (has_in.dtype != torch.bool or not has_in.is_contiguous()
                or has_in.shape != (s, 1)):
            raise ValueError(f"has_in must be a contiguous bool ({s}, 1) "
                             f"tensor, got {has_in.dtype} "
                             f"{tuple(has_in.shape)}")
        tensors.append(has_in)
    if device_of("net_update", *tensors).type == "cpu":
        net_update_plain(h, src, off, cnt, pre, has_in, n0)
        return
    if s == 0:
        return
    with torch.cuda.device(h.device):
        _build.launch("segment_mean", _UPDATE_ARGTYPES, h.data_ptr(),
                      src.data_ptr(), off.data_ptr(), cnt.data_ptr(),
                      pre.data_ptr(),
                      0 if has_in is None else has_in.data_ptr(), n0, s, d,
                      _stream(h), entry="net_update")
    segment_mean.launches += 1


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


def _attn_parts_plain(h, src, off, w):
    """``(numer, shift, den, x, seg, scores)`` of each slot by the JAX
    expressions on ``x = h[src]`` and its scores ``x @ w.T``: the
    numerator (S, D), each head's shift (its max, 0 where not finite) and
    denominator (S, nh)."""
    s, d = off.shape[0] - 1, h.shape[1]
    nh = w.shape[0]
    seg = _segment_ids(off)
    x = h[src.long()]
    e = x.shape[0]
    scores = x @ w.t()
    shift, ex = softmax_parts(scores, seg, s)
    weighted = (ex[:, :, None] * x.view(e, nh, d // nh)).view(e, d)
    return (segment_sum(weighted, seg, s), shift, segment_sum(ex, seg, s),
            x, seg, scores)


def divide_heads(numer, den):
    """``numer`` (S, D) over each head's ``max(den, 1e-12)`` (S, nh): the
    output of :func:`segment_attn_sum` from its ``partial`` numerator and
    denominator, as the combine over ranks divides them."""
    (s, nh), d = den.shape, numer.shape[1]
    return (numer.view(s, nh, d // nh)
            / den.clamp_min(1e-12)[:, :, None]).view(s, d)


def segment_attn_sum_plain(h, src, off, w, partial=False):
    """:func:`segment_attn_sum` by the JAX expressions on ``h[src]``."""
    numer, shift, den = _attn_parts_plain(h, src, off, w)[:3]
    if partial:
        return numer, shift, den
    return divide_heads(numer, den), None, None


def segment_attn_sum(h: torch.Tensor, src: torch.Tensor, off: torch.Tensor,
                     w: torch.Tensor, partial: bool = False):
    """The ``--attn`` cell half under the segment reduce, read straight
    from the node state: for each destination slot s (edges ``[off[s],
    off[s+1])`` of the destination-sorted ``src``) and head g, the
    softmax over its edges of the scores ``h[src[e]] @ w[g]`` (each over
    the whole row) weighting head g's ``D / nh`` channels of
    ``h[src[e]]`` (``segment_weighted_softmax_sum``). Returns ``(out, mx,
    den)``: the result (S, D), and ``mx = den = None``. With ``partial``
    (a rank of the edge-sharded step): the numerator, undivided, and
    each head's shift (the max score, 0 where not finite: 0 for an empty
    slot) and denominator (0 for an empty slot), each (S, nh). h (R, D)
    float32 contiguous, src (E,) and off (S+1,) int32, w (nh, D) float32,
    ``fc_attn2``'s weight (nh divides D)."""
    _check_rows("h", h)
    _check_csr(src, off)
    nh = _check_attn_w(w, h.shape[1])
    if device_of("segment_attn_sum", h, src, off, w).type == "cpu":
        return segment_attn_sum_plain(h, src, off, w, partial)
    s, d = off.shape[0] - 1, h.shape[1]
    out = torch.empty((s, d), dtype=h.dtype, device=h.device)
    mx, den = ((torch.empty((s, nh), dtype=h.dtype, device=h.device),
                torch.empty((s, nh), dtype=h.dtype, device=h.device))
               if partial else (None, None))
    if s == 0:
        return out, mx, den
    with torch.cuda.device(h.device):
        _build.launch("segment_attn_sum", _ATTN_ARGTYPES, h.data_ptr(),
                      src.data_ptr(), off.data_ptr(), w.data_ptr(),
                      out.data_ptr(), mx.data_ptr() if partial else 0,
                      den.data_ptr() if partial else 0, s, d, nh,
                      int(partial), _stream(h))
    segment_attn_sum.launches += 1
    return out, mx, den


segment_attn_sum.launches = 0


def segment_attn_bwd_plain(h, src, off, w, g, stats=None):
    """``(d_msg, d_w)`` of :func:`segment_attn_bwd` by PyTorch ops: with
    ``alpha[e, g] = exp(s[e, g] - mx[s, g]) / max(den[s, g], 1e-12)``,
    ``da[e, g] = <g[s], x_e>`` and ``t[s, g] = <g[s], out[s]>`` over head
    g's channels, ``ds = alpha (da - t)``; ``d_msg[e] = alpha[e, g(c)]
    g[s, c] + (ds @ w)[e]`` and ``d_w = ds.T @ x``. ``(out, mx, den)`` is
    ``stats``, or recomputed as :func:`segment_attn_sum_plain` computes
    them."""
    numer, mx, den, x, seg, scores = _attn_parts_plain(h, src, off, w)
    out = divide_heads(numer, den)
    if stats is not None:
        out, mx, den = stats
    e, d = x.shape
    nh = w.shape[0]
    alpha = torch.exp(scores - mx[seg]) / den.clamp_min(1e-12)[seg]
    gs = g[seg]
    dh = d // nh
    da = (gs * x).view(e, nh, dh).sum(-1)
    t = (g * out).reshape(g.shape[0], nh, dh).sum(-1)[seg]
    ds = alpha * (da - t)
    d_msg = (alpha[:, :, None] * gs.view(e, nh, dh)).view(e, d) + ds @ w
    return d_msg, ds.t() @ x


class AttnGradSum:
    """``fc_attn2``'s gradient summed over the :func:`segment_attn_bwd`
    calls of one backward, in a fixed order, without float atomics: the
    same bits on every run. Each call adds its share; :meth:`finish`
    returns the sum after the last call.

    For CPU tensors it is the plain sum: each call's ``ds.T @ x`` added
    in call order. On the card each call's rows kernel adds its blocks'
    sums into their rows of one workspace, written by the first call that
    reaches a row and added to by the later ones, in call order;
    :meth:`finish` launches one fixed-order reduce of the rows. The
    workspace, allocated at the first call, has a row a block of the rows
    kernel's grid, which the kernel's library gives (the blocks the card
    holds at once). A call's kernel reads and writes its rows after its
    wait, once the kernel before it on the stream has finished: the
    previous call's rows kernel precedes it on the stream. The reduce
    counts as a launch of :func:`segment_attn_bwd`."""

    def __init__(self, w: torch.Tensor):
        self.w = w
        self.total = None  # the plain sum
        self.work = None   # the card's workspace
        self.filled = 0    # its rows that hold sums

    def add_plain(self, d_w: torch.Tensor) -> None:
        self.total = d_w if self.total is None else self.total + d_w

    def workspace(self) -> torch.Tensor:
        if self.work is None:
            nh, d = self.w.shape
            rows = c_int(0)
            with torch.cuda.device(self.w.device):
                _build.launch("segment_attn_bwd", _ATTN_GRID_ARGTYPES, d, nh,
                              addressof(rows), entry="segment_attn_bwd_grid")
            self.work = torch.empty((rows.value, nh, d), dtype=self.w.dtype,
                                    device=self.w.device)
        return self.work

    def finish(self) -> torch.Tensor:
        """The sum of every call's gradient of w (zeros if none)."""
        if self.filled == 0:
            return (torch.zeros_like(self.w) if self.total is None
                    else self.total)
        d_w = torch.empty_like(self.w)
        with torch.cuda.device(d_w.device):
            _build.launch("segment_attn_bwd", _DW_REDUCE_ARGTYPES,
                          self.work.data_ptr(), d_w.data_ptr(), self.filled,
                          d_w.numel(), _stream(d_w),
                          entry="segment_dw_reduce")
        segment_attn_bwd.launches += 1
        return d_w


def segment_attn_bwd(h: torch.Tensor, src: torch.Tensor, off: torch.Tensor,
                     w: torch.Tensor, g: torch.Tensor, stats=None,
                     dw_sum: AttnGradSum | None = None):
    """The cotangents of :func:`segment_attn_sum` for the output
    cotangent ``g`` (S, D): ``(d_msg, d_w)``, the per-edge cotangent of
    ``h[src]`` (E, D; the value path and the score path) and the gradient
    of ``w`` (nh, D). With ``dw_sum`` (an :class:`AttnGradSum` of ``w``,
    one a backward) the call adds its gradient of ``w`` to it and
    ``d_w`` is None; without it ``d_w`` is this call's alone (a sum of one
    call). Without ``stats`` each slot's ``(out, mx, den)`` is recomputed
    from ``h``, as the forward computed it; under the edge-sharded step,
    where a rank holds only a block of a slot's edges, ``stats`` is the
    slots' combined ``(out, mx, den)``: (S, D), (S, nh), (S, nh). The two
    give the same bits. h (R, D) float32 contiguous (the final node
    state: every source row of a level is final once it is written), src
    (E,) and off (S+1,) int32, w (nh, D) float32.

    On the card it is one kernel a call (and, without ``dw_sum``, the
    sum's reduce after it), a programmatic dependent launch:
    it reads the tables, ``h``, ``w`` and ``stats`` while the kernel
    before it on the stream may still run, so that kernel must not write
    them, and ``g`` and the sum's workspace once that kernel has
    finished."""
    _check_rows("h", h)
    _check_csr(src, off)
    s, d = off.shape[0] - 1, h.shape[1]
    nh = _check_attn_w(w, d)
    named = [("g", g, d)]
    if stats is not None:
        named += list(zip(("out", "mx", "den"), stats, (d, nh, nh)))
    for what, t, width in named:
        _check_rows(what, t)
        if t.shape != (s, width):
            raise ValueError(f"{what} {tuple(t.shape)} must be ({s}, "
                             f"{width})")
    alone = dw_sum is None
    if alone:
        dw_sum = AttnGradSum(w)
    elif dw_sum.w.shape != w.shape:
        raise ValueError(f"dw_sum sums a gradient of shape "
                         f"{tuple(dw_sum.w.shape)}, not {tuple(w.shape)}")
    if device_of("segment_attn_bwd", h, src, off, w,
                 *(t for _, t, _ in named)).type == "cpu":
        d_msg, d_w = segment_attn_bwd_plain(h, src, off, w, g, stats)
        dw_sum.add_plain(d_w)
    else:
        d_msg = torch.empty((src.shape[0], d), dtype=h.dtype,
                            device=h.device)
        if s > 0:
            work = dw_sum.workspace()
            grid = c_int(0)
            ptrs = [0, 0, 0] if stats is None else [t.data_ptr()
                                                    for t in stats]
            with torch.cuda.device(h.device):
                _build.launch("segment_attn_bwd", _ATTN_BWD_ARGTYPES,
                              h.data_ptr(), src.data_ptr(), off.data_ptr(),
                              w.data_ptr(), *ptrs, g.data_ptr(),
                              d_msg.data_ptr(), work.data_ptr(), s, d, nh,
                              work.shape[0], dw_sum.filled,
                              addressof(grid), _stream(h))
            dw_sum.filled = max(dw_sum.filled, grid.value)
            segment_attn_bwd.launches += 1
    return d_msg, (dw_sum.finish() if alone else None)


segment_attn_bwd.launches = 0
