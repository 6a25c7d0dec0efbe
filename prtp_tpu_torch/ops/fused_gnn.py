"""The exact-levels level walk, forward and backward, and its kernels.

Port of ``prtp_tpu/ops/fused_gnn.py::_forward_impl``. Per level pair the
cell half reduces its mailbox with a masked per-channel softmax and the
net half takes a masked mean; pair 0 drops the neighbour term (PIs have
no in-edges); with ``dgl_parity`` a row whose mailbox is empty keeps
``relu(old)``.

Where the port departs from JAX: JAX gathers ONE merged table per pair,
``gat = h[gather_rows]`` (the cell mailbox, then the net half's
prior-row sources), because the TPU could not fetch a single HBM row
(``csrc/gather_rows.cu``); the net mailbox is then a local gather from
``buf = [new cell rows | prior rows | 0]``. On Hopper a row is fetched
on its own, so the port moves fewer bytes:

- :func:`softmax_sum` reads the cell mailbox straight from ``h`` by
  ``cell_mail``; the mailbox is never built.
- :func:`gather_rows` gathers only the prior rows
  (``gather_rows[k][pn_c * md_c:]``), and only where there are any.
- :func:`local_mean` reads the net mailbox from its two sources, the
  new cell rows and the prior rows; ``buf`` is never built.

This is exact: the packer refuses any source at or after its
destination's level, so every cell-mailbox and prior row lies below
``cell_off[k]`` and the cell half's write cannot change it; the slots
are summed in the same order as before.

The backward is JAX's hand-written ``_bwd`` (:class:`ExactWalk`, a
``torch.autograd.Function``): one ``dh`` carry over the reverse walk,
updated in place; per half the ReLU mask ``hf > 0`` and the
``dgl_parity`` split into ``d_pre`` and ``d_old``; the pair-step MLP
gradients with the hidden recomputed (:func:`_mlp_grads`, plain
products); ``f`` recomputed by :func:`softmax_sum` from the final state
``hf`` by ``cell_mail``, as JAX recomputes ``_softmax_sum(hf[cell_mail])``
(every mailbox row is final once its level is written, so this is
exact, and saving ``f`` per pair would hold P x (pn_c, D) floats for a
call that costs about as much as a copy); :func:`softmax_sum_bwd` for
the cell reduce's cotangent; and :func:`mailbox_scatter` for the two
sorted segment sums (the intra-pair net->cell-block one and the merged
prior-row one, whose rows are unique: no atomics).

With ``--attn`` the cell half reduces its mailbox by
``_attn_sum``'s multi-head attention instead (:func:`attn_sum`, whose
scores use ``fc_attn2``'s weight), and the backward recomputes its
``(f, alpha)`` and takes ``_attn_bwd``'s cotangents (:func:`attn_bwd`),
the weight's gradient summed over the pairs.

``softmax_sum``, ``local_mean``, ``softmax_sum_bwd``, ``attn_sum``,
``attn_bwd`` and ``mailbox_scatter`` are CUDA kernels
(``csrc/<name>.cu``, whose source notes give bound and design) with
plain PyTorch versions beside them,
which compute the JAX expressions. For tensors on the CPU a wrapper runs
the plain version; for CUDA tensors it launches the kernel or raises.
``softmax_sum_bwd``, ``mailbox_scatter``, ``attn_sum`` and ``attn_bwd``
launch as programmatic dependent launches
(``csrc/common.cuh::launch_programmatic``): each reads the graph's
tables, weights and ``hf`` while the kernel before it drains, and the
rest once it is done, so the kernel just before one of them must not
write those. ``softmax_sum`` and ``local_mean`` launch plainly.

Under ``--compute_dtype bfloat16`` only the pair-step MLPs' products
change, as JAX's ``_mm`` has them: bf16 operands, float32 products
(:func:`prtp_tpu_torch.ops.bf16.mm_f32`), in :func:`_mlp` and in all
five products of :func:`_mlp_grads`. The MLPs' weights are cast to bf16
once a forward (``w16``) and kept for the backward. The carry ``h``,
``dh``, the biases, every reduce, scatter and mean stay float32, so the
kernels above take the same float32 inputs either way.

That is the rounding of JAX's fused exact walk (``rounding="fused"``).
JAX evaluates bf16 through its padded scan in most places (its test
CLI always; validation unless ``--exact_levels`` with at most one
validation design), whose ``_PairStep`` runs each pair-step MLP as
flax's ``MLP(dtype=bfloat16)`` (``prtp_tpu/models/gnn.py:85-92``), and
``rounding="scan"`` computes what XLA compiles of it (:func:`_mlp`):
each Dense's product rounded to bf16, the hidden layer's bias sum
rounded and its ReLU in bf16, and the output layer's bias sum in
float32. flax rounds that sum to bf16 too, but its only reader is the
half's float32 sum (``h_self + gate * fc_cell_neigh(neigh)`` with a
float32 ``gate``, ``fc_net_self(net_feat) + neigh_n`` with a float32
``neigh_n``), and XLA drops a rounding to bf16 whose value is converted
straight back to float32 (excess precision, its default): JAX's padded
scan and its ``_PairStep`` under ``jax.jit`` keep that sum float32,
while ``_PairStep`` run op by op rounds it
(``tests/test_torch_bf16_eval.py``). :class:`ExactWalk`'s backward
transposes it as XLA compiles ``jax.grad`` of the scan
(:func:`_mlp_grads`). In float32 the two roundings are one function.
"""

from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p

import torch
import torch.nn.functional as F

from . import _build
from .bf16 import BF16, column_sums_bf16, dense_bf16, mm_f32
from .gather import device_of, gather_rows

_SOFTMAX_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_int64, c_int, c_int,
                     c_int, c_void_p]
_MEAN_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_int64, c_int,
                  c_int, c_int, c_int, c_void_p]
_SOFTMAX_BWD_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,
                         c_int64, c_int, c_int, c_int, c_void_p]
_ATTN_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_int64,
                  c_int, c_int, c_int, c_int, c_void_p]
_ATTN_BWD_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,
                      c_void_p, c_void_p, c_void_p, c_int64, c_int, c_int,
                      c_int, c_int, c_int, c_void_p]
# attn_bwd's rows kernel: at most eight blocks of four warps a streaming
# multiprocessor of an H100 (132), each summing its rows' share of d_w
_ATTN_BWD_BLOCKS = 1056
_SCATTER_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,
                     c_void_p, c_void_p, c_int64, c_int, c_int64, c_int,
                     c_void_p]
# the pair-step MLPs, each given to the walk as (fc0.weight, fc0.bias,
# fc1.weight, fc1.bias) with torch's (out, in) weights
MLP_NAMES = ("fc_cell_self", "fc_cell_neigh", "fc_net_self")


def _check_rows(what: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 2-D float32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _check_index(idx: torch.Tensor, what: str = "idx", dim: int = 2) -> None:
    if idx.dim() != dim or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dim}-D int32 tensor, "
                         f"got {idx.dtype} {tuple(idx.shape)}")


def _check_dummy(h: torch.Tensor, num_rows: int) -> None:
    if not 0 <= num_rows < h.shape[0]:
        raise ValueError(f"num_rows {num_rows} must index h's dummy row "
                         f"(h has {h.shape[0]} rows)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------ softmax_sum

def _softmax_weights(h, idx, num_rows):
    """``m = h[idx]``, the slot mask and the masked per-channel softmax
    weights ``w`` over the slots, as JAX's ``_softmax_sum`` computes
    them."""
    m = h[idx.long()]
    v = (idx != num_rows)[..., None]
    mx = torch.where(v, m, torch.full_like(m, -torch.inf)).amax(
        dim=1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.where(v, torch.exp(m - mx), torch.zeros_like(m))
    return m, v, ex / ex.sum(dim=1, keepdim=True).clamp_min(1e-12)


def softmax_sum_plain(h: torch.Tensor, idx: torch.Tensor,
                      num_rows: int) -> torch.Tensor:
    """``_softmax_sum(h[idx], idx != num_rows)``: masked elementwise
    mailbox softmax-weighted sum over the slots, h (R, D), idx (P, K)
    -> (P, D)."""
    m, _v, w = _softmax_weights(h, idx, num_rows)
    return (w * m).sum(dim=1)


def softmax_sum(h: torch.Tensor, idx: torch.Tensor,
                num_rows: int) -> torch.Tensor:
    """Cell-half mailbox reduce read straight from the node state: h
    (R, D) float32 contiguous with R > num_rows, idx (P, K) int32 (the
    cell mailbox); a slot is valid when its index is not ``num_rows``
    and an invalid slot is never read. An all-invalid row gives 0."""
    _check_rows("h", h)
    _check_index(idx)
    _check_dummy(h, num_rows)
    if device_of("softmax_sum", h, idx).type == "cpu":
        return softmax_sum_plain(h, idx, num_rows)
    p, k = idx.shape
    d = h.shape[1]
    out = torch.empty((p, d), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        _build.launch("softmax_sum", _SOFTMAX_ARGTYPES, h.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), p, k, d, num_rows,
                      _stream(h))
    softmax_sum.launches += 1
    return out


softmax_sum.launches = 0


# ------------------------------------------------------------- local_mean

def local_mean_plain(new: torch.Tensor, prior: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """``_mean_sum(cat([new, prior, 0])[idx], idx < num_valid)`` with
    ``num_valid = len(new) + len(prior)``: masked mean of the local
    mailbox, idx (P, K) -> (P, D)."""
    buf = torch.cat([new, prior, new.new_zeros((1, new.shape[1]))])
    m = buf[idx.long()]
    v = (idx < buf.shape[0] - 1)[..., None]
    s = torch.where(v, m, torch.zeros_like(m)).sum(dim=1)
    cnt = v.sum(dim=1).to(m.dtype).clamp_min(1.0)
    return s / cnt


def local_mean(new: torch.Tensor, prior: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Net-half mailbox mean from two sources: slot ``i < len(new)``
    reads ``new[i]``, ``len(new) <= i < num_valid`` reads
    ``prior[i - len(new)]`` and ``i == num_valid = len(new) +
    len(prior)`` is invalid, never read. new (pn_c, D) and prior
    (n_prior, D, possibly 0 rows) float32 contiguous, idx (P, K) int32.
    An all-invalid row gives 0."""
    _check_rows("new", new)
    _check_rows("prior", prior)
    _check_index(idx)
    if prior.shape[1] != new.shape[1]:
        raise ValueError(f"new and prior differ in width: {new.shape[1]} "
                         f"and {prior.shape[1]}")
    if device_of("local_mean", new, prior, idx).type == "cpu":
        return local_mean_plain(new, prior, idx)
    p, k = idx.shape
    d = new.shape[1]
    out = torch.empty((p, d), dtype=new.dtype, device=new.device)
    with torch.cuda.device(new.device):
        _build.launch("local_mean", _MEAN_ARGTYPES, new.data_ptr(),
                      prior.data_ptr(), idx.data_ptr(), out.data_ptr(), p, k,
                      d, new.shape[0], prior.shape[0], _stream(new))
    local_mean.launches += 1
    return out


local_mean.launches = 0


# -------------------------------------------------------- softmax_sum_bwd

def softmax_sum_bwd_plain(h: torch.Tensor, idx: torch.Tensor, num_rows: int,
                          f: torch.Tensor, d_f: torch.Tensor) -> torch.Tensor:
    """JAX's ``d_f[:, None] * w * (1 + m - f[:, None])`` with ``m =
    h[idx]`` and ``w`` the masked softmax weights of
    ``_softmax_sum(m, valid)``; 0 at invalid slots. -> (P*K, D)."""
    m, v, w = _softmax_weights(h, idx, num_rows)
    out = d_f[:, None, :] * w * (1.0 + m - f[:, None, :])
    return torch.where(v, out, torch.zeros_like(out)).reshape(-1, h.shape[1])


def softmax_sum_bwd(h: torch.Tensor, idx: torch.Tensor, num_rows: int,
                    f: torch.Tensor, d_f: torch.Tensor) -> torch.Tensor:
    """Cotangent of the cell mailbox: for each row p and slot j of idx
    (P, K) int32, row ``p*K + j`` of the (P*K, D) result is
    ``d_f[p] * w_j * (1 + h[idx[p, j]] - f[p])`` for a valid slot. The
    row of an invalid slot (``idx == num_rows``) is undefined: the kernel
    does not write it (the plain version holds 0 there); the merged
    scatter reads valid slots only. h (R, D), f =
    ``softmax_sum(h, idx, num_rows)`` and d_f (P, D): contiguous
    float32.

    On the card the kernel is a programmatic dependent launch: it reads
    ``h`` and ``idx`` while the kernel before it on the stream may still
    run, and ``f`` and ``d_f`` only after that kernel has finished. So
    ``h`` and ``idx`` must be final before the previous kernel on the
    stream starts: that kernel must not write them."""
    _check_rows("h", h)
    _check_rows("f", f)
    _check_rows("d_f", d_f)
    _check_index(idx)
    _check_dummy(h, num_rows)
    p, k = idx.shape
    d = h.shape[1]
    if f.shape != (p, d) or d_f.shape != (p, d):
        raise ValueError(f"f {tuple(f.shape)} and d_f {tuple(d_f.shape)} "
                         f"must be ({p}, {d})")
    if device_of("softmax_sum_bwd", h, idx, f, d_f).type == "cpu":
        return softmax_sum_bwd_plain(h, idx, num_rows, f, d_f)
    out = torch.empty((p * k, d), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        _build.launch("softmax_sum_bwd", _SOFTMAX_BWD_ARGTYPES, h.data_ptr(),
                      idx.data_ptr(), f.data_ptr(), d_f.data_ptr(),
                      out.data_ptr(), p, k, d, num_rows, _stream(h))
    softmax_sum_bwd.launches += 1
    return out


softmax_sum_bwd.launches = 0


# ------------------------------------------------------ attn_sum, attn_bwd

def _check_attn_w(w: torch.Tensor, d: int) -> int:
    """The head count of the score projection ``w`` (nh, D)."""
    _check_rows("w", w)
    nh = w.shape[0]
    if w.shape[1] != d or nh < 1 or d % nh:
        raise ValueError(f"w {tuple(w.shape)} must be (nh, {d}) with nh "
                         f"dividing {d}")
    return nh


def attn_sum_plain(h: torch.Tensor, idx: torch.Tensor, num_rows: int,
                   w: torch.Tensor, with_alpha: bool = False):
    """``_attn_sum(h[idx], idx != num_rows, w.T, nh)``: per head the
    masked softmax over the slots of the scores ``m @ w.T``, each over
    the whole row; head ``c // Dh`` of channel c sums its own
    ``Dh = D / nh`` value slice with its weights. h (R, D), idx (P, K),
    w (nh, D) -> out (P, D), and alpha (P, K, nh) if ``with_alpha``."""
    m = h[idx.long()]
    v = (idx != num_rows)[..., None]
    scores = torch.where(v, torch.einsum("pkd,hd->pkh", m, w),
                         torch.full((), -torch.inf, dtype=h.dtype,
                                    device=h.device))
    mx = scores.amax(dim=1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.where(v, torch.exp(scores - mx), torch.zeros_like(scores))
    alpha = ex / ex.sum(dim=1, keepdim=True).clamp_min(1e-12)
    p, k, d = m.shape
    nh = w.shape[0]
    out = (alpha[..., None] * m.reshape(p, k, nh, d // nh)).sum(dim=1)
    out = out.reshape(p, d)
    return (out, alpha) if with_alpha else out


def attn_sum(h: torch.Tensor, idx: torch.Tensor, num_rows: int,
             w: torch.Tensor, with_alpha: bool = False):
    """The ``--attn`` cell-half mailbox reduce read straight from the node
    state: h (R, D) float32 contiguous with R > num_rows, idx (P, K)
    int32 (the cell mailbox), w (nh, D) float32, ``fc_attn2``'s weight
    (nh divides D). A slot is valid when its index is not ``num_rows``;
    an invalid slot is never read. An all-invalid row gives 0. Returns
    out (P, D) and, if ``with_alpha``, the weights alpha (P, K, nh), 0
    at invalid slots.

    On the card the kernel is a programmatic dependent launch: it reads
    ``idx`` and ``w`` while the kernel before it on the stream may still
    run, so that kernel must not write them, and ``h`` once that kernel
    has finished."""
    _check_rows("h", h)
    _check_index(idx)
    _check_dummy(h, num_rows)
    nh = _check_attn_w(w, h.shape[1])
    if device_of("attn_sum", h, idx, w).type == "cpu":
        return attn_sum_plain(h, idx, num_rows, w, with_alpha)
    p, k = idx.shape
    d = h.shape[1]
    out = torch.empty((p, d), dtype=h.dtype, device=h.device)
    alpha = (torch.empty((p, k, nh), dtype=h.dtype, device=h.device)
             if with_alpha else None)
    with torch.cuda.device(h.device):
        _build.launch("attn_sum", _ATTN_ARGTYPES, h.data_ptr(),
                      idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                      0 if alpha is None else alpha.data_ptr(), p, k, d, nh,
                      num_rows, _stream(h))
    attn_sum.launches += 1
    return (out, alpha) if with_alpha else out


attn_sum.launches = 0


def attn_bwd_plain(h: torch.Tensor, idx: torch.Tensor, num_rows: int,
                   w: torch.Tensor, alpha: torch.Tensor, d_f: torch.Tensor):
    """JAX's ``_attn_bwd(h[idx], valid, w.T, nh, d_f, alpha)`` in torch's
    layout: the cotangent of the mailbox (P*K, D), 0 at invalid slots,
    and of ``w`` (nh, D)."""
    m = h[idx.long()]
    v = (idx != num_rows)[..., None]
    p, k, d = m.shape
    nh = w.shape[0]
    d_oh = d_f.reshape(p, nh, d // nh)
    d_alpha = torch.einsum("pkhc,phc->pkh", m.reshape(p, k, nh, d // nh),
                           d_oh)
    d_m = (alpha[..., None] * d_oh[:, None]).reshape(p, k, d)
    d_scores = alpha * (d_alpha - (alpha * d_alpha).sum(dim=1, keepdim=True))
    d_scores = torch.where(v, d_scores, torch.zeros_like(d_scores))
    d_w = torch.einsum("pkd,pkh->hd", m, d_scores)
    d_m = d_m + torch.einsum("pkh,hd->pkd", d_scores, w)
    d_m = torch.where(v, d_m, torch.zeros_like(d_m))
    return d_m.reshape(-1, d), d_w


def attn_bwd(h: torch.Tensor, idx: torch.Tensor, num_rows: int,
             w: torch.Tensor, alpha: torch.Tensor, d_f: torch.Tensor):
    """Cotangents of :func:`attn_sum` for the output cotangent d_f (P, D),
    given its ``alpha`` (P, K, nh): ``(d_mail, d_w)``. Row ``p*K + j`` of
    d_mail (P*K, D) is slot j of row p's cotangent; the row of an invalid
    slot (``idx == num_rows``) is undefined: the kernel does not write it
    (the plain version holds 0 there), and the merged scatter reads valid
    slots only. d_w (nh, D) is the gradient of ``fc_attn2``'s weight,
    summed over every valid slot in a fixed order (per-block partial sums,
    then a fixed-order reduce: no float atomics), so a call gives the same
    bits every time. h (R, D), w (nh, D), alpha, d_f: contiguous float32;
    idx (P, K) int32; on the card 4 rows of D floats (5 of nh x D where
    the heads are reduced together) must fit in a block's 227 KB of
    shared memory.

    On the card it is two kernels, both programmatic dependent launches:
    the first reads ``h``, ``idx`` and ``alpha`` while the kernel before
    it on the stream may still run, so that kernel must not write them,
    and ``d_f`` and ``w`` once that kernel has finished; the second adds
    the first's partial sums once it has finished."""
    _check_rows("h", h)
    _check_rows("d_f", d_f)
    _check_index(idx)
    _check_dummy(h, num_rows)
    p, k = idx.shape
    d = h.shape[1]
    nh = _check_attn_w(w, d)
    if (alpha.dtype != torch.float32 or not alpha.is_contiguous()
            or alpha.shape != (p, k, nh) or d_f.shape != (p, d)):
        raise ValueError(f"alpha {tuple(alpha.shape)} and d_f "
                         f"{tuple(d_f.shape)} must be contiguous float32 "
                         f"({p}, {k}, {nh}) and ({p}, {d})")
    if device_of("attn_bwd", h, idx, w, alpha, d_f).type == "cpu":
        return attn_bwd_plain(h, idx, num_rows, w, alpha, d_f)
    out = torch.empty((p * k, d), dtype=h.dtype, device=h.device)
    d_w = torch.empty((nh, d), dtype=h.dtype, device=h.device)
    blocks = min(p, _ATTN_BWD_BLOCKS)
    # workspace: each block's partial sums of d_w
    work = torch.empty(blocks * nh * d, dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        _build.launch("attn_bwd", _ATTN_BWD_ARGTYPES, h.data_ptr(),
                      idx.data_ptr(), w.data_ptr(), alpha.data_ptr(),
                      d_f.data_ptr(), out.data_ptr(), d_w.data_ptr(),
                      work.data_ptr(), p, k, d, nh, num_rows, blocks,
                      _stream(h))
    attn_bwd.launches += 1
    return out, d_w


attn_bwd.launches = 0


# -------------------------------------------------------- mailbox_scatter

def mailbox_scatter_plain(dest, rows, seg_off, pos, d_mail_c, d_pre_n, cnt_n,
                          md_n: int, n_cell: int) -> None:
    """JAX's ``dest.at[rows].add(segment_sum(cat[pos], seg))`` in place,
    where ``cat = [d_mail_c | d_mail_n]``: ``n_cell`` cell-mailbox rows
    (zeros if ``d_mail_c`` is None) then the net mailbox cotangent,
    ``d_mail_n[r*md_n + j] = d_pre_n[r] / cnt_n[r]``, and ``seg`` the
    segment ids of the CSR offsets ``seg_off``."""
    d = dest.shape[1]
    cell = (d_mail_c if d_mail_c is not None
            else dest.new_zeros((n_cell, d)))
    d_mail_n = (d_pre_n / cnt_n[:, None]).repeat_interleave(md_n, dim=0)
    contrib = torch.cat([cell, d_mail_n])[pos.long()]
    seg = torch.repeat_interleave(
        torch.arange(rows.shape[0], device=dest.device),
        (seg_off[1:] - seg_off[:-1]).long())
    uniq = dest.new_zeros((rows.shape[0], d)).index_add_(0, seg, contrib)
    dest.index_add_(0, rows.long(), uniq)


def mailbox_scatter(dest: torch.Tensor, rows: torch.Tensor,
                    seg_off: torch.Tensor, pos: torch.Tensor,
                    d_mail_c: torch.Tensor | None, d_pre_n: torch.Tensor,
                    cnt_n: torch.Tensor, md_n: int, n_cell: int) -> None:
    """Sorted unique-row segment sum added into ``dest`` in place.

    For each segment s, ``dest[rows[s]] += sum of contrib(pos[e])`` over
    ``e`` in ``[seg_off[s], seg_off[s+1])``, in that order. A position
    ``q < n_cell`` reads row q of ``d_mail_c`` ((n_cell, D), or None for
    zeros); a position ``q >= n_cell`` reads the net mailbox cotangent,
    never built: ``r = (q - n_cell) // md_n`` gives ``d_pre_n[r] /
    cnt_n[r]``. ``rows`` must be unique (no two segments add into one
    row). dest (R, D), d_pre_n (pn_n, D) float32 contiguous; cnt_n
    (pn_n,) float32, the graph's ``net_cnt``; rows (U,), seg_off (U+1,),
    pos int32. An empty table launches nothing.

    On the card the kernel is a programmatic dependent launch: it may
    read ``rows``, ``seg_off``, ``pos`` and ``cnt_n`` while the kernel
    before it on the stream still runs, and ``dest``, ``d_pre_n`` and
    ``d_mail_c`` only after that kernel has finished. So the first four
    must be final before the previous kernel on the stream starts: that
    kernel must not write them (the graph's tables never change)."""
    _check_rows("dest", dest)
    _check_rows("d_pre_n", d_pre_n)
    for what, t in (("rows", rows), ("seg_off", seg_off), ("pos", pos)):
        _check_index(t, what, dim=1)
    if d_mail_c is not None:
        _check_rows("d_mail_c", d_mail_c)
        if d_mail_c.shape != (n_cell, dest.shape[1]):
            raise ValueError(f"d_mail_c {tuple(d_mail_c.shape)} must be "
                             f"({n_cell}, {dest.shape[1]})")
    if (cnt_n.dtype != torch.float32 or not cnt_n.is_contiguous()
            or cnt_n.shape != d_pre_n.shape[:1]):
        raise ValueError(f"cnt_n must be a contiguous float32 "
                         f"({d_pre_n.shape[0]},) tensor, got {cnt_n.dtype} "
                         f"{tuple(cnt_n.shape)}")
    if d_pre_n.shape[1] != dest.shape[1] or seg_off.shape[0] != rows.shape[0] + 1:
        raise ValueError("mailbox_scatter: d_pre_n's width or seg_off's "
                         "length does not fit dest and rows")
    if md_n < 1 or n_cell < 0:
        raise ValueError(f"md_n {md_n} must be >= 1 and n_cell {n_cell} >= 0")
    tensors = [dest, rows, seg_off, pos, d_pre_n, cnt_n]
    if d_mail_c is not None:
        tensors.append(d_mail_c)
    if device_of("mailbox_scatter", *tensors).type == "cpu":
        mailbox_scatter_plain(dest, rows, seg_off, pos, d_mail_c, d_pre_n,
                              cnt_n, md_n, n_cell)
        return
    if rows.shape[0] == 0:
        return
    with torch.cuda.device(dest.device):
        _build.launch("mailbox_scatter", _SCATTER_ARGTYPES, dest.data_ptr(),
                      rows.data_ptr(), seg_off.data_ptr(), pos.data_ptr(),
                      0 if d_mail_c is None else d_mail_c.data_ptr(),
                      d_pre_n.data_ptr(), cnt_n.data_ptr(), rows.shape[0],
                      dest.shape[1], n_cell, md_n, _stream(dest))
    mailbox_scatter.launches += 1


mailbox_scatter.launches = 0


# ---------------------------------------------------------------- the walk

ROUNDINGS = ("fused", "scan")


def check_rounding(rounding: str) -> str:
    """``rounding`` if it names one of ``ROUNDINGS``, else ValueError."""
    if rounding not in ROUNDINGS:
        raise ValueError(f"rounding {rounding!r}: one of {ROUNDINGS}")
    return rounding


def _mlp(p, x: torch.Tensor, w16=None, scan: bool = False) -> torch.Tensor:
    """The pair-step MLP, Linear -> ReLU -> Linear, from ``p = (w0, b0,
    w1, b1)``; with ``w16 = (w0, w1)`` in bf16, JAX's ``_mlp`` with bf16
    ``_mm`` products (float32 results, float32 biases), or with ``scan``
    flax's ``MLP(dtype=bfloat16)`` as the padded scan compiles it: the
    hidden layer :func:`dense_bf16` and its ReLU in bf16, then the
    product rounded to bf16 and the bf16 bias added in float32 (a
    float32 result, which rounded to bf16 is flax's)."""
    if w16 is None:
        return F.linear(F.relu(F.linear(x, p[0], p[1])), p[2], p[3])
    if scan:
        r = F.relu(dense_bf16(x, w16[0], p[1]))
        return mm_f32(r, w16[1].t()).to(BF16).float() + p[3].to(BF16).float()
    a = mm_f32(x.to(BF16), w16[0].t()) + p[1]
    return mm_f32(F.relu(a).to(BF16), w16[1].t()) + p[3]


def _mlp_grads(p, x, d_out, need_dx=True, w16=None, scan=False,
               round_dx=False):
    """Port of ``prtp_tpu/ops/fused_gnn.py::_mlp_grads``: the gradients
    of ``(w0, b0, w1, b1)`` and the input cotangent (None unless
    ``need_dx``) of :func:`_mlp` at ``x`` for the output cotangent
    ``d_out``, the hidden recomputed. JAX's ``kernel`` is ``weight.T``.
    With ``w16`` each of the five products is :func:`mm_f32` of bf16
    operands, as JAX's ``_mm``; the masks and the bias sums stay
    float32.

    With ``scan`` (and ``w16``) it transposes ``_mlp(scan=True)`` as XLA
    compiles ``jax.grad`` of flax's ``MLP(dtype=bfloat16)`` on the CPU
    (read from the compiled HLO, held by
    ``tests/test_torch_bf16_scan_grad.py``): the output cotangent
    rounded to bf16 (the transpose of the float32 promotion); each
    weight's gradient a float32 product of bf16 operands rounded to
    bf16; the hidden cotangent rounded, masked by ``a >= 0`` (flax's
    ``leaky_relu`` passes a hidden exactly 0); the input cotangent the
    float32 product, not rounded (XLA drops the rounding before its
    convert back to float32). The two bias gradients are bf16 column
    sums whose every partial sum rounds (:func:`column_sums_bf16`), so
    in their place this returns the bf16 cotangents they sum, for the
    caller to sum in one batch. ``round_dx``: the input cotangent
    rounded to bf16 too, as XLA compiles the scan vmapped over a stack of
    designs (``graph.stacked``), where it keeps that rounding."""
    w0, b0, w1, _b1 = p
    if w16 is None:
        a = F.linear(x, w0, b0)
        d_a = (d_out @ w1) * (a > 0)
        grads = (d_a.t() @ x, d_a.sum(0), d_out.t() @ F.relu(a),
                 d_out.sum(0))
        return grads, (d_a @ w0 if need_dx else None)
    x16, d_out16 = x.to(BF16), d_out.to(BF16)
    if scan:
        a = mm_f32(x16, w16[0].t()).to(BF16) + b0.to(BF16)
        d_a16 = torch.where(a >= 0, mm_f32(d_out16, w16[1]).to(BF16),
                            torch.zeros((), dtype=BF16, device=a.device))
        grads = (mm_f32(d_a16.t(), x16).to(BF16).float(), d_a16,
                 mm_f32(d_out16.t(), F.relu(a)).to(BF16).float(), d_out16)
        if not need_dx:
            return grads, None
        dx = mm_f32(d_a16, w16[0])
        return grads, (dx.to(BF16).float() if round_dx else dx)
    a = mm_f32(x16, w16[0].t()) + b0
    d_a = mm_f32(d_out16, w16[1]) * (a > 0)
    d_a16 = d_a.to(BF16)
    grads = (mm_f32(d_a16.t(), x16), d_a.sum(0),
             mm_f32(d_out16.t(), F.relu(a).to(BF16)), d_out.sum(0))
    return grads, (mm_f32(d_a16, w16[0]) if need_dx else None)


def _relu_split(g, h_blk, has, dgl_parity):
    """``(d_pre, d_old)`` of one half: the ReLU mask ``hf > 0`` (right for
    both dgl_parity branches: a kept row is ``relu(old)``), split by
    whether the row has an in-edge (``has`` (n, 1) bool, the graph's
    ``cell_has_in`` or ``net_has_in``)."""
    d = g * (h_blk > 0)
    if not dgl_parity:
        return d, None
    return d * has, d * ~has


def exact_gnn_forward(params, h0: torch.Tensor, graph,
                      dgl_parity: bool = True, w16=None,
                      rounding: str = "fused") -> torch.Tensor:
    """h_final of the exact-levels walk.

    params: maps each name of ``MLP_NAMES`` to that pair-step MLP's
    ``(w0, b0, w1, b1)``, and with ``--attn`` ``"fc_attn2"`` to the score
    projection's weight (nh, D): the cell half then reduces its mailbox
    with :func:`attn_sum` instead of :func:`softmax_sum`. h0: (num_rows+1, D) float32 initial state; it
    is not modified — the walk writes each level's rows in place into a
    copy (JAX's functional ``dynamic_update_slice`` becomes a slice
    assignment). graph: a :class:`prtp_tpu_torch.graph.LeveledGraphExact`
    on h0's device. Differentiable by torch autograd where every tensor
    lies on the CPU (the plain versions); :class:`ExactWalk` is its
    hand-written backward. ``w16`` (:func:`bf16_weights`) makes the MLPs'
    products bf16 (``--compute_dtype bfloat16``); h stays float32. With
    ``w16``, ``rounding="scan"`` runs the MLPs as JAX's padded scan does
    (``_mlp``), each half's sum in float32 as there
    (``prtp_tpu/models/gnn.py:191, 203``).
    """
    scan = check_rounding(rounding) == "scan"
    num_rows = graph.num_rows
    w_attn = params.get("fc_attn2")
    h = h0.clone()
    for k in range(graph.num_pairs):
        cell_mail = graph.cell_mail[k]
        pn_c, md_c = cell_mail.shape
        # ---- cell half (even level 2k): mailbox read straight from h ----
        pre = _mlp(params["fc_cell_self"], graph.cell_feat_lvl[k],
                   _w(w16, "fc_cell_self"), scan).float()
        if k > 0:  # level 0 drops the neighbour term
            neigh = (softmax_sum(h, cell_mail, num_rows) if w_attn is None
                     else attn_sum(h, cell_mail, num_rows, w_attn))
            pre = pre + _mlp(params["fc_cell_neigh"], neigh,
                             _w(w16, "fc_cell_neigh"), scan).float()
        new = F.relu(pre)
        c0 = graph.cell_off[k]
        if dgl_parity:
            new = torch.where(graph.cell_has_in[k], new,
                              F.relu(h[c0: c0 + pn_c]))
        h[c0: c0 + pn_c] = new
        # ---- net half (odd level 2k+1): [new | prior] mailbox ----
        prior_rows = graph.gather_rows[k][pn_c * md_c:]
        prior = gather_rows(h, prior_rows) if prior_rows.numel() else new[:0]
        neigh_n = local_mean(new, prior, graph.net_local_idx[k])
        new_n = F.relu(_mlp(params["fc_net_self"], graph.net_feat_lvl[k],
                            _w(w16, "fc_net_self"), scan).float() + neigh_n)
        net_mail = graph.net_mail[k]
        n0 = graph.net_off[k]
        if dgl_parity:
            new_n = torch.where(graph.net_has_in[k], new_n,
                                F.relu(h[n0: n0 + net_mail.shape[0]]))
        h[n0: n0 + net_mail.shape[0]] = new_n
    return h


def exact_gnn_backward(params, hf: torch.Tensor, g: torch.Tensor, graph,
                       dgl_parity: bool = True, w16=None,
                       rounding: str = "fused", pair_sum=None):
    """Port of ``prtp_tpu/ops/fused_gnn.py::_bwd``: the cotangent of h0
    and the parameter gradients (a dict like ``params``) of the walk
    whose final state is ``hf``, for the cotangent ``g`` of ``hf``. With
    ``"fc_attn2"`` in ``params`` the cell half recomputes ``(f, alpha)``
    by :func:`attn_sum` from ``hf``, as JAX does, and :func:`attn_bwd`
    gives the mailbox's cotangent and the pair's share of the score
    projection's gradient. With ``w16`` and ``rounding="scan"`` the
    MLPs' gradients are those of JAX's padded scan (:func:`_mlp_grads`
    with ``scan``); the reduces' backward stays float32, as the scan's
    mailbox softmax and ``fc_attn2`` run on the float32 carry; the bias
    gradients are summed as :class:`MlpGradSums` says, over the rows of
    the padded or grouped scan's levels (``graph.scan_rows``), and with
    ``pair_sum`` summed over a design-sharded mesh's ranks pair by pair.

    One ``dh`` carry, a copy of ``g``, is updated in place pair by pair
    in reverse. The intra-pair net->cell-block sum goes straight into
    ``dh``'s cell slice (JAX's ``g_c``), which ``d_old_c`` then
    replaces, so no copy is made; the merged rows lie below
    ``cell_off[k]``, so the merged add never touches the two slices just
    written.

    ``softmax_sum_bwd``, ``mailbox_scatter`` and ``attn_bwd`` read their
    index tables and ``hf`` (``attn_bwd`` also ``alpha``, written two
    kernels or more before it), and the recompute's ``attn_sum`` its
    table and ``w``, before waiting on the kernel before them
    (programmatic dependent launch). That holds here because those are
    the graph's tables, packed before the walk, ``hf``, final before the
    backward begins, and the parameters; no kernel of the backward writes
    them."""
    scan = w16 is not None and check_rounding(rounding) == "scan"
    num_rows = graph.num_rows
    dh = g.clone(memory_format=torch.contiguous_format)
    acc = MlpGradSums(params, graph, scan, pair_sum)
    grads = acc.grads
    w_attn = params.get("fc_attn2")
    if w_attn is not None:
        grads["fc_attn2"] = torch.zeros_like(w_attn)

    for k in reversed(range(graph.num_pairs)):
        acc.pair(k)
        cell_mail, net_mail = graph.cell_mail[k], graph.net_mail[k]
        pn_c, md_c = cell_mail.shape
        pn_n, md_n = net_mail.shape
        c0, n0 = graph.cell_off[k], graph.net_off[k]
        # ---- net half ----
        d_pre_n, d_old_n = _relu_split(dh[n0: n0 + pn_n],
                                       hf[n0: n0 + pn_n],
                                       graph.net_has_in[k], dgl_parity)
        acc.add("fc_net_self", _mlp_grads(
            params["fc_net_self"], graph.net_feat_lvl[k], d_pre_n, False,
            _w(w16, "fc_net_self"), scan)[0])
        cnt_n = graph.net_cnt[k]
        # ---- intra-pair net -> cell-block contributions ----
        g_c = dh[c0: c0 + pn_c]
        mailbox_scatter(g_c, graph.intra_rows[k], graph.intra_seg_off[k],
                        graph.intra_pos[k], None, d_pre_n, cnt_n, md_n, 0)
        # ---- cell half ----
        d_pre_c, d_old_c = _relu_split(g_c, hf[c0: c0 + pn_c],
                                       graph.cell_has_in[k], dgl_parity)
        acc.add("fc_cell_self", _mlp_grads(
            params["fc_cell_self"], graph.cell_feat_lvl[k], d_pre_c, False,
            _w(w16, "fc_cell_self"), scan)[0])
        d_mail_c = None
        if k > 0:
            if w_attn is None:
                f = softmax_sum(hf, cell_mail, num_rows)
            else:
                f, alpha = attn_sum(hf, cell_mail, num_rows, w_attn,
                                    with_alpha=True)
            dp_neigh, d_f = _mlp_grads(params["fc_cell_neigh"], f, d_pre_c,
                                       True, _w(w16, "fc_cell_neigh"), scan,
                                       graph.stacked)
            acc.add("fc_cell_neigh", dp_neigh)
            if w_attn is None:
                d_mail_c = softmax_sum_bwd(hf, cell_mail, num_rows, f, d_f)
            else:
                d_mail_c, d_w = attn_bwd(hf, cell_mail, num_rows, w_attn,
                                         alpha, d_f)
                grads["fc_attn2"].add_(d_w)
        # ---- the carry: d_old into both slices, then the merged scatter ----
        if d_old_n is None:
            dh[n0: n0 + pn_n] = 0.0
            dh[c0: c0 + pn_c] = 0.0
        else:
            dh[n0: n0 + pn_n] = d_old_n
            dh[c0: c0 + pn_c] = d_old_c
        mailbox_scatter(dh, graph.merged_rows[k], graph.merged_seg_off[k],
                        graph.merged_pos[k], d_mail_c, d_pre_n, cnt_n, md_n,
                        pn_c * md_c)
    acc.finish()
    return dh, grads


class MlpGradSums:
    """The pair-step MLPs' gradients over a walk's backward (``grads``: a
    dict like ``params`` of float32 tensors), added pair by pair as the
    walk reverses. Both walks' backwards use it.

    In the scan's bf16 rounding (``scan``) each pair's two bias gradients
    are bf16 sums whose every partial sum rounds: :meth:`add` keeps the
    bf16 cotangents they sum, and :meth:`finish` sums them all in one
    :func:`column_sums_bf16` call and adds them pair by pair in the order
    the pairs came, as the scan's backward accumulates them. Each sums as
    many rows as its level has in JAX's padded or grouped scan
    (``graph.scan_rows[k]``), since the zero rows of the padding move
    XLA's summation windows.

    With ``pair_sum`` (a design-sharded rank's, ``parallel/multi.py``:
    sums a flat float32 tensor over the ranks in place) each pair's
    gradients, this rank's bf16 sums
    over its designs' rows, are summed over the ranks and rounded to bf16
    again before they are added, as XLA's partitioner sums the vmapped
    scan's bf16 gradients inside the scan: :meth:`finish` sums every
    pair's in one call of ``pair_sum`` on a flat float32 tensor. JAX's
    scan runs the bucket's ``pair_sum.pairs`` pairs on every rank, so a
    rank whose designs have fewer adds zeros for the pairs it lacks (the
    last, which its backward meets first), laid out as every pair's: the
    MLPs in :attr:`PAIR_ORDER`, each its weights, then its biases."""

    # the order in which both walks' backwards add a pair's MLPs
    PAIR_ORDER = ("fc_net_self", "fc_cell_self", "fc_cell_neigh")

    def __init__(self, params, graph, scan: bool, pair_sum=None):
        self.grads = {name: [torch.zeros_like(t) for t in params[name]]
                      for name in MLP_NAMES}
        self._scan, self._scan_rows = scan, graph.scan_rows
        self._pair_sum = pair_sum if scan else None
        # per pair, the bias gradients (or, summed over ranks, the
        # weights' and the biases' (target, value) pairs); then the bf16
        # cotangents the bias sums add and the rows that they run over
        self._acc, self._cot, self._rows = [], [], []
        self._k = None

    def pair(self, k: int) -> None:
        """Start pair k: :meth:`add` adds its gradients."""
        self._k = k
        self._acc.append([])

    def add(self, name: str, dp) -> None:
        """Add one MLP's ``dp`` (:func:`_mlp_grads`' first result): one
        multi-tensor launch for the four tensors, or in the scan's
        rounding for the two weights."""
        grads = self.grads[name]
        if not self._scan:
            torch._foreach_add_(grads, list(dp))
            return
        if self._pair_sum is None:
            torch._foreach_add_(grads[0::2], [dp[0], dp[2]])
            self._acc[-1] += grads[1::2]
        else:
            self._acc[-1] += [(grads[0], dp[0]), (grads[2], dp[2]),
                              (grads[1], None), (grads[3], None)]
        self._cot.extend((dp[1], dp[3]))
        self._rows.extend(
            [self._scan_rows[self._k][name == "fc_net_self"]] * 2)

    def finish(self) -> None:
        """Add the bias gradients of the scan's rounding (and, summed over
        ranks, every pair's gradients)."""
        if not self._cot:
            return
        sums = iter(column_sums_bf16(self._cot, self._rows))
        if self._pair_sum is None:
            for targets in self._acc:
                torch._foreach_add_(targets, [next(sums) for _ in targets])
            return
        lacking = [[(t, torch.zeros_like(t)) for name in self.PAIR_ORDER
                    for t in (self.grads[name][i] for i in (0, 2, 1, 3))]
                   for _ in range(self._pair_sum.pairs - len(self._acc))]
        pairs = lacking + [[(t, next(sums) if v is None else v)
                            for t, v in acc] for acc in self._acc]
        values = [v for acc in pairs for _t, v in acc]
        flat = torch.cat([v.reshape(-1) for v in values])
        self._pair_sum(flat)
        flat = flat.to(BF16).float()
        for acc in pairs:
            parts = []
            for t, _v in acc:
                parts.append(flat[:t.numel()].view_as(t))
                flat = flat[t.numel():]
            torch._foreach_add_([t for t, _v in acc], parts)


def _w(w16, name):
    return None if w16 is None else w16[name]


def bf16_weights(params):
    """Each pair-step MLP's two weights cast to bf16 once, for a forward
    and its backward: ``{name: (w0, w1)}``."""
    return {name: (params[name][0].to(BF16), params[name][2].to(BF16))
            for name in MLP_NAMES}


def _params_of(flat):
    """The walk's ``params`` from the flat tensors: the three MLPs'
    twelve, then ``fc_attn2``'s weight with ``--attn``."""
    params = {name: tuple(flat[4 * i: 4 * i + 4])
              for i, name in enumerate(MLP_NAMES)}
    if len(flat) > 4 * len(MLP_NAMES):
        params["fc_attn2"] = flat[4 * len(MLP_NAMES)]
    return params


def _flat_of(params):
    """The inverse of :func:`_params_of`."""
    flat = [t for name in MLP_NAMES for t in params[name]]
    if "fc_attn2" in params:
        flat.append(params["fc_attn2"])
    return flat


def save_walk(ctx, hf, flat, w16) -> None:
    """Save a walk's final state, its flat parameters and its bf16
    weights (``w16``, or None) for its backward."""
    ctx.bf16 = w16 is not None
    low = [t for name in MLP_NAMES for t in w16[name]] if ctx.bf16 else []
    ctx.save_for_backward(hf, *flat, *low)


def restore_walk(ctx):
    """``(hf, flat, w16)`` as :func:`save_walk` saved them."""
    hf, *flat = ctx.saved_tensors
    if not ctx.bf16:
        return hf, flat, None
    n = 2 * len(MLP_NAMES)
    flat, low = flat[:-n], flat[-n:]
    return hf, flat, {name: tuple(low[2 * i: 2 * i + 2])
                      for i, name in enumerate(MLP_NAMES)}


class ExactWalk(torch.autograd.Function):
    """The walk with JAX's hand-written backward (``fused_exact_gnn``).
    Inputs: the graph, ``dgl_parity``, whether the MLPs' products are
    bf16, the ``rounding`` and ``pair_sum`` (no gradient), h0, then the twelve
    pair-step tensors in ``MLP_NAMES`` order and, with ``--attn``,
    ``fc_attn2``'s weight. The bf16 weights made for the forward are
    saved for the backward. The backward is ``_bwd``'s; in bf16 with
    ``rounding="scan"`` its MLP gradients are those of JAX's padded
    scan (:func:`exact_gnn_backward`)."""

    @staticmethod
    def forward(ctx, graph, dgl_parity, bf16, rounding, pair_sum, h0, *flat):
        params = _params_of(flat)
        w16 = bf16_weights(params) if bf16 else None
        hf = exact_gnn_forward(params, h0, graph, dgl_parity, w16, rounding)
        ctx.graph, ctx.dgl_parity, ctx.rounding = graph, dgl_parity, rounding
        ctx.pair_sum = pair_sum
        save_walk(ctx, hf, flat, w16)
        return hf

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        hf, flat, w16 = restore_walk(ctx)
        dh, grads = exact_gnn_backward(_params_of(flat), hf, g, ctx.graph,
                                       ctx.dgl_parity, w16, ctx.rounding,
                                       ctx.pair_sum)
        dflat = _flat_of(grads)
        need = ctx.needs_input_grad
        return (None, None, None, None, None, dh if need[5] else None,
                *(t if need[6 + i] else None for i, t in enumerate(dflat)))


def exact_walk(params, h0: torch.Tensor, graph, dgl_parity: bool = True,
               bf16: bool = False, rounding: str = "fused",
               pair_sum=None) -> torch.Tensor:
    """:func:`exact_gnn_forward` through :class:`ExactWalk`: the forward
    launches the same kernels, and autograd takes the hand-written
    backward. ``bf16``: the MLPs' products in bf16, rounded as JAX's
    fused walk (``rounding="fused"``: float32 results) or as its padded
    scan (``"scan"``), forward and backward; ``pair_sum``: as for
    :class:`MlpGradSums`."""
    return ExactWalk.apply(graph, dgl_parity, bf16, check_rounding(rounding),
                           pair_sum, h0, *_flat_of(params))
