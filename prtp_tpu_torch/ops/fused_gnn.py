"""The exact-levels level walk (forward) and its mailbox-reduce kernels.

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

``softmax_sum`` and ``local_mean`` are CUDA kernels
(``csrc/softmax_sum.cu``, ``csrc/local_mean.cu``, whose source notes give
bound and design) with plain PyTorch versions beside them, which compute
the JAX expressions. For tensors on the CPU a wrapper runs the plain
version; for CUDA tensors it launches the kernel or raises. The
backward walk (``_bwd``) comes with the training slice.
"""

from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p

import torch
import torch.nn.functional as F

from . import _build
from .gather import device_of, gather_rows

_SOFTMAX_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_int64, c_int, c_int,
                     c_int, c_void_p]
_MEAN_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_void_p, c_int64, c_int,
                  c_int, c_int, c_int, c_void_p]


def _check_rows(what: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 2-D float32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _check_index(idx: torch.Tensor) -> None:
    if idx.dim() != 2 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous (P, K) int32 tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)}")


# ------------------------------------------------------------ softmax_sum

def softmax_sum_plain(h: torch.Tensor, idx: torch.Tensor,
                      num_rows: int) -> torch.Tensor:
    """``_softmax_sum(h[idx], idx != num_rows)``: masked elementwise
    mailbox softmax-weighted sum over the slots, h (R, D), idx (P, K)
    -> (P, D)."""
    m = h[idx.long()]
    v = (idx != num_rows)[..., None]
    mx = torch.where(v, m, torch.full_like(m, -torch.inf)).amax(
        dim=1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.where(v, torch.exp(m - mx), torch.zeros_like(m))
    denom = ex.sum(dim=1, keepdim=True).clamp_min(1e-12)
    return (ex / denom * m).sum(dim=1)


def softmax_sum(h: torch.Tensor, idx: torch.Tensor,
                num_rows: int) -> torch.Tensor:
    """Cell-half mailbox reduce read straight from the node state: h
    (R, D) float32 contiguous with R > num_rows, idx (P, K) int32 (the
    cell mailbox); a slot is valid when its index is not ``num_rows``
    and an invalid slot is never read. An all-invalid row gives 0."""
    _check_rows("h", h)
    _check_index(idx)
    if not 0 <= num_rows < h.shape[0]:
        raise ValueError(f"num_rows {num_rows} must index h's dummy row "
                         f"(h has {h.shape[0]} rows)")
    if device_of("softmax_sum", h, idx).type == "cpu":
        return softmax_sum_plain(h, idx, num_rows)
    p, k = idx.shape
    d = h.shape[1]
    out = torch.empty((p, d), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        _build.launch("softmax_sum", _SOFTMAX_ARGTYPES, h.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), p, k, d, num_rows,
                      torch.cuda.current_stream(h.device).cuda_stream)
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
                      d, new.shape[0], prior.shape[0],
                      torch.cuda.current_stream(new.device).cuda_stream)
    local_mean.launches += 1
    return out


local_mean.launches = 0


# ---------------------------------------------------------------- the walk

def exact_gnn_forward(params, h0: torch.Tensor, graph,
                      dgl_parity: bool = True) -> torch.Tensor:
    """h_final of the exact-levels walk.

    params: maps ``fc_cell_self``, ``fc_cell_neigh`` and ``fc_net_self``
    to the pair-step MLPs (modules or any callables). h0: (num_rows+1, D)
    float32 initial state; it is not modified — the walk writes each
    level's rows in place into a copy (JAX's functional
    ``dynamic_update_slice`` becomes a slice assignment). graph: a
    :class:`prtp_tpu_torch.graph.LeveledGraphExact` on h0's device.
    """
    num_rows = graph.num_rows
    h = h0.clone()
    for k in range(graph.num_pairs):
        cell_mail = graph.cell_mail[k]
        pn_c, md_c = cell_mail.shape
        # ---- cell half (even level 2k): mailbox read straight from h ----
        pre = params["fc_cell_self"](graph.cell_feat_lvl[k])
        if k > 0:  # level 0 drops the neighbour term
            pre = pre + params["fc_cell_neigh"](
                softmax_sum(h, cell_mail, num_rows))
        new = F.relu(pre)
        c0 = graph.cell_off[k]
        if dgl_parity:
            has = (cell_mail != num_rows).any(dim=1, keepdim=True)
            new = torch.where(has, new, F.relu(h[c0: c0 + pn_c]))
        h[c0: c0 + pn_c] = new
        # ---- net half (odd level 2k+1): [new | prior] mailbox ----
        prior_rows = graph.gather_rows[k][pn_c * md_c:]
        prior = gather_rows(h, prior_rows) if prior_rows.numel() else new[:0]
        neigh_n = local_mean(new, prior, graph.net_local_idx[k])
        new_n = F.relu(params["fc_net_self"](graph.net_feat_lvl[k]) + neigh_n)
        net_mail = graph.net_mail[k]
        n0 = graph.net_off[k]
        if dgl_parity:
            hasn = (net_mail != num_rows).any(dim=1, keepdim=True)
            new_n = torch.where(hasn, new_n,
                                F.relu(h[n0: n0 + net_mail.shape[0]]))
        h[n0: n0 + net_mail.shape[0]] = new_n
    return h
