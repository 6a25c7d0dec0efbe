"""The exact-levels level walk (forward) and its mailbox-reduce kernels.

Port of ``prtp_tpu/ops/fused_gnn.py::_forward_impl``, op for op: per
level pair, ONE global row gather ``h[gather_rows]`` serves the cell
mailbox and the net half's prior-row sources (:func:`gather_rows`); the
cell half reduces its mailbox with a masked per-channel softmax
(:func:`softmax_sum`); the net half gathers its mailbox LOCALLY from
``buf = [new cell rows | gathered prior rows | 0]`` and takes a masked
mean (:func:`local_mean`, gather and reduce fused). Pair 0 skips the
gather (PIs have no in-edges); level 0 drops the neighbour term; with
``dgl_parity`` a row whose mailbox is empty keeps ``relu(old)``.

``softmax_sum`` and ``local_mean`` are CUDA kernels
(``csrc/softmax_sum.cu``, ``csrc/local_mean.cu``, whose source notes give
bound and design) with plain PyTorch versions beside them. For tensors
on the CPU a wrapper runs the plain version; for CUDA tensors it
launches the kernel or raises. The backward walk (``_bwd``) comes with
the training slice.
"""

from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p

import torch
import torch.nn.functional as F

from . import _build
from .gather import device_of, gather_rows

_SOFTMAX_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_int64, c_int, c_int,
                     c_void_p]
_MEAN_ARGTYPES = [c_void_p, c_void_p, c_void_p, c_int64, c_int, c_int,
                  c_int64, c_void_p]


# ------------------------------------------------------------ softmax_sum

def softmax_sum_plain(m: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked elementwise mailbox softmax-weighted sum over axis 1
    (``_softmax_sum``): m (P, K, D), valid (P, K) bool -> (P, D)."""
    v = valid[..., None]
    mx = torch.where(v, m, torch.full_like(m, -torch.inf)).amax(
        dim=1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.where(v, torch.exp(m - mx), torch.zeros_like(m))
    denom = ex.sum(dim=1, keepdim=True).clamp_min(1e-12)
    return (ex / denom * m).sum(dim=1)


def softmax_sum(m: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Cell-half mailbox reduce: m (P, K, D) float32 contiguous, valid
    (P, K) bool. An all-invalid row gives 0."""
    if m.dim() != 3 or m.dtype != torch.float32 or not m.is_contiguous():
        raise ValueError("m must be a contiguous (P, K, D) float32 tensor, "
                         f"got {m.dtype} {tuple(m.shape)}")
    if (valid.dtype != torch.bool or tuple(valid.shape) != tuple(m.shape[:2])
            or not valid.is_contiguous()):
        raise ValueError(f"valid must be a contiguous bool {tuple(m.shape[:2])}"
                         f" tensor, got {valid.dtype} {tuple(valid.shape)}")
    if device_of("softmax_sum", m, valid).type == "cpu":
        return softmax_sum_plain(m, valid)
    p, k, d = m.shape
    out = torch.empty((p, d), dtype=m.dtype, device=m.device)
    with torch.cuda.device(m.device):
        _build.launch("softmax_sum", _SOFTMAX_ARGTYPES, m.data_ptr(),
                      valid.data_ptr(), out.data_ptr(), p, k, d,
                      torch.cuda.current_stream(m.device).cuda_stream)
    softmax_sum.launches += 1
    return out


softmax_sum.launches = 0


# ------------------------------------------------------------- local_mean

def local_mean_plain(buf: torch.Tensor, idx: torch.Tensor,
                     num_valid: int) -> torch.Tensor:
    """``_mean_sum(buf[idx], idx < num_valid)``: masked mean of the
    locally gathered mailbox, buf (R, D), idx (P, K) -> (P, D)."""
    m = buf[idx.long()]
    v = (idx < num_valid)[..., None]
    s = torch.where(v, m, torch.zeros_like(m)).sum(dim=1)
    cnt = v.sum(dim=1).to(m.dtype).clamp_min(1.0)
    return s / cnt


def local_mean(buf: torch.Tensor, idx: torch.Tensor,
               num_valid: int) -> torch.Tensor:
    """Net-half mailbox: gather rows of ``buf`` (R, D) float32 by ``idx``
    (P, K) int32 and average the slots whose index is below
    ``num_valid``; an all-invalid row gives 0."""
    if buf.dim() != 2 or buf.dtype != torch.float32 or not buf.is_contiguous():
        raise ValueError("buf must be a contiguous (R, D) float32 tensor, "
                         f"got {buf.dtype} {tuple(buf.shape)}")
    if idx.dim() != 2 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous (P, K) int32 tensor, "
                         f"got {idx.dtype} {tuple(idx.shape)}")
    if not 0 <= num_valid < buf.shape[0]:
        raise ValueError(f"num_valid {num_valid} must index buf's dummy row "
                         f"(buf has {buf.shape[0]} rows)")
    if device_of("local_mean", buf, idx).type == "cpu":
        return local_mean_plain(buf, idx, num_valid)
    p, k = idx.shape
    d = buf.shape[1]
    out = torch.empty((p, d), dtype=buf.dtype, device=buf.device)
    with torch.cuda.device(buf.device):
        _build.launch("local_mean", _MEAN_ARGTYPES, buf.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), p, k, d, num_valid,
                      torch.cuda.current_stream(buf.device).cuda_stream)
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
    d = h.shape[1]
    zero_row = h.new_zeros((1, d))
    for k in range(graph.num_pairs):
        cell_mail = graph.cell_mail[k]
        pn_c, md_c = cell_mail.shape
        g_rows = graph.gather_rows[k]
        # ---- one global gather for both halves ----
        gat = (gather_rows(h, g_rows)
               if k > 0 or g_rows.shape[0] > pn_c * md_c else None)
        # ---- cell half (even level 2k) ----
        valid = cell_mail != num_rows
        pre = params["fc_cell_self"](graph.cell_feat_lvl[k])
        if k > 0:  # level 0 drops the neighbour term
            m_c = gat[: pn_c * md_c].view(pn_c, md_c, d)
            pre = pre + params["fc_cell_neigh"](softmax_sum(m_c, valid))
        new = F.relu(pre)
        c0 = graph.cell_off[k]
        if dgl_parity:
            has = valid.any(dim=1, keepdim=True)
            new = torch.where(has, new, F.relu(h[c0: c0 + pn_c]))
        h[c0: c0 + pn_c] = new
        # ---- net half (odd level 2k+1): local-gather mailbox ----
        net_mail = graph.net_mail[k]
        pn_n = net_mail.shape[0]
        prior = gat[pn_c * md_c:] if gat is not None else zero_row[:0]
        buf = torch.cat([new, prior, zero_row])
        neigh_n = local_mean(buf, graph.net_local_idx[k],
                             pn_c + prior.shape[0])
        new_n = F.relu(params["fc_net_self"](graph.net_feat_lvl[k]) + neigh_n)
        n0 = graph.net_off[k]
        if dgl_parity:
            hasn = (net_mail != num_rows).any(dim=1, keepdim=True)
            new_n = torch.where(hasn, new_n, F.relu(h[n0: n0 + pn_n]))
        h[n0: n0 + pn_n] = new_n
    return h
