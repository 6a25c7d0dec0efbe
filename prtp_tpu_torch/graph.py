"""Design containers and the host->device packer (exact levels only).

Port of ``prtp_tpu/graph.py``'s exact-levels packing. The pin DAG
alternates strictly between *cell* levels (even: output pins / PIs,
aggregated over ``cell`` edges) and *net* levels (odd: input pins,
aggregated over ``net`` edges); levels are packed into **pairs**
(cell level 2k, net level 2k+1). Nodes are renumbered
level-contiguously, each level with its TRUE size (an empty level gets
a 1-row block), so every level's update is one contiguous row write
into the node-state matrix ``h`` of ``num_rows + 1`` rows (the last row
is the gather dummy for padded mailbox slots).

The JAX package also has padded and grouped packings; they exist to
bound XLA recompiles and are numerically equal to this one, so the port
has only the exact layout. The raster stays NCHW and no im2col patch
table is built: Conv_0 runs as a plain convolution, forward and
backward (on the H100 cuDNN's is faster than the patch-table product).

:func:`merge_parsed_designs` (a copy of JAX's) joins K parsed designs
into one super-graph whose level l is the union of every design's level
l; the packer takes it as one bigger design, with its K rasters stacked.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import resolve_device


@dataclass
class LeveledGraphExact:
    """Per-pair tables with the TRUE level sizes, as tensors on a device.

    Row layout: pair k's cell block starts at ``cell_off[k]``, its net
    block at ``net_off[k]``. Index tables are int32; ``num_rows`` is the
    dummy row of every mailbox table.
    """

    cell_feat_lvl: tuple  # P x (n_c_k, Fc) float32 (bf16 in a bf16 pack)
    net_feat_lvl: tuple   # P x (n_n_k, Fn) float32 (bf16 in a bf16 pack)
    cell_mail: tuple      # P x (n_c_k, md_c_k) int32, pad = num_rows
    net_mail: tuple       # P x (n_n_k, md_n_k) int32, pad = num_rows
    cell_rev_pos: tuple   # P x (e_c_k,) int32 flat mailbox positions
    cell_rev_rows: tuple  # P x (e_c_k,) int32 source rows, ascending
    net_rev_pos: tuple    # P x (e_n_k,)
    net_rev_rows: tuple   # P x (e_n_k,)
    # walk-backward tables: per pair, the prior-row contributions of both
    # halves merged into one sorted unique-row scatter, plus the net edges
    # whose source lies in the pair's own cell block
    merged_pos: tuple     # P x (E_k,) flat pos into [cell|net] mailboxes
    merged_seg: tuple     # P x (E_k,) segment id into merged_rows
    merged_rows: tuple    # P x (U_k,) unique prior rows, sorted
    intra_pos: tuple      # P x (I_k,) flat pos into the net mailbox
    intra_slot: tuple     # P x (I_k,) local cell-block slot
    # port-only CSR forms of the two scatters (ops.fused_gnn.mailbox_scatter):
    # segment s of merged_rows holds merged_pos[merged_seg_off[s]:
    # merged_seg_off[s+1]]; intra_rows are the distinct intra_slot values
    merged_seg_off: tuple  # P x (U_k + 1,)
    intra_rows: tuple      # P x (J_k,) distinct cell-block slots, sorted
    intra_seg_off: tuple   # P x (J_k + 1,)
    # port-only: each net row's count of valid mailbox slots, at least 1
    # (JAX's backward `cnt = maximum(validn.sum(1), 1)`), the divisor of
    # the net mailbox cotangent
    net_cnt: tuple        # P x (n_n_k,) float32
    # walk-forward tables: ONE global gather per pair serves both halves,
    # gather_rows = [cell_mail.flat | net prior-row sources]; the net
    # mailbox is then a LOCAL gather from buf = [new_cell | prior | 0]
    gather_rows: tuple    # P x (n_c_k*md_c_k + n_prior_k,)
    net_local_idx: tuple  # P x (n_n_k, md_n_k) into buf; pad = n_c_k + n_prior_k
    # the row has an in-edge: the dgl_parity mask of both walks
    cell_has_in: tuple    # P x (n_c_k, 1) bool
    net_has_in: tuple     # P x (n_n_k, 1) bool
    cell_off: tuple       # P ints
    net_off: tuple        # P ints
    num_rows: int
    # per pair, the rows of its cell and its net level in JAX's padded or
    # grouped scan (:func:`scan_pair_rows`): its bf16 bias gradients sum
    # that many rows, the zeros of the padding included (the walks' "scan"
    # rounding)
    scan_rows: tuple = ()
    # this rank's block of the edge tables under the 2-D (dp, gp) mesh
    # (parallel.graph_shard.shard_design); None: the whole level
    shard: object = None
    # the segment reduce's flat edge tables (ops.segment_walk), packed
    # only on request (``segment=True``; else None), per half (cell_*,
    # net_*): the level's edges sorted by destination slot, the slot's
    # CSR offsets, and for the backward's scatter the edges sorted by
    # source row (stable), grouped by distinct source row: segment s adds
    # into row src_rows[s] the entries src_pos[src_off[s]: src_off[s+1]],
    # which for a cell level are edge ids (into the per-edge cotangent)
    # and for a net level destination slots (its cotangent is the slot's
    # mean cotangent)
    cell_src: tuple = None       # P x (e_c_k,) int32 source rows, dst-sorted
    cell_dst_slot: tuple = None  # P x (e_c_k,) int32 destination slots
    cell_dst_off: tuple = None   # P x (n_c_k + 1,) int32
    cell_src_pos: tuple = None   # P x (e_c_k,) int32 edge ids, src-sorted
    cell_src_rows: tuple = None  # P x (u_c_k,) int32 distinct source rows
    cell_src_off: tuple = None   # P x (u_c_k + 1,) int32
    net_src: tuple = None        # P x (e_n_k,)
    net_dst_slot: tuple = None   # P x (e_n_k,)
    net_dst_off: tuple = None    # P x (n_n_k + 1,)
    net_src_pos: tuple = None    # P x (e_n_k,) destination slots, src-sorted
    net_src_rows: tuple = None   # P x (u_n_k,)
    net_src_off: tuple = None    # P x (u_n_k + 1,)

    @property
    def num_pairs(self) -> int:
        return len(self.cell_feat_lvl)

    @property
    def stacked(self) -> bool:
        """Whether :attr:`scan_rows` lay the levels out as a stack of
        designs on one bucket (:func:`stack_level_rows`): the super-graph
        of designs that JAX stacks and vmaps, whose scan XLA compiles with
        one more rounding (``ops.fused_gnn._mlp_grads``' ``round_dx``)."""
        return bool(self.scan_rows) and isinstance(self.scan_rows[0][0], tuple)


@dataclass
class DesignData:
    """One packed design on a device. Node-indexed arrays use the
    level-contiguous state-row numbering of :class:`LeveledGraphExact`."""

    graph: LeveledGraphExact
    arrival_time: torch.Tensor   # (num_rows+1,) float32
    required_time: torch.Tensor  # (num_rows+1,) float32
    is_critical: torch.Tensor    # (num_rows+1,) int32
    path_endpoint: torch.Tensor  # (num_paths,) int32 state row of endpoint
    path_level: torch.Tensor     # (num_paths,) float32 topo level of path
    path_masks: torch.Tensor     # (num_paths, map_size^2) uint8
    # (K, C, H, W) float32 (or bf16), NCHW: K = 1, or a merged
    # super-graph's K designs
    cnn_input: torch.Tensor

    @property
    def num_paths(self) -> int:
        return self.path_endpoint.shape[0]


def _sorted_level_tables(e_src, slot, pn, md, num_rows):
    """dst-sorted edge tables for ONE level: the dense mailbox (``pos`` =
    index within each destination's segment, ``num_rows`` = dummy) and
    the transpose tables (flat mailbox positions + source rows, sorted by
    source row ascending). Returns ``(e_src, slot, mail, rev_pos,
    rev_rows)``."""
    order = np.argsort(slot, kind="stable")
    e_src = np.asarray(e_src)[order].astype(np.int32)
    slot = np.asarray(slot)[order].astype(np.int32)
    mail = np.full((pn, md), num_rows, np.int32)
    pos = np.arange(len(slot)) - np.searchsorted(slot, slot)
    mail[slot, pos] = e_src
    flat = (slot.astype(np.int64) * md + pos).astype(np.int32)
    order2 = np.argsort(e_src, kind="stable")
    return e_src, slot, mail, flat[order2], e_src[order2]


def _csr_offsets(seg, num_segments):
    """Offsets of a sorted segment-id array: segment s spans
    ``[off[s], off[s + 1])``."""
    return np.searchsorted(seg, np.arange(num_segments + 1)).astype(np.int32)


def _pack_exact_numpy(parsed, segment=False):
    """The exact-levels tables as numpy arrays, the segment reduce's flat
    edge tables only with ``segment``.

    Returns ``(tables, node_row, num_rows)``; ``tables`` maps each
    per-pair field of :class:`LeveledGraphExact` to a list of arrays
    (and ``cell_off``/``net_off`` to lists of ints)."""
    levels = parsed["levels"]
    n = int(parsed["num_nodes"])
    n_levels = len(levels)
    n_pairs = (n_levels + 1) // 2

    def level_ids(li):
        return (np.asarray(levels[li][0], dtype=np.int64)
                if li < n_levels else np.zeros(0, np.int64))

    # exact row layout
    node_row = np.full(n, -1, dtype=np.int64)
    node_level = np.full(n, -1, dtype=np.int64)
    cell_off, net_off = [], []
    off = 0
    for li in range(2 * n_pairs):
        ids = level_ids(li)
        (cell_off if li % 2 == 0 else net_off).append(off)
        node_row[ids] = off + np.arange(len(ids))
        node_level[ids] = li
        off += max(len(ids), 1)
    num_rows = off

    fc = parsed["cell_feat"].shape[1]
    fn = parsed["net_feat"].shape[1]
    cell_feat_l, net_feat_l = [], []
    for li in range(2 * n_pairs):
        ids = level_ids(li)
        feat_key = "cell_feat" if li % 2 == 0 else "net_feat"
        width = fc if li % 2 == 0 else fn
        block = np.zeros((max(len(ids), 1), width), np.float32)
        if len(ids):
            block[: len(ids)] = parsed[feat_key][ids]
        (cell_feat_l if li % 2 == 0 else net_feat_l).append(block)

    def per_level_tables(parity, edges):
        src, dst = (np.asarray(edges[0], np.int64),
                    np.asarray(edges[1], np.int64))
        lev = node_level[dst]
        mails, rposs, rrows = [], [], []
        flat = {key: [] for key in (("src", "dst_slot", "dst_off", "src_pos",
                                     "src_rows", "src_off") * segment
                                    + ("has_in",))}
        offsets = cell_off if parity == 0 else net_off
        blocks = cell_feat_l if parity == 0 else net_feat_l
        for k in range(n_pairs):
            sel = lev == 2 * k + parity
            slot0 = node_row[dst[sel]] - offsets[k]
            pn = blocks[k].shape[0]
            md = max(1, int(np.bincount(slot0).max())) if len(slot0) else 1
            e_src, slot, mail, rp, rr = _sorted_level_tables(
                node_row[src[sel]], slot0, pn, md, num_rows)
            mails.append(mail)
            rposs.append(rp)
            rrows.append(rr)
            flat["has_in"].append((np.bincount(slot, minlength=pn)
                                   > 0)[:, None])
            if not segment:
                continue
            order = np.argsort(e_src, kind="stable")
            rows, seg = np.unique(e_src[order], return_inverse=True)
            flat["src"].append(e_src)
            flat["dst_slot"].append(slot)
            flat["dst_off"].append(_csr_offsets(slot, pn))
            # a net entry reads its destination's cotangent, a cell entry
            # its edge's
            flat["src_pos"].append(
                (order if parity == 0 else slot[order]).astype(np.int32))
            flat["src_rows"].append(rows.astype(np.int32))
            flat["src_off"].append(_csr_offsets(seg, len(rows)))
        half = "cell" if parity == 0 else "net"
        return mails, rposs, rrows, {f"{half}_{key}": v
                                     for key, v in flat.items()}

    cm, crp, crr, cell_flat = per_level_tables(0, parsed["cell_edges"])
    nm, nrp, nrr, net_flat = per_level_tables(1, parsed["net_edges"])

    m_pos, m_seg, m_rows, i_pos, i_slot = [], [], [], [], []
    m_off, i_rows, i_off = [], [], []
    g_rows, n_local = [], []
    for k in range(n_pairs):
        pn_c, md_c = cm[k].shape
        flat_c, src_c = crp[k].astype(np.int64), crr[k].astype(np.int64)
        flat_n, src_n = nrp[k].astype(np.int64), nrr[k].astype(np.int64)
        c0 = cell_off[k]
        if not ((src_c < c0).all() and (src_n < net_off[k]).all()):
            raise ValueError(f"pair {k}: an edge source lies at or after "
                             "its destination's level")
        # backward tables: merged prior-row scatter + intra-pair net edges
        prior = src_n < c0
        intra = ~prior
        cat_pos = np.concatenate([flat_c, pn_c * md_c + flat_n[prior]])
        rows = np.concatenate([src_c, src_n[prior]])
        order = np.argsort(rows, kind="stable")
        cat_pos, rows = cat_pos[order], rows[order]
        uniq, seg = np.unique(rows, return_inverse=True)
        m_pos.append(cat_pos.astype(np.int32))
        m_seg.append(seg.astype(np.int32))
        m_rows.append(uniq.astype(np.int32))
        m_off.append(_csr_offsets(seg, len(uniq)))
        fi, si = flat_n[intra], (src_n[intra] - c0)
        o2 = np.argsort(si, kind="stable")
        i_pos.append(fi[o2].astype(np.int32))
        i_slot.append(si[o2].astype(np.int32))
        slots, i_seg = np.unique(si[o2], return_inverse=True)
        i_rows.append(slots.astype(np.int32))
        i_off.append(_csr_offsets(i_seg, len(slots)))
        # forward tables: one global gather for both halves
        flat_nm = nm[k].reshape(-1).astype(np.int64)
        validm = flat_nm != num_rows
        prior_m = validm & (flat_nm < c0)
        intra_m = validm & ~(flat_nm < c0)
        n_prior = int(prior_m.sum())
        local = np.full(flat_nm.shape, pn_c + n_prior, np.int64)  # dummy
        local[intra_m] = flat_nm[intra_m] - c0
        local[prior_m] = pn_c + np.arange(n_prior)
        g_rows.append(np.concatenate(
            [cm[k].reshape(-1).astype(np.int32),
             flat_nm[prior_m].astype(np.int32)]))
        n_local.append(local.reshape(nm[k].shape).astype(np.int32))

    tables = dict(
        cell_feat_lvl=cell_feat_l, net_feat_lvl=net_feat_l,
        cell_mail=cm, net_mail=nm,
        cell_rev_pos=crp, cell_rev_rows=crr,
        net_rev_pos=nrp, net_rev_rows=nrr,
        merged_pos=m_pos, merged_seg=m_seg, merged_rows=m_rows,
        intra_pos=i_pos, intra_slot=i_slot,
        merged_seg_off=m_off, intra_rows=i_rows, intra_seg_off=i_off,
        net_cnt=[np.maximum((m != num_rows).sum(axis=1), 1).astype(np.float32)
                 for m in nm],
        gather_rows=g_rows, net_local_idx=n_local,
        **cell_flat, **net_flat,
        cell_off=cell_off, net_off=net_off)
    return tables, node_row, num_rows


SCAN_ALIGN = 128


def _round_up(x: int, m: int) -> int:
    return ((max(int(x), 1) + m - 1) // m) * m


def _pair_sizes(parsed) -> tuple:
    """Each level pair's cell and net level sizes (0 for a missing last
    net level)."""
    levels = parsed["levels"]
    n_pairs = (len(levels) + 1) // 2
    return ([len(levels[2 * k][0]) for k in range(n_pairs)],
            [len(levels[2 * k + 1][0]) if 2 * k + 1 < len(levels) else 0
             for k in range(n_pairs)])


def scan_level_rows(parsed_list, align: int = SCAN_ALIGN) -> tuple:
    """``(pn_c, pn_n)``: the rows of every cell and every net level in
    JAX's padded scan over the designs of ``parsed_list`` (full parsed
    dicts or ``data.dataset.load_design_shapes``'s): each half's largest
    level rounded up to ``align``, the largest over the designs, as
    ``prtp_tpu/graph.py::bucket_shape`` and ``_level_layout`` pad them."""
    rows = [1, 1]
    for parsed in parsed_list:
        for parity, sizes in enumerate(_pair_sizes(parsed)):
            rows[parity] = max(rows[parity],
                               _round_up(max(sizes, default=1), align))
    return tuple(rows)


def choose_pair_groups(cell_sizes, net_sizes, num_groups):
    """Contiguous partition of level pairs into <= ``num_groups`` groups
    minimizing the padded compute sum_g P_g * (max_cell_g + max_net_g)
    (exact DP). A copy of ``prtp_tpu/graph.py::choose_pair_groups``:
    JAX's grouped scan pads each group's levels to the group's largest."""
    p = len(cell_sizes)
    assert p >= 1
    num_groups = max(1, min(int(num_groups), p))
    cost = {}

    def seg_cost(i, j):  # pairs [i, j)
        if (i, j) not in cost:
            cost[(i, j)] = (j - i) * (max(cell_sizes[i:j])
                                      + max(net_sizes[i:j]))
        return cost[(i, j)]

    inf = float("inf")
    dp = [[inf] * (p + 1) for _ in range(num_groups + 1)]
    back = [[0] * (p + 1) for _ in range(num_groups + 1)]
    dp[0][0] = 0.0
    for k in range(1, num_groups + 1):
        for j in range(1, p + 1):
            for i in range(k - 1, j):
                if dp[k - 1][i] is inf:
                    continue
                c = dp[k - 1][i] + seg_cost(i, j)
                if c < dp[k][j]:
                    dp[k][j], back[k][j] = c, i
    k_best = min(range(1, num_groups + 1), key=lambda k: (dp[k][p], k))
    bounds, j, k = [], p, k_best
    while k:
        i = back[k][j]
        bounds.append((i, j))
        j, k = i, k - 1
    return list(reversed(bounds))


def auto_scan_groups(cell_sizes, net_sizes, max_groups=8, overhead=1.15,
                     align=1):
    """The smallest group count whose padded compute is within
    ``overhead`` of the best any aligned grouping can achieve, the level
    sizes rounded up to ``align`` first: what ``--scan_groups 0``
    resolves to. A copy of ``prtp_tpu/graph.py::auto_scan_groups``."""
    cell_sizes = [_round_up(c, align) for c in cell_sizes]
    net_sizes = [_round_up(n, align) for n in net_sizes]
    p = len(cell_sizes)
    ideal = float(sum(cell_sizes) + sum(net_sizes))
    if ideal <= 0 or p <= 1:
        return 1
    for g in range(1, min(max_groups, p) + 1):
        bounds = choose_pair_groups(cell_sizes, net_sizes, g)
        cost = sum((j - i) * (max(cell_sizes[i:j]) + max(net_sizes[i:j]))
                   for i, j in bounds)
        if cost <= overhead * ideal:
            return g
    return min(max_groups, p)


def scan_pair_rows(parsed, scan_groups: int = 1, align: int = SCAN_ALIGN,
                   bucket=None) -> tuple:
    """Per level pair of ``parsed``, ``(pn_c, pn_n)``: the rows of its
    cell and its net level in the scan JAX packs it for. With
    ``scan_groups`` N > 1, or 0 (``auto_scan_groups``) resolving to more
    than 1, that is the grouped scan (``prtp_tpu/graph.py::
    pack_leveled_graph_grouped``), whose pairs' levels are padded to
    their group's largest, rounded up to ``align``; else the padded scan,
    every pair's levels padded to ``bucket`` (a ``(pn_c, pn_n)`` from
    :func:`scan_level_rows`, the train CLI's bucket over its designs) or,
    without one, to this design's largest."""
    cells, nets = _pair_sizes(parsed)
    if scan_groups == 0:
        scan_groups = auto_scan_groups(cells, nets, align=align)
    if scan_groups <= 1:
        rows = tuple(bucket or scan_level_rows([parsed], align))
        return (rows,) * len(cells)
    rows = []
    for k0, k1 in choose_pair_groups([_round_up(c, align) for c in cells],
                                     [_round_up(n, align) for n in nets],
                                     scan_groups):
        rows += [(_round_up(max(cells[k0:k1]), align),
                  _round_up(max(nets[k0:k1]), align))] * (k1 - k0)
    return tuple(rows)


def pack_leveled_graph_exact(parsed, device="cuda",
                             compute_dtype=torch.float32, scan_rows=None,
                             segment=False):
    """Exact-shape packer. Returns ``(graph, node_row, num_rows)``. The
    feature tables are ``compute_dtype``, as JAX packs them.
    ``scan_rows`` are the level rows of JAX's scan, which the walks'
    bf16 backward in the scan's rounding reads: one ``(pn_c, pn_n)`` a
    level pair (default: :func:`scan_pair_rows` of this design, its
    padded scan). ``segment`` adds the flat edge tables of the segment
    reduce (``gnn_reduce="segment"``)."""
    dev = resolve_device(device)
    tables, node_row, num_rows = _pack_exact_numpy(parsed, segment)
    fields = {}
    for key, arrs in tables.items():
        if key in ("cell_off", "net_off"):
            fields[key] = tuple(int(o) for o in arrs)
        else:
            dt = (compute_dtype if key in ("cell_feat_lvl", "net_feat_lvl")
                  else None)
            fields[key] = tuple(torch.from_numpy(np.ascontiguousarray(a))
                                .to(dev, dt) for a in arrs)
    n_pairs = len(fields["cell_off"])
    if scan_rows is None:
        scan_rows = scan_pair_rows(parsed)
    if len(scan_rows) != n_pairs:
        raise ValueError(f"scan_rows gives {len(scan_rows)} level pairs, "
                         f"the design has {n_pairs}")
    return (LeveledGraphExact(num_rows=num_rows,
                              scan_rows=tuple(map(tuple, scan_rows)),
                              **fields),
            node_row, num_rows)


def pack_design(parsed, map_size=128, device="cuda",
                compute_dtype=torch.float32, scan_rows=None, segment=False):
    """Pack a host-side parsed design (dict of numpy arrays) into
    :class:`DesignData` on ``device``. The feature tables and the raster
    are ``compute_dtype`` (bf16 under ``--compute_dtype bfloat16`` in the
    train CLI, as ``prtp_tpu/graph.py`` packs them); everything else is
    as for float32.

    ``parsed`` keys: num_nodes, cell_feat (N,Fc), net_feat (N,Fn),
    levels, cell_edges (2,Ec), net_edges (2,En), arrival_time (N,),
    required_time (N,), is_critical (N,), path_endpoint (num_paths,),
    path_level (num_paths,), mask_coo (2, nnz), num_paths, cnn_input
    (C,H,W), or (K,C,H,W) for a merged super-graph
    (:func:`merge_parsed_designs`). ``scan_rows`` and ``segment`` (the
    segment reduce's edge tables): as for :func:`pack_leveled_graph_exact`.
    """
    dev = resolve_device(device)
    graph, node_row, num_rows = pack_leveled_graph_exact(
        parsed, dev, compute_dtype, scan_rows, segment)

    def remap(key, dtype=np.float32):
        vals = np.asarray(parsed[key], dtype=dtype).reshape(-1)
        out = np.zeros(num_rows + 1, dtype=dtype)
        valid = node_row < num_rows
        out[node_row[valid]] = vals[: len(node_row)][valid]
        return torch.from_numpy(out).to(dev)

    num_paths = int(parsed["num_paths"])
    masks = np.zeros((num_paths, map_size * map_size), dtype=np.uint8)
    coo = np.asarray(parsed["mask_coo"], dtype=np.int64)
    if coo.size:
        masks[coo[0], coo[1]] = 1
    path_endpoint = node_row[
        np.asarray(parsed["path_endpoint"], np.int64)].astype(np.int32)
    path_level = np.asarray(parsed["path_level"], np.float32)[:num_paths]
    cnn_input = np.asarray(parsed["cnn_input"], dtype=np.float32)
    if cnn_input.ndim == 3:
        cnn_input = cnn_input[None]
    elif cnn_input.ndim != 4:
        raise ValueError(f"cnn_input {cnn_input.shape}: (C, H, W), or "
                         "(K, C, H, W) for a merged super-graph")
    return DesignData(
        graph=graph,
        arrival_time=remap("arrival_time"),
        required_time=remap("required_time"),
        is_critical=remap("is_critical", np.int32),
        path_endpoint=torch.from_numpy(path_endpoint).to(dev),
        path_level=torch.from_numpy(np.ascontiguousarray(path_level)).to(dev),
        path_masks=torch.from_numpy(masks).to(dev),
        cnn_input=torch.from_numpy(np.ascontiguousarray(cnn_input))
        .to(dev, compute_dtype),
    )


def merge_parsed_designs(parsed_list):
    """Concatenate K parsed designs into ONE super-graph parsed dict.

    Port of ``prtp_tpu/graph.py::merge_parsed_designs``: a disjoint DAG
    whose level l is the union of every design's level l, nodes and
    paths renumbered by offsets, so that one level walk propagates all K
    designs at once with K x wider level blocks. The CNN rasters are
    stacked on a leading axis (all must share a shape; the designs must
    share a cell-type library), and the model reads them with grouped
    path ids of shape ``(K, Bk)``, row k holding design k's paths only
    (``path_ids_per_design``).

    Returns a parsed dict with the extra keys ``path_design`` (path ->
    design index) and ``path_ids_per_design`` (per-design sampling
    universes, already offset).
    """
    assert len(parsed_list) >= 1
    num_ctypes = {int(p["num_ctypes"]) for p in parsed_list
                  if "num_ctypes" in p}
    assert len(num_ctypes) <= 1, "designs must share the cell-type library"
    node_off = np.cumsum([0] + [int(p["num_nodes"]) for p in parsed_list])
    path_off = np.cumsum([0] + [int(p["num_paths"]) for p in parsed_list])

    def get_arr(p, key):
        if key in p:
            return np.asarray(p[key])
        if key in ("is_start", "is_end"):  # optional in minimal dicts
            return np.zeros(int(p["num_nodes"]), np.int64)
        if key == "path2level":
            return np.asarray(p["path_level"], np.int64)
        if key == "critical_paths":
            return np.zeros(0, np.int64)
        raise KeyError(key)

    def cat_rows(key, off=None):
        return np.concatenate([get_arr(p, key) if off is None
                               else get_arr(p, key) + off[k]
                               for k, p in enumerate(parsed_list)], axis=0)

    def cat_edges(key):
        return tuple(np.concatenate(
            [np.asarray(p[key][i], np.int64) + node_off[k]
             for k, p in enumerate(parsed_list)]) for i in (0, 1))

    def cat_level(li, field, off):
        parts = [np.asarray(p["levels"][li][field], np.int64) + off[k]
                 for k, p in enumerate(parsed_list) if li < len(p["levels"])]
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    n_levels = max(len(p["levels"]) for p in parsed_list)
    levels = [(cat_level(li, 0, node_off), cat_level(li, 1, node_off),
               cat_level(li, 2, path_off)) for li in range(n_levels)]

    coo = np.concatenate(
        [np.stack([np.asarray(p["mask_coo"][0], np.int64) + path_off[k],
                   np.asarray(p["mask_coo"][1], np.int64)])
         for k, p in enumerate(parsed_list)], axis=1)

    cnn_shapes = {np.asarray(p["cnn_input"]).shape for p in parsed_list}
    assert len(cnn_shapes) == 1, \
        f"designs must share a CNN raster shape, got {cnn_shapes}"
    cnn_input = np.stack([np.asarray(p["cnn_input"], np.float32)
                          for p in parsed_list])  # (K, C, H, W)

    merged = {
        "num_nodes": int(node_off[-1]),
        "num_paths": int(path_off[-1]),
        "cell_feat": cat_rows("cell_feat"),
        "net_feat": cat_rows("net_feat"),
        "is_start": cat_rows("is_start"),
        "is_end": cat_rows("is_end"),
        "is_critical": cat_rows("is_critical"),
        "arrival_time": cat_rows("arrival_time"),
        "required_time": cat_rows("required_time"),
        "cell_edges": cat_edges("cell_edges"),
        "net_edges": cat_edges("net_edges"),
        "levels": levels,
        "path2level": cat_rows("path2level"),
        "path_level": cat_rows("path_level"),
        "path_endpoint": cat_rows("path_endpoint", off=node_off),
        "critical_paths": cat_rows("critical_paths", off=path_off),
        "mask_coo": coo,
        "cnn_input": cnn_input,
        "path_design": np.concatenate(
            [np.full(int(p["num_paths"]), k, np.int32)
             for k, p in enumerate(parsed_list)]),
        "path_ids_per_design": [
            np.asarray(p.get("path_ids", np.arange(int(p["num_paths"]))),
                       np.int64) + path_off[k]
            for k, p in enumerate(parsed_list)],
    }
    if num_ctypes:
        merged["num_ctypes"] = num_ctypes.pop()
    return merged


def stack_level_rows(parsed_list, bucket) -> tuple:
    """Per level pair of the super-graph that :func:`merge_parsed_designs`
    makes of ``parsed_list``, the rows its bf16 bias sums run over in
    JAX's stack of those designs on one bucket (``bucket``: a ``(pn_c,
    pn_n)`` of :func:`scan_level_rows`): ``((pn_c, cell counts), (pn_n,
    net counts))``, a count per design, its level's size (0 where it has
    no such level). ``ops.bf16.column_sums_bf16`` places each design's
    rows at the start of its own block of the bucket's rows, as
    ``jax.vmap`` flattens the stacked ``(K, pn)`` rows into one reduce."""
    sizes = [_pair_sizes(p) for p in parsed_list]
    n_pairs = max(len(cells) for cells, _nets in sizes)
    return tuple(
        tuple((bucket[h], tuple(s[h][k] if k < len(s[h]) else 0
                                for s in sizes)) for h in (0, 1))
        for k in range(n_pairs))


@dataclass
class StackedDesigns:
    """K parsed designs stacked for the multi-design step
    (``parallel/multi.py``), from :func:`stack_designs`.

    JAX pads every design to one bucket, stacks them on a leading axis
    and ``vmap``s the step over it. The port packs exact levels only, so
    its stacked form is its own: the super-graph of
    :func:`merge_parsed_designs` over a block of the designs (all K, or
    a design-sharded rank's contiguous block), whose level L is the
    union of the designs' level L, walked once. The other candidate, K
    walks in turn, would launch K times the kernels (about K x 1,000 a
    step) and cannot round as JAX does in bf16: under ``vmap`` XLA
    computes each pair's weight gradients as one product over all the
    designs' rows and its bias gradients as one bf16 reduce over them
    (read from the compiled HLO), which on the super-graph is one
    product over the merged level and one :func:`~prtp_tpu_torch.ops.
    bf16.column_sums_bf16` over the rows laid out as the bucket's
    (:func:`stack_level_rows`). ``bucket`` is that ``(pn_c, pn_n)``,
    over all K designs. The designs stay host dicts; a block's
    super-graph is packed with ``pack`` (:func:`pack_design`'s keywords)
    when a step first asks for it, and kept."""

    parsed: tuple
    bucket: tuple
    pack: dict
    _blocks: dict = field(default_factory=dict, repr=False)

    def __len__(self) -> int:
        return len(self.parsed)

    @property
    def num_pairs(self) -> int:
        """The level pairs of the bucket: the most any design has."""
        return max((len(p["levels"]) + 1) // 2 for p in self.parsed)

    def block(self, lo: int, hi: int):
        """``(design, first_path)``: the packed super-graph of designs
        ``lo`` to ``hi - 1``, and each one's first path row in it (an
        int64 tensor ``(hi - lo,)`` on its device)."""
        if (lo, hi) not in self._blocks:
            parsed = self.parsed[lo:hi]
            design = pack_design(merge_parsed_designs(parsed),
                                 scan_rows=stack_level_rows(parsed,
                                                            self.bucket),
                                 **self.pack)
            first_path = np.cumsum([0] + [int(p["num_paths"])
                                          for p in parsed[:-1]])
            self._blocks[(lo, hi)] = (design, torch.from_numpy(
                first_path).to(design.path_endpoint.device))
        return self._blocks[(lo, hi)]

    def rows(self, lo: int, hi: int, path_ids: torch.Tensor):
        """``(design, ids)``: :meth:`block` ``(lo, hi)`` and ``path_ids``
        ``(hi - lo, B)``, row k holding design ``lo + k``'s own path ids,
        as the super-graph's path rows (JAX's pad id 0 reads the design's
        own path 0)."""
        design, first_path = self.block(lo, hi)
        return design, path_ids.long() + first_path[:, None]


def stack_designs(parsed_list, align: int = SCAN_ALIGN, map_size=128,
                  device="cuda", compute_dtype=torch.float32,
                  segment=False) -> StackedDesigns:
    """Stack K parsed designs for the multi-design step
    (``prtp_tpu/graph.py::stack_designs`` of the designs packed on
    ``bucket_shape(parsed_list, align)``): a :class:`StackedDesigns`
    whose bucket is JAX's padded scan's level rows over all of them
    (:func:`scan_level_rows` at ``align``), its blocks packed as
    :func:`pack_design` packs with the other keywords. Designs that JAX
    cannot stack are refused: other feature widths or raster shape, or a
    merged super-graph."""
    parsed_list = tuple(parsed_list)
    if not parsed_list:
        raise ValueError("stack_designs got no designs")

    def key(p):
        return {"feature widths": (np.shape(p["cell_feat"])[1],
                                   np.shape(p["net_feat"])[1]),
                "raster shape": np.shape(p["cnn_input"])}

    want = key(parsed_list[0])
    for i, p in enumerate(parsed_list):
        if "path_design" in p or np.ndim(p["cnn_input"]) != 3:
            raise ValueError(f"design {i} is a merged super-graph: stack "
                             "designs parsed alone")
        for what, value in key(p).items():
            if value != want[what]:
                raise ValueError(
                    f"designs must share a treedef and shapes: design {i}'s"
                    f" {what} {value} differ from design 0's {want[what]}")
    return StackedDesigns(
        parsed_list, scan_level_rows(parsed_list, align),
        dict(map_size=map_size, device=resolve_device(device),
             compute_dtype=compute_dtype, segment=segment))
