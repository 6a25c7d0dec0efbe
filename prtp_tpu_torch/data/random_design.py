"""In-memory random design construction (benchmarks / smoke runs).

A copy of ``prtp_tpu/data/random_design.py``, kept in the port so that
the port imports nothing of the JAX package. For a seed it gives
array-identical designs (``tests/test_torch_graph.py`` holds it to
that). :func:`with_prior_net_drivers`, which the JAX package lacks,
moves some net drivers below their pair's cell level, so that the walk's
prior-row path runs. Builds a complete parsed-design dict (the array layout of
``prtp_tpu.data.features.extract_features``) directly, without writing
netlist/report text — graph *scale* matters here more than parser
fidelity.
"""

from __future__ import annotations

import numpy as np


def make_random_design(level_sizes, cell_feat_dim=36, net_feat_dim=3,
                       num_paths=None, avg_in=2.5, map_size=128,
                       cnn_channels=2, cnn_hw=512, mask_nnz_per_path=64,
                       seed=0):
    """Random leveled pin-DAG with labels, masks and a CNN raster.

    Even levels are cell levels, odd are net levels; every non-PI node
    gets 1..ceil(2*avg_in) in-edges from strictly lower levels (net
    levels: exactly 1 driver, like real netlists). Endpoints are drawn
    from the last two odd levels.
    """
    rng = np.random.default_rng(seed)
    node_ids = []
    n = 0
    for s in level_sizes:
        node_ids.append(np.arange(n, n + s, dtype=np.int64))
        n += s
    levels = []
    cell_src, cell_dst = [], []
    net_src, net_dst = [], []
    for li, ids in enumerate(node_ids):
        levels.append((ids, np.zeros(0, np.int64), np.zeros(0, np.int64)))
        if li == 0:
            continue
        lower = node_ids[li - 1]
        any_lower = np.concatenate(node_ids[:li])
        if li % 2 == 1:
            # net level: one driver from the previous (cell) level
            drv = rng.integers(0, len(lower), size=len(ids))
            net_src.extend(lower[drv])
            net_dst.extend(ids)
        else:
            # cell level: 1..k fanin edges from lower odd levels
            for v in ids:
                k = rng.integers(1, max(int(2 * avg_in), 2))
                srcs = rng.choice(any_lower, size=min(k, len(any_lower)),
                                  replace=False)
                cell_src.extend(srcs)
                cell_dst.extend([v] * len(srcs))

    # endpoints from the deepest odd levels
    odd_lvls = [li for li in range(len(level_sizes)) if li % 2 == 1]
    tail = odd_lvls[-2:] if len(odd_lvls) >= 2 else odd_lvls
    candidates = np.concatenate([node_ids[li] for li in tail])
    cand_level = np.concatenate(
        [np.full(len(node_ids[li]), li) for li in tail])
    if num_paths is None:
        num_paths = len(candidates)
    sel = rng.permutation(len(candidates))[:num_paths]
    endpoints = candidates[sel]
    ep_levels = cand_level[sel]

    # rewrite level target/path lists
    for li in np.unique(ep_levels):
        mask = ep_levels == li
        nodes, _t, _p = levels[li]
        levels[li] = (nodes, endpoints[mask],
                      np.nonzero(mask)[0].astype(np.int64))

    arrival = (5.0 + rng.normal(size=num_paths) * 0.8).astype(np.float32)
    slack = rng.normal(size=num_paths).astype(np.float32) * 0.6 + 0.4
    required = arrival + slack
    arrival_n = np.zeros(n, np.float32)
    required_n = np.zeros(n, np.float32)
    critical_n = np.zeros(n, np.int64)
    arrival_n[endpoints] = arrival
    required_n[endpoints] = required
    critical_n[endpoints] = (slack < 0).astype(np.int64)
    is_end = np.zeros(n, np.int64)
    is_end[endpoints] = 1

    rows = np.repeat(np.arange(num_paths), mask_nnz_per_path)
    cols = rng.integers(0, map_size * map_size,
                        size=num_paths * mask_nnz_per_path)

    return {
        "num_nodes": n,
        "num_ctypes": cell_feat_dim - 8,
        "num_paths": int(num_paths),
        "cell_feat": rng.normal(size=(n, cell_feat_dim)).astype(np.float32),
        "net_feat": np.abs(rng.normal(size=(n, net_feat_dim))).astype(
            np.float32),
        "is_start": np.zeros(n, np.int64),
        "is_end": is_end,
        "is_critical": critical_n,
        "arrival_time": arrival_n,
        "required_time": required_n,
        "levels": levels,
        "cell_edges": (np.array(cell_src, np.int64),
                       np.array(cell_dst, np.int64)),
        "net_edges": (np.array(net_src, np.int64),
                      np.array(net_dst, np.int64)),
        "path2level": ep_levels.astype(np.int64),
        "path_level": ep_levels.astype(np.float32),
        "path_endpoint": endpoints,
        "critical_paths": np.nonzero(slack < 0)[0].astype(np.int64),
        "mask_coo": np.stack([rows, cols]),
        "cnn_input": rng.random((cnn_channels, cnn_hw, cnn_hw),
                                dtype=np.float32),
        "path_ids": list(range(int(num_paths))),
    }


def with_prior_net_drivers(parsed, share=0.1, seed=0):
    """A copy of ``parsed`` in which ``ceil(share * n)`` of the ``n`` net
    edges into each net level ``li >= 3``, drawn from a seeded numpy rng,
    take a new driver: a random node of a cell level below ``li - 1``.
    Those drivers lie before the pair's own cell level, so the packer
    routes them through the prior-row gather. Nothing else changes."""
    rng = np.random.default_rng(seed)
    levels = parsed["levels"]
    src = np.array(parsed["net_edges"][0], np.int64)
    dst = np.asarray(parsed["net_edges"][1], np.int64)
    level_of = np.full(int(parsed["num_nodes"]), -1, np.int64)
    for li, (ids, _t, _p) in enumerate(levels):
        level_of[np.asarray(ids, np.int64)] = li
    dst_level = level_of[dst]
    for li in range(3, len(levels), 2):
        edges = np.nonzero(dst_level == li)[0]
        n_move = int(np.ceil(share * len(edges)))
        if n_move == 0:
            continue
        moved = rng.choice(edges, size=n_move, replace=False)
        earlier = np.concatenate([np.asarray(levels[c][0], np.int64)
                                  for c in range(0, li - 1, 2)])
        src[moved] = earlier[rng.integers(0, len(earlier), size=n_move)]
    out = dict(parsed)
    out["net_edges"] = (src, dst.copy())
    return out


def bench_level_sizes(num_nodes=60_000, num_levels=24, decay=0.9):
    """Geometric level-size profile mimicking real netlists (huge early
    levels, thin deep levels)."""
    w = decay ** np.arange(num_levels)
    sizes = np.maximum((w / w.sum() * num_nodes).astype(int), 8)
    return [int(s) for s in sizes]
