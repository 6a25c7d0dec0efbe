"""Graph -> feature/label arrays.

A copy of ``prtp_tpu/data/features.py``, kept in the port
so that the port imports nothing of the JAX package.

Capability parity with the reference ``parse_single_file``
(``src/dataset.py:48-299``), emitting plain numpy arrays instead of a
DGL heterograph:

- ``cell_feat`` (N, num_ctypes+8): one-hot abstract cell type followed
  by [load, max_cap, trans, delay, total_outputcap, area, width,
  height], filled on the destination pins of cell edges
  (``dataset.py:203-247``) and on non-'PI' PI nodes (``:146-177``),
  with the per-cell / per-ctype minimum trans/delay fallbacks
  (``:179-192,231-239``), the SRAM empty-max-cap default 46.08
  (``:161-163,218-219``) and the ICG/DHL/DLL trans=4/delay=0 special
  case (``:166-171,227-229``).
- ``net_feat`` (N, 3): [|dx|, |dy|, sink pin capacitance] on the sink
  pins of net edges, with the '13.0' empty-capacitance default
  (``:249-267``).
- labels: is_start/is_end/is_critical/arrival/required per node
  (``:88-122``; asserts critical => negative slack at ``:121``).
- ``levels`` with integer node ids, ``path2level``, ``path2endpoint``,
  ``critical_paths`` (``:115,123-131``).

The ctype one-hot width always includes the appended ``SRAM`` type
(``dataset.py:20`` — resolving reference inconsistency #7, see
MODEL_NOTES.md).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def build_ctype2id(ctype2id: Dict[str, int]) -> Dict[str, int]:
    out = dict(ctype2id)
    if "SRAM" not in out:
        out["SRAM"] = len(out)
    return out


def extract_features(parse_result: dict, cell_info_map: dict,
                     ctype2id: Dict[str, int]) -> dict:
    """Build the ParsedDesign arrays from a NetlistBuilder parse result."""
    ctype2id = build_ctype2id(ctype2id)
    num_ctypes = len(ctype2id)

    node_attrs = parse_result["node_attrs"]
    edges = parse_result["edges"]
    timing_paths = parse_result["timing_paths"]
    pin2outcap = parse_result["pin2outcap"]
    pin2delay = parse_result["pin2delay"]
    pin2trans = parse_result["pin2trans"]
    pis = parse_result["PIs"]
    topo_levels = parse_result["topo_levels"]

    node2id = {nd: i for i, nd in enumerate(node_attrs)}
    n = len(node2id)

    is_start = np.zeros(n, np.int64)
    is_end = np.zeros(n, np.int64)
    is_critical = np.zeros(n, np.int64)
    arrival = np.zeros(n, np.float32)
    required = np.zeros(n, np.float32)
    cell_feat = np.zeros((n, num_ctypes + 8), np.float32)
    net_feat = np.zeros((n, 3), np.float32)

    critical_paths = []
    path2endpoint = np.zeros(len(timing_paths), np.int64)
    for i, info in enumerate(timing_paths):
        is_start[node2id[info.start]] = 1
        is_end[node2id[info.end]] = 1
        path2endpoint[i] = node2id[info.end]
        arrival[node2id[info.end]] = info.arrival_time
        required[node2id[info.end]] = info.required_time
        if info.is_critical:
            is_critical[node2id[info.end]] = 1
            slack = info.required_time - info.arrival_time
            assert slack < 0, "critical path with positive slack!"
            critical_paths.append(i)

    levels = []
    path2level = np.zeros(len(timing_paths), np.int64)
    for li, (lvl_nodes, targets, path_ids) in enumerate(topo_levels):
        levels.append((
            np.array([node2id[nd] for nd in lvl_nodes], np.int64),
            np.array([node2id[nd] for nd in targets], np.int64),
            np.array(path_ids, np.int64),
        ))
        for pid in path_ids:
            path2level[pid] = li

    def fill_cell_feat(pin, trans, delay):
        cell_name = node_attrs[pin]["cell_type"]
        info = cell_info_map[cell_name]
        port_info = info["pin_info"][node_attrs[pin]["port"]]
        nid = node2id[pin]
        type_id = ctype2id[info["type"]]
        cell_feat[nid][type_id] = 1
        cell_feat[nid][num_ctypes] = info["load"]
        cap = port_info["max_capacitance"]
        if cell_name.startswith("SRAM") and cap == "":
            cap = "46.08"
        cell_feat[nid][num_ctypes + 1] = float(cap)
        cell_feat[nid][num_ctypes + 2] = trans
        cell_feat[nid][num_ctypes + 3] = delay
        cell_feat[nid][num_ctypes + 4] = pin2outcap[pin]
        cell_feat[nid][num_ctypes + 5] = float(info["area"])
        cell_feat[nid][num_ctypes + 6] = float(info["width"])
        cell_feat[nid][num_ctypes + 7] = float(info["height"])

    # PI nodes that carry a real cell (reference dataset.py:146-177)
    for pi in pis:
        cell_name = node_attrs[pi]["cell_type"]
        if cell_name == "PI":
            continue
        if (cell_name.startswith(("ICG", "DHL", "DLL"))
                or (pin2trans.get(pi) is None and "/" not in pi)):
            trans, delay = 4, 0
        else:
            trans, delay = pin2trans[pi], pin2delay[pi]
        fill_cell_feat(pi, trans, delay)

    # per-cell / per-ctype minimum trans/delay fallbacks (ref :179-192)
    cell2trans, cell2delay = {}, {}
    ctype2trans, ctype2delay = {}, {}
    for src, dst, etype in edges:
        if etype == "net":
            continue
        if pin2trans.get(dst) is not None:
            cell_name = node_attrs[dst]["cell_type"]
            trans, delay = pin2trans[dst], pin2delay[dst]
            cell2trans[cell_name] = min(cell2trans.get(cell_name, trans), trans)
            cell2delay[cell_name] = min(cell2delay.get(cell_name, delay), delay)
            ctype = cell_info_map[cell_name]["type"]
            ctype2trans[ctype] = min(ctype2trans.get(ctype, trans), trans)
            ctype2delay[ctype] = min(ctype2delay.get(ctype, delay), delay)

    cell_src, cell_dst = [], []
    net_src, net_dst = [], []
    for src, dst, etype in edges:
        assert etype in ("cell", "net"), f"Wrong edge type: {etype}"
        if etype == "cell":
            cell_src.append(node2id[src])
            cell_dst.append(node2id[dst])
            cell_name = node_attrs[dst]["cell_type"]
            cell_type = cell_info_map[cell_name]["type"]
            if cell_name.startswith("ICG"):
                trans, delay = 4, 0
            elif pin2trans.get(dst) is None:
                trans = cell2trans.get(cell_name, ctype2trans.get(cell_type, 0))
                delay = cell2delay.get(cell_name, ctype2delay.get(cell_type, 0))
            else:
                trans, delay = pin2trans[dst], pin2delay[dst]
            fill_cell_feat(dst, trans, delay)
        else:
            net_src.append(node2id[src])
            net_dst.append(node2id[dst])
            nid = node2id[dst]
            p_dst = node_attrs[dst]["position"]
            p_src = node_attrs[src]["position"]
            net_feat[nid][0] = abs(p_dst[0] - p_src[0])
            net_feat[nid][1] = abs(p_dst[1] - p_src[1])
            dst_info = cell_info_map[node_attrs[dst]["cell_type"]]
            cap = dst_info["pin_info"][node_attrs[dst]["port"]]["capacitance"]
            cap = "13.0" if len(cap) == 0 else cap
            net_feat[nid][2] = float(cap)

    return {
        "num_nodes": n,
        "num_ctypes": num_ctypes,
        "cell_feat": cell_feat,
        "net_feat": net_feat,
        "is_start": is_start,
        "is_end": is_end,
        "is_critical": is_critical,
        "arrival_time": arrival,
        "required_time": required,
        "levels": levels,
        "cell_edges": (np.array(cell_src, np.int64), np.array(cell_dst, np.int64)),
        "net_edges": (np.array(net_src, np.int64), np.array(net_dst, np.int64)),
        "path2level": path2level,
        "path_level": path2level.astype(np.float32),
        "path_endpoint": path2endpoint,
        "critical_paths": np.array(critical_paths, np.int64),
        "mask_coo": parse_result["mask_coo"],
        "num_paths": parse_result["num_paths"],
        "node2id": node2id,
    }
