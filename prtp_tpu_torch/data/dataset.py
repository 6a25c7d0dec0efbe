"""ParsedDesign serialization + training-time loading.

A copy of ``prtp_tpu/data/dataset.py``, kept in the port
so that the port imports nothing of the JAX package.

Replaces the reference's ``th.save`` 7-tuple pickles
(``src/generate_data.py:50-54``) with ``.npz`` archives (no pickled
code objects), and re-provides the loader semantics of
``load_single_design`` (``src/train.py:335-388``):

- ``feat_reduce`` trailing-column truncation of cell/net features
  (``:344-348``),
- optional min-max normalization from column ``num_ctypes`` on
  (``:350-352``; the net_feat call is a no-op by construction — see
  MODEL_NOTES.md #6),
- persistent per-design val/test splits: 1/5 of critical and 1/5 of
  non-critical paths go to val (``split_dataset``, ``:294-304``), stored
  as JSON instead of pickle,
- critical-path oversampling by ``os_rate`` when negatives outnumber
  positives by more than 2x (``:377-380``).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List

import numpy as np


def save_design_npz(path: str, parsed: dict, cnn_input: np.ndarray):
    """Serialize a ParsedDesign dict (features.extract_features output)."""
    levels = parsed["levels"]
    lvl_nodes = np.concatenate([l[0] for l in levels]) if levels else np.zeros(0, np.int64)
    lvl_targets = np.concatenate([l[1] for l in levels]) if levels else np.zeros(0, np.int64)
    lvl_paths = np.concatenate([l[2] for l in levels]) if levels else np.zeros(0, np.int64)
    node_off = np.cumsum([0] + [len(l[0]) for l in levels])
    tgt_off = np.cumsum([0] + [len(l[1]) for l in levels])
    np.savez_compressed(
        path,
        num_nodes=parsed["num_nodes"],
        num_ctypes=parsed["num_ctypes"],
        num_paths=parsed["num_paths"],
        cell_feat=parsed["cell_feat"],
        net_feat=parsed["net_feat"],
        is_start=parsed["is_start"],
        is_end=parsed["is_end"],
        is_critical=parsed["is_critical"],
        arrival_time=parsed["arrival_time"],
        required_time=parsed["required_time"],
        cell_src=parsed["cell_edges"][0],
        cell_dst=parsed["cell_edges"][1],
        net_src=parsed["net_edges"][0],
        net_dst=parsed["net_edges"][1],
        lvl_nodes=lvl_nodes,
        lvl_targets=lvl_targets,
        lvl_paths=lvl_paths,
        node_off=node_off,
        tgt_off=tgt_off,
        path2level=parsed["path2level"],
        path_endpoint=parsed["path_endpoint"],
        critical_paths=parsed["critical_paths"],
        mask_coo=parsed["mask_coo"],
        cnn_input=cnn_input,
    )


def load_design_npz(path: str) -> dict:
    z = np.load(path)
    node_off = z["node_off"]
    tgt_off = z["tgt_off"]
    levels = []
    for i in range(len(node_off) - 1):
        levels.append((
            z["lvl_nodes"][node_off[i]: node_off[i + 1]],
            z["lvl_targets"][tgt_off[i]: tgt_off[i + 1]],
            z["lvl_paths"][tgt_off[i]: tgt_off[i + 1]],
        ))
    return {
        "num_nodes": int(z["num_nodes"]),
        "num_ctypes": int(z["num_ctypes"]),
        "num_paths": int(z["num_paths"]),
        "cell_feat": z["cell_feat"],
        "net_feat": z["net_feat"],
        "is_start": z["is_start"],
        "is_end": z["is_end"],
        "is_critical": z["is_critical"],
        "arrival_time": z["arrival_time"],
        "required_time": z["required_time"],
        "cell_edges": (z["cell_src"], z["cell_dst"]),
        "net_edges": (z["net_src"], z["net_dst"]),
        "levels": levels,
        "path2level": z["path2level"],
        "path_level": z["path2level"].astype(np.float32),
        "path_endpoint": z["path_endpoint"],
        "critical_paths": z["critical_paths"],
        "mask_coo": z["mask_coo"],
        "cnn_input": z["cnn_input"],
    }


def load_design_shapes(path: str) -> dict:
    """The subset of :func:`load_design_npz` that graph.bucket_shape
    reads (level tables, edge dst ids, counts) — an NpzFile decompresses
    per key, so skipping the rasters/features/masks makes the startup
    bucket pass cheap instead of a second full corpus read (the full
    arrays are loaded once, later, by the DesignCache loader)."""
    z = np.load(path)
    node_off = z["node_off"]
    lvl_nodes = z["lvl_nodes"]
    levels = []
    for i in range(len(node_off) - 1):
        # targets/paths (slots 1-2) are unused by bucket_shape
        levels.append((lvl_nodes[node_off[i]: node_off[i + 1]],
                       None, None))
    return {
        # marker asserted by graph.pack_design: this dict is for
        # bucket_shape ONLY (src ids / features / rasters are None
        # placeholders that would fail opaquely in the full pipeline)
        "shapes_only": True,
        "num_nodes": int(z["num_nodes"]),
        "num_paths": int(z["num_paths"]),
        "cell_edges": (None, z["cell_dst"]),
        "net_edges": (None, z["net_dst"]),
        "levels": levels,
    }


def get_design_list(data_path: str, usage: str) -> List[str]:
    """Read {train,test}data_list.txt (reference src/train.py:321-333)."""
    assert usage in ("train", "test"), \
        "Wrong data usage! Should be either 'train' or 'test'."
    design_list_file = os.path.join(data_path, f"{usage}data_list.txt")
    assert os.path.exists(design_list_file), \
        f"Can not find the traindata list txt '{design_list_file}'"
    with open(design_list_file) as f:
        return [l.strip() for l in f if l.strip()]


def min_max_norm(feature: np.ndarray, start_idx: int) -> np.ndarray:
    """Per-column min-max normalization from start_idx on
    (reference src/train.py:309-318)."""
    feature = feature.copy()
    for i in range(start_idx, feature.shape[1]):
        col = feature[:, i]
        lo, hi = col.min(), col.max()
        denom = hi - lo
        if denom == 0:
            denom = 1.0
        feature[:, i] = (col - lo) / denom
    return feature


def split_dataset(paths, critical_paths, rng=None):
    """First 1/5 of shuffled criticals + 1/5 of shuffled non-criticals go
    to val; the rest to test (reference src/train.py:294-304)."""
    rng = rng or random
    critical_paths = list(critical_paths)
    non_critical = list(set(paths) - set(critical_paths))
    rng.shuffle(critical_paths)
    val = critical_paths[: len(critical_paths) // 5]
    test = critical_paths[len(critical_paths) // 5:]
    rng.shuffle(non_critical)
    val.extend(non_critical[: len(non_critical) // 5])
    test.extend(non_critical[len(non_critical) // 5:])
    return val, test


def load_single_design(usage: str, data_path: str, design: str,
                       os_rate: int = 1, feat_reduce=(6, 1),
                       if_norm: bool = False) -> Dict:
    """Load one design for train/val (reference src/train.py:335-388).

    Returns the parsed dict plus ``path_ids`` (the sampling universe,
    with oversampled criticals for train / the persisted val split for
    test usage).
    """
    parsed = load_design_npz(os.path.join(data_path, f"{design}.npz"))
    num_ctypes = parsed["num_ctypes"]
    if feat_reduce is not None:
        if feat_reduce[1] != 0:
            parsed["net_feat"] = parsed["net_feat"][:, : -feat_reduce[1]]
        if feat_reduce[0] != 0:
            parsed["cell_feat"] = parsed["cell_feat"][:, : -feat_reduce[0]]
    if if_norm:
        parsed["cell_feat"] = min_max_norm(parsed["cell_feat"], num_ctypes)
        # reference also calls norm(net_feat, num_ctypes) — a no-op since
        # net_feat has fewer than num_ctypes columns (MODEL_NOTES.md #6)

    paths = list(range(parsed["num_paths"]))
    critical = [int(p) for p in parsed["critical_paths"]]
    num_pos = max(len(critical), 1)
    num_neg = len(paths) - len(critical)
    ratio = num_neg / num_pos - 1

    if usage == "test":
        split_file = os.path.join(data_path, f"{design}_split.json")
        if os.path.exists(split_file):
            with open(split_file) as f:
                val_paths, test_paths = json.load(f)
        else:
            val_paths, test_paths = split_dataset(paths, critical)
            with open(split_file, "w") as f:
                json.dump([val_paths, test_paths], f)
        paths = list(val_paths)
    elif usage == "train" and os_rate != 0 and ratio > 1:
        for _ in range(os_rate):
            paths.extend(critical)

    parsed["path_ids"] = paths
    return parsed
