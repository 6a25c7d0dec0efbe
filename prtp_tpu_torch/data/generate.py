"""Offline dataset-generation CLI.

A copy of ``prtp_tpu/data/generate.py``, kept in the port
so that the port imports nothing of the JAX package.

Parity with the reference ``src/generate_data.py``: iterates the design
directories under ``--rawdata_path``, maps design -> top module (the
reference's hardcoded ``top_map``, :7-23, extended by a per-design
``top.txt`` fallback), skips non-design entries and already-parsed
designs, loads the CNN input maps from ``features/datas.pkl`` and writes
one ``{design}.npz`` per design to ``--data_save_path``.

Usage:
    python -m prtp_tpu_torch.data.generate --rawdata_path ... \
        --data_save_path ...
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from ..options import get_options
from .dataset import save_design_npz
from .features import extract_features
from .netlist import NetlistBuilder

# reference design -> top module map (src/generate_data.py:7-23)
TOP_MAP = {
    "darkriscv": "darkriscv",
    "sha3": "ChipTop",
    "smallboom": "BoomCore",
    "rocket": "ChipTop",
    "xgate": "xgate_top",
    "ae18": "ae18_core",
    "or1200": "or1200_top",
    "hwacha": "Hwacha",
    "steelcore": "steel_core_top",
    "tinyrocket": "ChipTop",
    "chacha": "chacha",
    "arm9": "arm9_compatiable_code",
    "r8051": "r8051",
    "jpeg": "jpeg_top",
}

# non-design entries skipped by the reference (src/generate_data.py:36)
SKIP_ENTRIES = {"util.py", "late_lib.json", "early_lib.json", "README.txt",
                "def", "run.sh", "ae18", "steel-core",
                "cell_info_map.json", "cell_info_map2.json", "ctype2id.json"}


def resolve_top_module(rawdata_path: str, design: str):
    # a design's own top.txt wins over the name-keyed TOP_MAP: the
    # local file describes THIS netlist (a synthetic corpus may reuse a
    # reference design name with its own top module). Real ASAP7 raw
    # dirs ship no top.txt, so reference behavior is unchanged there.
    top_txt = os.path.join(rawdata_path, design, "top.txt")
    if os.path.exists(top_txt):
        with open(top_txt) as f:
            return f.read().strip()
    if design in TOP_MAP:
        return TOP_MAP[design]
    return design


def load_libs(rawdata_path: str):
    with open(os.path.join(rawdata_path, "cell_info_map2.json")) as f:
        cell_info_map2 = json.load(f)
    with open(os.path.join(rawdata_path, "cell_info_map.json")) as f:
        cell_info_map = json.load(f)
    with open(os.path.join(rawdata_path, "early_lib.json")) as f:
        early_lib = json.load(f)
    with open(os.path.join(rawdata_path, "ctype2id.json")) as f:
        ctype2id = json.load(f)
    return cell_info_map, cell_info_map2, early_lib, ctype2id


def generate_one(rawdata_path: str, design: str, data_save_path: str,
                 masking: str = "critical", map_size: int = 128) -> str:
    """Parse one raw design and write {design}.npz; returns the path."""
    cell_info_map, cell_info_map2, early_lib, ctype2id = load_libs(
        rawdata_path)
    design_dir = os.path.join(rawdata_path, design)
    top_module = resolve_top_module(rawdata_path, design)
    builder = NetlistBuilder(top_module, masking,
                             cell_info_map=cell_info_map2,
                             cell_lib=early_lib, map_size=map_size)
    result = builder.parse(design_dir)
    parsed = extract_features(result, cell_info_map, ctype2id)
    with open(os.path.join(design_dir, "features/datas.pkl"), "rb") as f:
        cnn_input = pickle.load(f)
    cnn_input = np.asarray(cnn_input, dtype=np.float32)
    out = os.path.join(data_save_path, f"{design}.npz")
    save_design_npz(out, parsed, cnn_input)
    return out


def main(argv=None):
    options = get_options(argv)
    rawdata_path = options.rawdata_path
    data_save_path = options.data_save_path
    os.makedirs(data_save_path, exist_ok=True)
    todo = []
    for design in sorted(os.listdir(rawdata_path)):
        if design in SKIP_ENTRIES or design.endswith(".json"):
            continue
        if options.design and design != options.design:
            continue
        if not os.path.isdir(os.path.join(rawdata_path, design)):
            continue
        out = os.path.join(data_save_path, f"{design}.npz")
        if os.path.exists(out):
            print(f"Design {design} already parsed! Skip")
            continue
        todo.append(design)

    workers = min(getattr(options, "preprocess_workers", 1), len(todo)) \
        if todo else 0
    done = []
    if workers > 1:
        # designs are independent — parse in parallel processes (the
        # reference preprocesses serially, src/generate_data.py:34)
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(workers) as pool:
            args = [(rawdata_path, d, data_save_path, options.masking,
                     options.map_size) for d in todo]
            for d, _ in zip(todo, pool.starmap(generate_one, args)):
                print(f"-------- Parsed design: {d}")
                done.append(d)
    else:
        for design in todo:
            print(f"-------- Parsing design: {design}...")
            generate_one(rawdata_path, design, data_save_path,
                         options.masking, map_size=options.map_size)
            done.append(design)
    # default design lists if absent: all designs train + test
    all_designs = [d[:-4] for d in sorted(os.listdir(data_save_path))
                   if d.endswith(".npz")]
    for usage in ("train", "test"):
        lst = os.path.join(data_save_path, f"{usage}data_list.txt")
        if not os.path.exists(lst):
            with open(lst, "w") as f:
                f.write("\n".join(all_designs) + "\n")
    print(f"parsed {len(done)} designs -> {data_save_path}")


if __name__ == "__main__":
    main()
