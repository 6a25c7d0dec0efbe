"""What the wrappers hand their CUDA kernels, checked without a card:
each launcher takes the arguments its wrapper passes, of the types it
passes. (The kernels themselves are held against their plain versions
on the card, by chip_smoke.py.)"""

import ctypes
import re

import pytest

from prtp_tpu_torch.ops import _build, adam, fused_gnn, gather, segment_kernels

C_TYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int,
           "float": ctypes.c_float}
# each launcher's ctypes argument list, as its wrapper passes it
ARGTYPES = {
    "gather_rows": gather._ARGTYPES,
    "softmax_sum": fused_gnn._SOFTMAX_ARGTYPES,
    "local_mean": fused_gnn._MEAN_ARGTYPES,
    "softmax_sum_bwd": fused_gnn._SOFTMAX_BWD_ARGTYPES,
    "mailbox_scatter": fused_gnn._SCATTER_ARGTYPES,
    "flat_adam": adam._ARGTYPES,
    "attn_sum": fused_gnn._ATTN_ARGTYPES,
    "attn_bwd": fused_gnn._ATTN_BWD_ARGTYPES,
    "segment_softmax_sum": segment_kernels._SOFTMAX_ARGTYPES,
    "segment_mean": segment_kernels._MEAN_ARGTYPES,
    "segment_softmax_sum_bwd": segment_kernels._SOFTMAX_BWD_ARGTYPES,
    "segment_attn_sum": segment_kernels._ATTN_ARGTYPES,
    "segment_attn_bwd": segment_kernels._ATTN_BWD_ARGTYPES,
}
# launchers beyond <name>_launch, by library: (entry, argument list)
MORE = {"segment_mean": [("net_update", segment_kernels._UPDATE_ARGTYPES)],
        "segment_attn_bwd": [("segment_dw_reduce",
                              segment_kernels._DW_REDUCE_ARGTYPES),
                             ("segment_attn_bwd_grid",
                              segment_kernels._ATTN_GRID_ARGTYPES)]}
LAUNCHERS = ([(name, name, ARGTYPES[name]) for name in _build.KERNEL_NAMES]
             + [(name, entry, types) for name, more in MORE.items()
                for entry, types in more])


def _exported(name):
    """``{entry: [parameter, ...]}`` of every launcher in csrc/<name>.cu."""
    src = (_build.SRC_DIR / f"{name}.cu").read_text()
    return {entry: [p.split() for p in params.split(",") if p.strip()]
            for entry, params in re.findall(
                r"PRTP_EXPORT int (\w+)_launch\(([^)]*)\)", src)}


@pytest.mark.parametrize("name,entry,argtypes", LAUNCHERS,
                         ids=[entry for _n, entry, _t in LAUNCHERS])
def test_each_launcher_takes_what_its_wrapper_passes(name, entry, argtypes):
    """ctypes passes the wrapper's list as it is: a launcher with another
    number of parameters, or another type at a place, would read garbage
    there. Every launcher a source exports is listed."""
    exported = _exported(name)
    assert sorted(exported) == sorted(
        [name] + [e for e, _t in MORE.get(name, [])])
    want = [ctypes.c_void_p if "*" in " ".join(p) else C_TYPES[p[0]]
            for p in exported[entry]]
    assert want == argtypes
