"""The port's random designs and exact-levels packing match prtp_tpu's
array for array."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.data import random_design as jax_rd
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.graph import pack_leveled_graph_exact as jax_pack_exact
from prtp_tpu_torch.data import random_design as port_rd
from prtp_tpu_torch.graph import pack_design, pack_leveled_graph_exact

from helpers import make_random_leveled_graph

import _torch_threads  # noqa: F401  (one torch thread a worker)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")

TABLES = ("cell_feat_lvl", "net_feat_lvl", "cell_mail", "net_mail",
          "cell_rev_pos", "cell_rev_rows", "net_rev_pos", "net_rev_rows",
          "merged_pos", "merged_seg", "merged_rows", "intra_pos",
          "intra_slot", "gather_rows", "net_local_idx")


def golden_parsed(map_size=16):
    """The committed raw fixture design, parsed by the JAX package's
    host pipeline (as tests/test_reference_parity.py does)."""
    from prtp_tpu.data.features import extract_features
    from prtp_tpu.data.generate import load_libs, resolve_top_module
    from prtp_tpu.data.netlist import NetlistBuilder

    design = os.path.join(FIXTURES, "golden_design")
    cell_info_map, cell_info_map2, early_lib, ctype2id = load_libs(FIXTURES)
    builder = NetlistBuilder(
        resolve_top_module(FIXTURES, "golden_design"), "critical",
        cell_info_map=cell_info_map2, cell_lib=early_lib, map_size=map_size)
    out = extract_features(builder.parse(design), cell_info_map, ctype2id)
    with open(os.path.join(design, "features/datas.pkl"), "rb") as f:
        out["cnn_input"] = np.asarray(pickle.load(f), np.float32)
    return out


def _random_parsed(seed=3):
    sizes = port_rd.bench_level_sizes(600, 9, decay=0.8)
    return port_rd.make_random_design(sizes, map_size=16, cnn_hw=32,
                                      mask_nnz_per_path=12, seed=seed)


def _assert_same_design(parsed_a, parsed_b):
    assert parsed_a.keys() == parsed_b.keys()
    for key in parsed_a:
        a, b = parsed_a[key], parsed_b[key]
        if key == "levels":
            assert len(a) == len(b)
            for la, lb in zip(a, b):
                for xa, xb in zip(la, lb):
                    np.testing.assert_array_equal(xa, xb)
        elif isinstance(a, tuple):
            for xa, xb in zip(a, b):
                np.testing.assert_array_equal(xa, xb)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype, key


@pytest.mark.parametrize("seed,nodes,levels", [(0, 300, 6), (7, 900, 11)])
def test_random_design_is_array_identical(seed, nodes, levels):
    sizes = port_rd.bench_level_sizes(nodes, levels, decay=0.8)
    assert sizes == jax_rd.bench_level_sizes(nodes, levels, decay=0.8)
    kw = dict(cell_feat_dim=36, net_feat_dim=3, map_size=16, cnn_hw=32,
              mask_nnz_per_path=8, seed=seed)
    _assert_same_design(port_rd.make_random_design(sizes, **kw),
                        jax_rd.make_random_design(sizes, **kw))


@pytest.mark.parametrize("which", ["golden", "random"])
def test_exact_pack_matches_jax(which):
    parsed = golden_parsed() if which == "golden" else _random_parsed()
    ours = pack_design(parsed, map_size=16, device="cpu")
    ref = jax_pack_design(parsed, map_size=16, exact_levels=True,
                          cnn_patches=False)
    g, rg = ours.graph, ref.graph
    assert g.num_pairs == rg.num_pairs and g.num_rows == rg.num_rows
    assert g.cell_off == tuple(rg.cell_off)
    assert g.net_off == tuple(rg.net_off)
    for name in TABLES:
        ours_t, ref_t = getattr(g, name), getattr(rg, name)
        assert len(ours_t) == len(ref_t) == g.num_pairs, name
        for k, (a, b) in enumerate(zip(ours_t, ref_t)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype, (name, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}[{k}]")
    for name in ("arrival_time", "required_time", "is_critical",
                 "path_endpoint", "path_level", "path_masks"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the raster stays NCHW in the port; the JAX pack holds NHWC
    np.testing.assert_array_equal(
        ours.cnn_input.numpy(),
        np.asarray(ref.cnn_input).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("which", ["golden", "random"])
def test_local_index_validity_is_net_mail_validity(which):
    """local_mean's ``idx < num_valid`` selects exactly the slots with
    ``net_mail != num_rows`` (the JAX walk's validity)."""
    parsed = golden_parsed() if which == "golden" else _random_parsed(5)
    g = pack_design(parsed, map_size=16, device="cpu").graph
    for k in range(g.num_pairs):
        pn_c, md_c = g.cell_mail[k].shape
        num_valid = pn_c + g.gather_rows[k].shape[0] - pn_c * md_c
        np.testing.assert_array_equal(
            (g.net_local_idx[k] < num_valid).numpy(),
            (g.net_mail[k] != g.num_rows).numpy())
        assert int(g.net_local_idx[k].max()) <= num_valid


def test_with_prior_net_drivers_moves_a_share_below_the_pair():
    parsed = _random_parsed(seed=2)
    moved = port_rd.with_prior_net_drivers(parsed, share=0.1, seed=4)
    level_of = np.empty(parsed["num_nodes"], np.int64)
    for li, (ids, _t, _p) in enumerate(parsed["levels"]):
        level_of[ids] = li
    (src0, dst0), (src1, dst1) = parsed["net_edges"], moved["net_edges"]
    np.testing.assert_array_equal(dst0, dst1)
    changed = src0 != src1
    for li in range(1, len(parsed["levels"]), 2):
        at = level_of[dst0] == li
        assert changed[at].sum() <= np.ceil(0.1 * at.sum())
        if li >= 3:
            assert changed[at].sum() >= 0.05 * at.sum() > 0
        else:
            assert not changed[at].any()
    lv = level_of[src1[changed]]
    assert (lv % 2 == 0).all()
    assert (lv < level_of[dst1[changed]] - 1).all()
    for key in parsed:  # nothing else changes
        if key != "net_edges":
            assert moved[key] is parsed[key]
    g = pack_design(moved, map_size=16, device="cpu").graph
    # every pair past the first whose net level exists gathers prior rows
    assert all(g.gather_rows[k].numel() > g.cell_mail[k].numel()
               for k in range(1, len(parsed["levels"]) // 2))


def test_pack_refuses_merged_rasters():
    """A stack of K rasters (a merged super-graph's, ``--merge_designs``)
    packs as ``(K, C, H, W)``; a raster of any other rank, such as a
    stack of stacks or a single channel, is refused."""
    parsed = _random_parsed()
    raster = parsed["cnn_input"]
    parsed["cnn_input"] = np.stack([raster] * 2)
    design = pack_design(parsed, map_size=16, device="cpu")
    assert design.cnn_input.shape == (2,) + raster.shape
    for bad in (np.stack([np.stack([raster] * 2)] * 2), raster[0]):
        parsed["cnn_input"] = bad
        with pytest.raises(ValueError, match="cnn_input"):
            pack_design(parsed, map_size=16, device="cpu")


@pytest.mark.parametrize("which", ["golden", "leveled"])
def test_net_cnt_matches_jax_backward_count(which):
    """The packer's ``net_cnt`` is the divisor JAX's walk backward
    computes per pair, ``maximum(validn.sum(axis=1), 1)`` on the net
    mailbox of the JAX-packed graph: the golden fixture, and a
    ``make_random_leveled_graph`` graph whose net sources come from any
    lower level."""
    if which == "golden":
        parsed = golden_parsed()
        g = pack_design(parsed, map_size=16, device="cpu").graph
        ref = jax_pack_design(parsed, map_size=16, exact_levels=True,
                              cnn_patches=False).graph
    else:
        parsed = make_random_leveled_graph(
            np.random.default_rng(8), level_sizes=(6, 8, 7, 9, 5, 6, 4),
            cell_feat_dim=12, max_in=3)
        g = pack_leveled_graph_exact(parsed, device="cpu")[0]
        ref = jax_pack_exact(parsed)[0]
    assert len(g.net_cnt) == g.num_pairs == ref.num_pairs
    for k in range(g.num_pairs):
        validn = (jnp.asarray(ref.net_mail[k]) != ref.num_rows)[..., None]
        want = jnp.maximum(validn.sum(axis=1).astype(jnp.float32), 1.0)[:, 0]
        assert g.net_cnt[k].dtype == torch.float32
        np.testing.assert_array_equal(g.net_cnt[k].numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["golden", "random", "prior_rows"])
def test_scatter_csr_tables_match_the_segment_ids(which):
    """The port-only CSR tables of the backward's two scatters hold the
    packer's segments: ``merged_seg_off`` spans each ``merged_seg`` run,
    ``intra_rows``/``intra_seg_off`` are the runs of the sorted
    ``intra_slot``."""
    parsed = golden_parsed() if which == "golden" else _random_parsed(6)
    if which == "prior_rows":
        parsed = port_rd.with_prior_net_drivers(parsed, share=0.2, seed=2)
    g = pack_design(parsed, map_size=16, device="cpu").graph
    for k in range(g.num_pairs):
        off = g.merged_seg_off[k].numpy()
        seg = np.repeat(np.arange(len(off) - 1), np.diff(off))
        assert off.dtype == np.int32 and len(off) == g.merged_rows[k].numel() + 1
        np.testing.assert_array_equal(seg, g.merged_seg[k].numpy())
        slot = g.intra_slot[k].numpy()
        rows, ioff = g.intra_rows[k].numpy(), g.intra_seg_off[k].numpy()
        np.testing.assert_array_equal(rows, np.unique(slot))
        np.testing.assert_array_equal(np.repeat(rows, np.diff(ioff)), slot)
        assert ioff[0] == 0 and ioff[-1] == len(slot)
