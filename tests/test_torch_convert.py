"""flax <-> torch weight conversion is exact, leaf by leaf, and fits the
port's PathModel."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu_torch.data.random_design import make_random_design
from prtp_tpu_torch.models import PathModel
from prtp_tpu_torch.utils.convert import params_from_flax, params_to_flax

SMALL_KW = dict(out_dim=16, hidden_dim=32, cnn_outdim=8, map_size=16,
                global_dim=8)


def small_parsed(seed=0):
    return make_random_design([6, 6, 5, 5, 4, 4], cell_feat_dim=10,
                              net_feat_dim=3, map_size=16, cnn_hw=64,
                              mask_nnz_per_path=10, seed=seed)


def jax_params(model, design, pids, init_seed=0, jitter_seed=7, scale=0.05):
    """A JAX init with every leaf jittered (biases included), so zero
    biases cannot hide a mismatch; returned as a numpy tree."""

    def init(design, pids):
        variables = model.init(jax.random.PRNGKey(init_seed), design, pids)
        leaves, treedef = jax.tree_util.tree_flatten(variables)
        keys = jax.random.split(jax.random.PRNGKey(jitter_seed), len(leaves))
        return jax.tree_util.tree_unflatten(
            treedef, [l + scale * jax.random.normal(k, l.shape, l.dtype)
                      for l, k in zip(leaves, keys)])

    return jax.tree_util.tree_map(np.asarray, jax.jit(init)(design, pids))


def golden_variables(parsed, pack_map_size, **model_kw):
    """The weights tests/test_variant_goldens.py's ``_build`` makes for a
    golden output (its init and jitter seeds and scale, on its padded
    pack) by :func:`jax_params` under ``jax.jit``: eager, the model's
    init alone takes seconds. As a numpy tree."""
    design = jax_pack_design(parsed, map_size=pack_map_size, align=8,
                             cnn_patches=False)
    return jax_params(JaxPathModel(**model_kw), design,
                      jnp.arange(design.num_paths, dtype=jnp.int32))


@functools.lru_cache(maxsize=None)  # read-only trees, shared by tests
def _flax_tree(use_gnn, use_cnn):
    parsed = small_parsed()
    design = jax_pack_design(parsed, map_size=16, exact_levels=True,
                             cnn_patches=False)
    model = JaxPathModel(use_gnn=use_gnn, use_cnn=use_cnn, **SMALL_KW)
    pids = jnp.arange(design.num_paths, dtype=jnp.int32)
    return jax_params(model, design, pids)["params"]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("use_gnn,use_cnn",
                         [(True, True), (True, False), (False, True)])
def test_round_trip_is_exact_and_fits_the_port(use_gnn, use_cnn):
    tree = _flax_tree(use_gnn, use_cnn)
    state = params_from_flax(tree)
    port = PathModel(10, 3, use_gnn=use_gnn, use_cnn=use_cnn, **SMALL_KW)
    want = port.state_dict()
    assert sorted(state) == sorted(want)
    for key, val in state.items():
        assert val.shape == want[key].shape, key
        assert val.dtype == torch.float32 and val.is_contiguous(), key
    port.load_state_dict(state, strict=True)

    back = dict(_leaves(params_to_flax(port.state_dict())))
    orig = dict(_leaves(tree))
    assert sorted(back) == sorted(orig)
    for key, val in orig.items():
        assert back[key].shape == val.shape, key
        np.testing.assert_array_equal(back[key], val, err_msg=key)


def test_layouts_are_transposed_as_documented():
    tree = _flax_tree(True, True)
    state = params_from_flax(tree)
    k = tree["gnn"]["pair_step"]["fc_cell_self"]["fc0"]["kernel"]
    np.testing.assert_array_equal(
        state["gnn.fc_cell_self.fc0.weight"].numpy(), k.T)
    conv = tree["cnn"]["Conv_1"]["kernel"]  # HWIO
    w = state["cnn.Conv_1.weight"].numpy()  # OIHW
    assert w.shape == (conv.shape[3], conv.shape[2], conv.shape[0],
                       conv.shape[1])
    np.testing.assert_array_equal(w[5, 3, 1, 2], conv[1, 2, 3, 5])
    np.testing.assert_array_equal(state["fcn_kernel"].numpy(),
                                  tree["fcn_kernel"])
