"""The port's level walk matches JAX ``_forward_impl`` at float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models.gnn import TimeGNN as JaxTimeGNN
from prtp_tpu.ops.fused_gnn import _forward_impl
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models import TimeGNN
from prtp_tpu_torch.ops import KERNELS
from prtp_tpu_torch.utils.convert import params_from_flax

from test_torch_convert import small_parsed

OUT, HID = 16, 32


def _jax_walk(parsed, dgl_parity, h0):
    """h_final of JAX ``_forward_impl`` with jittered init params."""
    design = jax_pack_design(parsed, map_size=16, exact_levels=True,
                             cnn_patches=False)
    g = design.graph
    model = JaxTimeGNN(out_dim=OUT, hidden_dim=HID, dgl_parity=dgl_parity)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), g)
    leaves, treedef = jax.tree_util.tree_flatten(v)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    v = jax.tree_util.tree_unflatten(
        treedef, [l + 0.1 * jax.random.normal(k, l.shape, l.dtype)
                  for l, k in zip(leaves, keys)])
    pp = v["params"]["pair_step"]
    params = {k: pp[k] for k in ("fc_cell_self", "fc_cell_neigh",
                                 "fc_net_self")}
    config = (g.num_rows, dgl_parity, tuple(g.cell_off), tuple(g.net_off))
    blocks = tuple(
        dict(cell_feat=g.cell_feat_lvl[k], net_feat=g.net_feat_lvl[k],
             cell_mail=g.cell_mail[k], net_mail=g.net_mail[k],
             gather_rows=g.gather_rows[k], net_local_idx=g.net_local_idx[k])
        for k in range(g.num_pairs))
    h = jax.jit(_forward_impl, static_argnums=0)(config, params,
                                                 jnp.asarray(h0), blocks)
    return np.asarray(h), jax.tree_util.tree_map(np.asarray, v["params"])


@pytest.mark.parametrize("h0_kind", ["zeros", "random"])
@pytest.mark.parametrize("dgl_parity", [True, False])
def test_walk_matches_jax_forward_impl(dgl_parity, h0_kind):
    parsed = small_parsed(seed=4)
    design = pack_design(parsed, map_size=16, device="cpu")
    n1 = design.graph.num_rows + 1
    rng = np.random.default_rng(2)
    h0 = (np.zeros((n1, OUT), np.float32) if h0_kind == "zeros"
          else rng.normal(size=(n1, OUT)).astype(np.float32))
    want, params = _jax_walk(parsed, dgl_parity, h0)

    gnn = TimeGNN(10, 3, torch.Generator().manual_seed(0), out_dim=OUT,
                  hidden_dim=HID, dgl_parity=dgl_parity)
    state = params_from_flax({"gnn": params})
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()})
    h0_t = torch.from_numpy(h0)
    with torch.no_grad():
        got = gnn(design.graph, h0_t if h0_kind == "random" else None)
    assert got.shape == (n1, OUT) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(h0_t.numpy(), h0)  # h0 left as it was
    assert [k.launches for k in KERNELS] == [0, 0, 0]


def test_dgl_parity_keeps_relu_old_for_empty_mailboxes():
    """A cell level whose nodes have no in-edges keeps relu(h0) under
    dgl_parity and takes the MLP value without it."""
    parsed = small_parsed(seed=4)
    design = pack_design(parsed, map_size=16, device="cpu")
    g = design.graph
    rng = np.random.default_rng(3)
    h0 = torch.from_numpy(rng.normal(
        size=(g.num_rows + 1, OUT)).astype(np.float32))
    rows = slice(g.cell_off[0], g.cell_off[0] + g.cell_mail[0].shape[0])
    assert bool((g.cell_mail[0] == g.num_rows).all())  # PIs: no in-edges
    out = {}
    for parity in (True, False):
        gnn = TimeGNN(10, 3, torch.Generator().manual_seed(1), out_dim=OUT,
                      hidden_dim=HID, dgl_parity=parity)
        with torch.no_grad():
            out[parity] = gnn(g, h0)
    torch.testing.assert_close(out[True][rows], torch.relu(h0[rows]),
                               rtol=0, atol=0)
    assert not torch.equal(out[False][rows], torch.relu(h0[rows]))
