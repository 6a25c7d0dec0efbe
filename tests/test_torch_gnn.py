"""The port's level walk matches JAX ``_forward_impl`` at float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.graph import pack_leveled_graph_exact as jax_pack_exact
from prtp_tpu.models.gnn import TimeGNN as JaxTimeGNN
from prtp_tpu.ops.fused_gnn import _forward_impl
from prtp_tpu_torch.data.random_design import with_prior_net_drivers
from prtp_tpu_torch.graph import pack_design, pack_leveled_graph_exact
from prtp_tpu_torch.models import TimeGNN
from prtp_tpu_torch.ops import KERNELS
from prtp_tpu_torch.utils.convert import params_from_flax

from helpers import make_random_leveled_graph
from test_torch_convert import small_parsed

import _torch_threads  # noqa: F401  (one torch thread a worker)

OUT, HID = 16, 32


def _jax_walk(g, dgl_parity, h0):
    """h_final of JAX ``_forward_impl`` on the JAX-packed graph ``g``,
    with jittered init params."""
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
    g = jax_pack_design(parsed, map_size=16, exact_levels=True,
                        cnn_patches=False).graph
    want, params = _jax_walk(g, dgl_parity, h0)
    _assert_port_walk_matches(design.graph, params, dgl_parity, h0, 10, want,
                              h0_kind == "random")


def _assert_port_walk_matches(graph, params, dgl_parity, h0, cell_feat_dim,
                              want, pass_h0=True):
    """The port's TimeGNN with the JAX ``params`` gives ``want`` on
    ``graph`` at 1e-5, leaves h0 as it was and launches no kernel."""
    gnn = TimeGNN(cell_feat_dim, 3, torch.Generator().manual_seed(0),
                  out_dim=OUT, hidden_dim=HID, dgl_parity=dgl_parity)
    state = params_from_flax({"gnn": params})
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()})
    h0_t = torch.from_numpy(h0)
    with torch.no_grad():
        got = gnn(graph, h0_t if pass_h0 else None)
    assert got.shape == h0.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(h0_t.numpy(), h0)  # h0 left as it was
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


@pytest.mark.parametrize("dgl_parity", [True, False])
def test_walk_matches_jax_with_prior_row_net_sources(dgl_parity):
    """Net drivers below the pair's own cell level (prior rows): the
    walk's prior-row gather and the prior slots of ``local_mean``,
    against ``_forward_impl`` on a graph whose edges come from any lower
    level, packed by both packers."""
    rng = np.random.default_rng(11)
    parsed = make_random_leveled_graph(rng, level_sizes=(6, 8, 7, 9, 5, 6, 4),
                                       cell_feat_dim=12, max_in=3)
    graph, _, num_rows = pack_leveled_graph_exact(parsed, device="cpu")
    g_jax, _, num_rows_jax = jax_pack_exact(parsed)
    assert num_rows == num_rows_jax
    assert any(graph.gather_rows[k].numel() > graph.cell_mail[k].numel()
               for k in range(graph.num_pairs))
    h0 = rng.normal(size=(num_rows + 1, OUT)).astype(np.float32)
    want, params = _jax_walk(g_jax, dgl_parity, h0)
    _assert_port_walk_matches(graph, params, dgl_parity, h0, 12, want)


@pytest.mark.parametrize("dgl_parity", [True, False])
def test_walk_matches_jax_on_a_design_with_prior_net_drivers(dgl_parity):
    """The design chip_smoke.py drives for the prior-row path, at a
    small size: every pair past the first gathers prior rows."""
    parsed = with_prior_net_drivers(small_parsed(seed=4), share=0.1, seed=1)
    design = pack_design(parsed, map_size=16, device="cpu")
    g = design.graph
    assert all(g.gather_rows[k].numel() > g.cell_mail[k].numel()
               for k in range(1, g.num_pairs))
    h0 = np.random.default_rng(6).normal(
        size=(g.num_rows + 1, OUT)).astype(np.float32)
    g_jax = jax_pack_design(parsed, map_size=16, exact_levels=True,
                            cnn_patches=False).graph
    want, params = _jax_walk(g_jax, dgl_parity, h0)
    _assert_port_walk_matches(g, params, dgl_parity, h0, 10, want)


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


# ---- the walk backward (ExactWalk) ----

def _grad_case(which):
    """(port graph, JAX graph, cell feature width) of a design without
    prior rows (``small_parsed``) or with them (a
    ``make_random_leveled_graph`` graph, edges from any lower level)."""
    if which == "no_prior":
        parsed = small_parsed(seed=4)
        graph = pack_design(parsed, map_size=16, device="cpu").graph
        g_jax = jax_pack_design(parsed, map_size=16, exact_levels=True,
                                cnn_patches=False).graph
        return graph, g_jax, 10
    rng = np.random.default_rng(11)
    parsed = make_random_leveled_graph(rng, level_sizes=(6, 8, 7, 9, 5, 6, 4),
                                       cell_feat_dim=12, max_in=3)
    graph = pack_leveled_graph_exact(parsed, device="cpu")[0]
    assert any(graph.merged_pos[k].numel() and int(graph.merged_pos[k].max())
               >= graph.cell_mail[k].numel() for k in range(graph.num_pairs))
    return graph, jax_pack_exact(parsed)[0], 12


def _port_gnn(params, cell_feat_dim, dgl_parity):
    gnn = TimeGNN(cell_feat_dim, 3, torch.Generator().manual_seed(0),
                  out_dim=OUT, hidden_dim=HID, dgl_parity=dgl_parity)
    state = params_from_flax({"gnn": params})
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()})
    return gnn


@pytest.mark.parametrize("which", ["no_prior", "prior"])
@pytest.mark.parametrize("dgl_parity", [True, False])
def test_walk_backward_matches_jax_fused_vjp(dgl_parity, which):
    """Parameter gradients and the h0 cotangent of the port's walk
    (ExactWalk: JAX's hand-written backward) match ``jax.grad`` through
    JAX ``TimeGNN(fused_vjp=True)`` at the tolerances of
    tests/test_fused_gnn.py (rtol 2e-4, atol 1e-5), for a dense random
    cotangent of h_final, jittered weights (nonzero biases); and the
    backward launches no kernel on the CPU."""
    graph, g_jax, cfd = _grad_case(which)
    rng = np.random.default_rng(8)
    n1 = graph.num_rows + 1
    h0 = (0.3 * rng.normal(size=(n1, OUT))).astype(np.float32)
    cot = rng.normal(size=(n1, OUT)).astype(np.float32)
    _, params = _jax_walk(g_jax, dgl_parity, h0)
    model = JaxTimeGNN(out_dim=OUT, hidden_dim=HID, dgl_parity=dgl_parity,
                       fused_vjp=True)

    def loss(p, h0):
        return (model.apply({"params": p}, g_jax, h0) * cot).sum()

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    d_params, d_h0 = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(h0))
    want = params_from_flax({"gnn": jax.tree_util.tree_map(np.asarray,
                                                           d_params)})
    gnn = _port_gnn(params, cfd, dgl_parity)
    h0_t = torch.from_numpy(h0).requires_grad_()
    (gnn(graph, h0_t) * torch.from_numpy(cot)).sum().backward()
    got = {f"gnn.{k}": p.grad for k, p in gnn.named_parameters()}
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(h0_t.grad.numpy(), np.asarray(d_h0),
                               rtol=2e-4, atol=1e-5)
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


@pytest.mark.parametrize("which", ["no_prior", "prior"])
@pytest.mark.parametrize("dgl_parity", [True, False])
def test_walk_backward_matches_torch_autograd(dgl_parity, which):
    """The hand-written backward against torch autograd through the
    plain forward (``exact_gnn_forward`` on CPU tensors): the same
    function, differentiated two ways; rtol 2e-4, atol 1e-5 (sums taken
    in another order)."""
    from prtp_tpu_torch.ops.fused_gnn import MLP_NAMES, exact_gnn_forward
    graph, _g, cfd = _grad_case(which)
    rng = np.random.default_rng(9)
    n1 = graph.num_rows + 1
    h0 = torch.from_numpy((0.3 * rng.normal(size=(n1, OUT))).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(n1, OUT)).astype(np.float32))
    gnn = TimeGNN(cfd, 3, torch.Generator().manual_seed(3), out_dim=OUT,
                  hidden_dim=HID, dgl_parity=dgl_parity)
    with torch.no_grad():  # nonzero biases
        for p in gnn.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                     .manual_seed(p.numel())))
    h0_a = h0.clone().requires_grad_()
    (gnn(graph, h0_a) * cot).sum().backward()
    plain = {name: tuple(t.detach().clone().requires_grad_()
                         for t in getattr(gnn, name).parameters())
             for name in MLP_NAMES}
    h0_b = h0.clone().requires_grad_()
    (exact_gnn_forward(plain, h0_b, graph, dgl_parity) * cot).sum().backward()
    for name in MLP_NAMES:
        for got, want in zip(getattr(gnn, name).parameters(), plain[name]):
            np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                       rtol=2e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(h0_a.grad.numpy(), h0_b.grad.numpy(),
                               rtol=2e-4, atol=1e-5)


def test_walk_without_grad_skips_the_backward_inputs():
    """h0 that needs no gradient gets none; under no_grad the Function
    builds no graph."""
    graph, _g, cfd = _grad_case("no_prior")
    gnn = TimeGNN(cfd, 3, torch.Generator().manual_seed(1), out_dim=OUT,
                  hidden_dim=HID)
    out = gnn(graph)
    assert out.requires_grad and out.grad_fn is not None
    out.sum().backward()
    assert all(p.grad is not None for p in gnn.parameters())
    with torch.no_grad():
        assert gnn(graph).grad_fn is None
