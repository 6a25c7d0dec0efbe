"""The port's ``--attn --num_heads`` variant against the JAX package's:
the attention reduce and its backward (plain versions and their CPU
wrappers) against ``_attn_sum`` and ``jax.vjp`` of it, the walk against
``_forward_impl`` and ``jax.grad`` of ``fused_exact_gnn``, the model
against its frozen golden, train steps, the weights bridge and the
checkpoint's refusal of another architecture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_reference_parity as trp
import test_variant_goldens as tvg
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.models.gnn import TimeGNN as JaxTimeGNN
from prtp_tpu.ops.fused_gnn import _attn_sum, _forward_impl
from prtp_tpu_torch import trainer
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models import PathModel, TimeGNN
from prtp_tpu_torch.models.fusion import model_from_options
from prtp_tpu_torch.ops import KERNELS, attn_bwd, attn_sum
from prtp_tpu_torch.ops.fused_gnn import (MLP_NAMES, attn_bwd_plain,
                                          attn_sum_plain, exact_gnn_forward)
from prtp_tpu_torch.options import get_options
from prtp_tpu_torch.utils import checkpoint as ckpt
from prtp_tpu_torch.utils.convert import params_from_flax, params_to_flax

from test_torch_convert import (SMALL_KW, golden_variables, jax_params,
                                small_parsed)
from test_torch_gnn import HID, OUT, _grad_case
from test_torch_model import MAP_SIZE, MODEL_KW
from test_torch_train import assert_steps_match_jax, golden_train  # noqa: F401

NUM_ROWS, P, K, D = 70, 31, 5, 16


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors the wrappers run their plain versions."""
    yield
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def _case(nh, scores, seed=0):
    """h (NUM_ROWS + 1, D), a mailbox idx (P, K) with about a third of
    its slots invalid and rows 0 and 9 all-invalid, and w (nh, D).
    ``scores="large"``: h in multiples of 1/8 up to 16 and integer w up
    to 3, so that every score is a multiple of 1/8 up to hundreds, exact
    in float32 whatever the order of its sum: the max shift decides the
    result (exp of a raw score overflows), and both packages see the
    same scores."""
    rng = np.random.default_rng(seed + nh)
    if scores == "large":
        h = rng.integers(-128, 129, (NUM_ROWS + 1, D)) / 8.0
        w = rng.integers(-3, 4, (nh, D)).astype(np.float64)
    else:
        h = rng.normal(size=(NUM_ROWS + 1, D))
        w = rng.normal(size=(nh, D)) / np.sqrt(D)
    idx = rng.integers(0, NUM_ROWS, (P, K)).astype(np.int32)
    idx[rng.random((P, K)) < 0.35] = NUM_ROWS
    idx[[0, 9]] = NUM_ROWS
    return h.astype(np.float32), idx, w.astype(np.float32)


def _jax_attn(h, idx, w, nh):
    m = jnp.asarray(h)[jnp.asarray(idx)]
    valid = jnp.asarray(idx != NUM_ROWS)[..., None]
    return m, valid, (lambda m, wk: _attn_sum(m, valid, wk, nh))


@pytest.mark.parametrize("scores", ["normal", "large"])
@pytest.mark.parametrize("nh", [1, 2, 4])
def test_attn_sum_matches_jax(nh, scores):
    """out and alpha of ``attn_sum`` (wrapper and plain version) against
    ``_attn_sum`` at rtol 1e-5, atol 1e-6; the all-invalid rows give
    exactly 0 and alpha is 0 at every invalid slot."""
    h, idx, w = _case(nh, scores)
    m, _v, fn = _jax_attn(h, idx, w, nh)
    want_out, want_alpha = (np.asarray(a) for a in fn(m, jnp.asarray(w.T)))
    args = (torch.from_numpy(h), torch.from_numpy(idx), NUM_ROWS,
            torch.from_numpy(w))
    for f in (attn_sum, attn_sum_plain):
        out, alpha = f(*args, with_alpha=True)
        assert out.shape == (P, D) and alpha.shape == (P, K, nh)
        np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(alpha.numpy(), want_alpha, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(out.numpy()[[0, 9]], 0.0)
        np.testing.assert_array_equal(alpha.numpy()[idx == NUM_ROWS], 0.0)
        torch.testing.assert_close(f(*args), out, rtol=0, atol=0)
    if scores == "large":
        assert np.abs(h[idx[idx != NUM_ROWS]] @ w.T).max() > 100


@pytest.mark.parametrize("scores", ["normal", "large"])
@pytest.mark.parametrize("nh", [1, 2, 4])
def test_attn_bwd_matches_jax_vjp(nh, scores):
    """``attn_bwd`` (wrapper and plain version) against ``jax.vjp`` of
    ``_attn_sum`` in (m, w) for a random cotangent: the mailbox's
    cotangent and w's, each within 1e-5 of its max |g| (sums of up to
    P x K terms in another order); 0 at invalid slots."""
    h, idx, w = _case(nh, scores, seed=5)
    d_out = np.random.default_rng(nh).normal(size=(P, D)).astype(np.float32)
    m, _v, fn = _jax_attn(h, idx, w, nh)
    (_out, alpha), vjp = jax.vjp(fn, m, jnp.asarray(w.T))
    want_dm, want_dw = vjp((jnp.asarray(d_out), jnp.zeros_like(alpha)))
    want_dm = np.asarray(want_dm).reshape(P * K, D)
    want_dw = np.asarray(want_dw).T
    args = (torch.from_numpy(h), torch.from_numpy(idx), NUM_ROWS,
            torch.from_numpy(w), torch.from_numpy(np.array(alpha)),
            torch.from_numpy(d_out))
    for f in (attn_bwd, attn_bwd_plain):
        d_m, d_w = f(*args)
        assert d_m.shape == (P * K, D) and d_w.shape == (nh, D)
        for got, want in ((d_m, want_dm), (d_w, want_dw)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        np.testing.assert_array_equal(
            d_m.numpy()[(idx == NUM_ROWS).reshape(-1)], 0.0)


def test_attn_wrappers_check_their_inputs():
    h = torch.zeros(10, 8)
    mail = torch.zeros(4, 3, dtype=torch.int32)
    w = torch.zeros(2, 8)
    alpha, d_f = torch.zeros(4, 3, 2), torch.zeros(4, 8)
    attn_sum(h, mail, 9, w)
    attn_bwd(h, mail, 9, w, alpha, d_f)
    for bad in ((h, mail, 10, w),             # no dummy row in h
                (h, mail, 9, torch.zeros(3, 8)),  # 3 heads of 8 channels
                (h, mail, 9, torch.zeros(2, 7)),  # w's width
                (h, mail, 9, w.double()),
                (h, mail, 9, w.t().contiguous().t()),  # w not contiguous
                (h, mail.long(), 9, w)):
        with pytest.raises(ValueError):
            attn_sum(*bad)
    for bad in ((h, mail, 9, w, alpha[..., :1].contiguous(), d_f),
                (h, mail, 9, w, alpha.double(), d_f),
                (h, mail, 9, w, alpha, d_f[:3]),
                (h, mail, 9, torch.zeros(3, 8), alpha, d_f)):
        with pytest.raises(ValueError):
            attn_bwd(*bad)


# ---- the walk ----

def _jax_attn_walk(g, nh, dgl_parity, h0, seed=5):
    """JAX TimeGNN(flag_attn=True, num_heads=nh) params, jittered, and
    ``_forward_impl`` with the ``nh`` config slot on the JAX-packed
    graph ``g``: (h_final, params, model)."""
    model = JaxTimeGNN(out_dim=OUT, hidden_dim=HID, dgl_parity=dgl_parity,
                       flag_attn=True, num_heads=nh, fused_vjp=True)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), g)
    leaves, treedef = jax.tree_util.tree_flatten(v)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    v = jax.tree_util.tree_unflatten(
        treedef, [l + 0.1 * jax.random.normal(k, l.shape, l.dtype)
                  for l, k in zip(leaves, keys)])
    params = v["params"]["pair_step"]
    config = (g.num_rows, dgl_parity, tuple(g.cell_off), tuple(g.net_off),
              None, nh)
    blocks = tuple(
        dict(cell_feat=g.cell_feat_lvl[k], net_feat=g.net_feat_lvl[k],
             cell_mail=g.cell_mail[k], net_mail=g.net_mail[k],
             gather_rows=g.gather_rows[k], net_local_idx=g.net_local_idx[k])
        for k in range(g.num_pairs))
    h = jax.jit(_forward_impl, static_argnums=0)(config, params,
                                                 jnp.asarray(h0), blocks)
    return (np.asarray(h), jax.tree_util.tree_map(np.asarray, v["params"]),
            model)


def _port_attn_gnn(params, cell_feat_dim, nh, dgl_parity):
    gnn = TimeGNN(cell_feat_dim, 3, torch.Generator().manual_seed(0),
                  out_dim=OUT, hidden_dim=HID, dgl_parity=dgl_parity,
                  flag_attn=True, num_heads=nh)
    state = params_from_flax({"gnn": params})
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()})
    return gnn


@pytest.mark.parametrize("which", ["no_prior", "prior"])
@pytest.mark.parametrize("nh", [1, 2])
def test_attn_walk_matches_jax_forward_impl(nh, which):
    """The port's TimeGNN(flag_attn=True) with JAX's converted params
    against ``_forward_impl`` with the ``nh`` slot, on a design without
    and with prior rows, at 1e-5."""
    graph, g_jax, cfd = _grad_case(which)
    h0 = np.random.default_rng(2).normal(
        size=(graph.num_rows + 1, OUT)).astype(np.float32)
    want, params, _m = _jax_attn_walk(g_jax, nh, True, h0)
    assert params["pair_step"]["fc_attn2"]["kernel"].shape == (OUT, nh)
    gnn = _port_attn_gnn(params["pair_step"], cfd, nh, True)
    with torch.no_grad():
        got = gnn(graph, torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["no_prior", "prior"])
@pytest.mark.parametrize("nh", [1, 2])
def test_attn_walk_backward_matches_jax_fused_vjp(nh, which):
    """Parameter gradients (``fc_attn2`` included) and the h0 cotangent
    of the port's walk against ``jax.grad`` through JAX
    ``TimeGNN(flag_attn=True, fused_vjp=True)`` (``fused_exact_gnn``'s
    ``_attn_bwd``), rtol 2e-4 and atol 1e-5 as
    ``test_walk_backward_matches_jax_fused_vjp``."""
    graph, g_jax, cfd = _grad_case(which)
    rng = np.random.default_rng(8)
    n1 = graph.num_rows + 1
    h0 = (0.3 * rng.normal(size=(n1, OUT))).astype(np.float32)
    cot = rng.normal(size=(n1, OUT)).astype(np.float32)
    _h, params, model = _jax_attn_walk(g_jax, nh, True, h0)

    def loss(p, h0):
        return (model.apply({"params": p}, g_jax, h0) * cot).sum()

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    d_params, d_h0 = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jp, jnp.asarray(h0))
    want = params_from_flax({"gnn": jax.tree_util.tree_map(np.asarray,
                                                           d_params)})
    gnn = _port_attn_gnn(params["pair_step"], cfd, nh, True)
    h0_t = torch.from_numpy(h0).requires_grad_()
    (gnn(graph, h0_t) * torch.from_numpy(cot)).sum().backward()
    got = {f"gnn.{k}": p.grad for k, p in gnn.named_parameters()}
    assert sorted(got) == sorted(want) and "gnn.fc_attn2.weight" in got
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(h0_t.grad.numpy(), np.asarray(d_h0),
                               rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("dgl_parity", [True, False])
@pytest.mark.parametrize("nh", [1, 2])
def test_attn_walk_backward_matches_torch_autograd(nh, dgl_parity):
    """The hand-written backward against torch autograd through the
    plain forward (``exact_gnn_forward`` with ``fc_attn2``), on the
    prior-row graph; rtol 2e-4, atol 1e-5."""
    graph, _g, cfd = _grad_case("prior")
    rng = np.random.default_rng(9)
    n1 = graph.num_rows + 1
    h0 = torch.from_numpy((0.3 * rng.normal(size=(n1, OUT))).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(n1, OUT)).astype(np.float32))
    gnn = TimeGNN(cfd, 3, torch.Generator().manual_seed(3), out_dim=OUT,
                  hidden_dim=HID, dgl_parity=dgl_parity, flag_attn=True,
                  num_heads=nh)
    with torch.no_grad():  # nonzero biases
        for p in gnn.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                     .manual_seed(p.numel())))
    h0_a = h0.clone().requires_grad_()
    (gnn(graph, h0_a) * cot).sum().backward()
    plain = {name: tuple(t.detach().clone().requires_grad_()
                         for t in getattr(gnn, name).parameters())
             for name in MLP_NAMES}
    plain["fc_attn2"] = gnn.fc_attn2.weight.detach().clone().requires_grad_()
    h0_b = h0.clone().requires_grad_()
    (exact_gnn_forward(plain, h0_b, graph, dgl_parity) * cot).sum().backward()
    pairs = [(got, want) for name in MLP_NAMES
             for got, want in zip(getattr(gnn, name).parameters(),
                                  plain[name])]
    pairs += [(gnn.fc_attn2.weight, plain["fc_attn2"]), (h0_a, h0_b)]
    for got, want in pairs:
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   rtol=2e-4, atol=1e-5)
    assert float(gnn.fc_attn2.weight.grad.abs().max()) > 0


# ---- the model ----

def test_attn_model_matches_golden():
    """PathModel(flag_attn=True, num_heads=2) with the golden fixture's
    jittered JAX weights, converted, against ``golden_outputs_attn.npz``
    (tests/test_variant_goldens.py) at 2e-4."""
    parsed = trp.parsed.__wrapped__()
    variables = golden_variables(parsed, tvg.MAP_SIZE, **tvg.ATTN_KW)
    port = PathModel(parsed["cell_feat"].shape[1],
                     parsed["net_feat"].shape[1], **tvg.ATTN_KW)
    port.load_state_dict(params_from_flax(variables["params"]))
    assert port.gnn.fc_attn2.weight.shape == (2, tvg.ATTN_KW["out_dim"])
    design = pack_design(parsed, map_size=trp.MAP_SIZE, device="cpu")
    with torch.no_grad():
        got = port(design, torch.arange(design.num_paths)).numpy()
    golden = np.load(f"{trp.FIXTURES}/golden_outputs_attn.npz")
    assert got.shape == golden["outputs"].shape
    np.testing.assert_allclose(got, golden["outputs"], rtol=2e-4, atol=2e-4)


def test_attn_train_steps_match_jax_make_train_step(golden_train):  # noqa: F811
    """5 steps of PathModel(flag_attn=True, num_heads=2) from a converted
    init against JAX's ``make_train_step``, with the bounds of
    tests/test_torch_train.py: ``fc_attn2``'s first-step gradient at
    rtol 1e-4 and atol 1e-5 x its max |g|, every loss at rtol 1e-5."""
    parsed, _v, exact, batches = golden_train
    kw = dict(MODEL_KW, flag_attn=True, num_heads=2)
    padded = jax_pack_design(parsed, map_size=MAP_SIZE, align=8)
    variables = jax_params(JaxPathModel(**kw), padded,
                           jnp.arange(padded.num_paths, dtype=jnp.int32))
    assert "fc_attn2" in variables["params"]["gnn"]["pair_step"]
    assert_steps_match_jax(parsed, kw, variables, exact, batches)


def test_attention_gnn_trains():
    """The counterpart of tests/test_tasks.py's
    ``test_attention_gnn_trains``: ``--attn --no_cnn`` through the
    port's options and ``model_from_options``, 10 steps on one batch of
    a small design; the loss falls."""
    options = get_options(["--attn", "--no_cnn", "--out_dim", "16",
                           "--hidden_dim", "32", "--map_size", "16"])
    parsed = small_parsed(seed=3)
    model = model_from_options(options, parsed["cell_feat"].shape[1],
                               parsed["net_feat"].shape[1],
                               parsed["cnn_input"].shape[0])
    assert model.gnn.fc_attn2.weight.shape == (1, 16)
    state = trainer.init_state(model, trainer.make_optimizer(1e-3), "cpu")
    design = pack_design(parsed, map_size=16, device="cpu")
    n = int(parsed["num_paths"])
    ids, mask = trainer.pad_batch(np.arange(n), n, device="cpu")
    losses = [float(trainer.train_step(state, design, ids, mask)["loss"])
              for _ in range(10)]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("nh", [1, 4])
def test_convert_round_trip_with_fc_attn2(nh):
    """``gnn/pair_step/fc_attn2/kernel`` (D, nh) <-> ``gnn.fc_attn2.weight``
    (nh, D), exactly, and the converted tree fits the port's model."""
    parsed = small_parsed()
    design = jax_pack_design(parsed, map_size=16, exact_levels=True,
                             cnn_patches=False)
    model = JaxPathModel(flag_attn=True, num_heads=nh, **SMALL_KW)
    tree = jax_params(model, design, jnp.arange(design.num_paths,
                                                dtype=jnp.int32))["params"]
    kernel = tree["gnn"]["pair_step"]["fc_attn2"]["kernel"]
    state = params_from_flax(tree)
    np.testing.assert_array_equal(state["gnn.fc_attn2.weight"].numpy(),
                                  kernel.T)
    port = PathModel(10, 3, flag_attn=True, num_heads=nh, **SMALL_KW)
    assert sorted(state) == sorted(port.state_dict())
    port.load_state_dict(state, strict=True)
    back = params_to_flax(port.state_dict())
    np.testing.assert_array_equal(
        back["gnn"]["pair_step"]["fc_attn2"]["kernel"], kernel)


@pytest.mark.parametrize("saved,loaded", [
    (dict(flag_attn=True, num_heads=2), dict()),
    (dict(), dict(flag_attn=True, num_heads=2)),
    (dict(flag_attn=True, num_heads=1), dict(flag_attn=True, num_heads=4)),
])
def test_checkpoint_refuses_another_attention_setting(saved, loaded,
                                                      tmp_path):
    """A ``model.pt`` saved with ``--attn`` does not load into a model
    without it, nor the reverse, nor across ``--num_heads``: a
    ValueError naming the tensors, raised before anything is copied."""
    def state_of(kw, seed):
        model = PathModel(10, 3, generator=torch.Generator().manual_seed(seed),
                          **SMALL_KW, **kw)
        return trainer.init_state(model, trainer.make_optimizer(1e-3), "cpu")

    ckpt.save_checkpoint(str(tmp_path), state_of(saved, 0), {})
    target = state_of(loaded, 1)
    before = {k: v.clone() for k, v in target.model.state_dict().items()}
    with pytest.raises(ValueError, match="fc_attn2"):
        ckpt.load_checkpoint(str(tmp_path), target)
    for key, val in target.model.state_dict().items():
        torch.testing.assert_close(val, before[key], rtol=0, atol=0)
    ckpt.load_checkpoint(str(tmp_path), state_of(saved, 2))  # fits
