"""The port's LayoutNet, PathModel and evaluation match the JAX package
on the same inputs and the same (converted) weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.models.layoutnet import LayoutNet as JaxLayoutNet
from prtp_tpu.trainer import TrainState, make_eval_step, pad_batch
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models import LayoutNet, PathModel
from prtp_tpu_torch.test import evaluate, evaluate_design
from prtp_tpu_torch.test import pad_batch as port_pad_batch
from prtp_tpu_torch.utils.convert import params_from_flax

from test_torch_convert import jax_params
from test_torch_graph import FIXTURES, golden_parsed

# tests/test_reference_parity.py's small configuration
MAP_SIZE = 16
MODEL_KW = dict(out_dim=16, hidden_dim=32, cnn_outdim=8, map_size=16,
                global_dim=8)


@pytest.fixture(scope="module")
def golden():
    """The golden design and the golden fixture's weights: a JAX init on
    the padded pack (PRNGKey 0), every leaf jittered (PRNGKey 7, 0.05)."""
    parsed = golden_parsed(MAP_SIZE)
    padded = jax_pack_design(parsed, map_size=MAP_SIZE, align=8)
    pids = jnp.arange(padded.num_paths, dtype=jnp.int32)
    variables = jax_params(JaxPathModel(**MODEL_KW), padded, pids)
    exact = jax_pack_design(parsed, map_size=MAP_SIZE, exact_levels=True,
                            cnn_patches=False)
    port = PathModel(parsed["cell_feat"].shape[1],
                     parsed["net_feat"].shape[1], **MODEL_KW)
    port.load_state_dict(params_from_flax(variables["params"]))
    return parsed, variables, exact, port


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_layoutnet_matches_jax(pooling):
    rng = np.random.default_rng(0)
    x = rng.random((1, 2, 32, 32), dtype=np.float32)  # NCHW
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    jnet = JaxLayoutNet(pooling)
    v = jax.jit(jnet.init)(jax.random.PRNGKey(3), x_nhwc)
    want = np.asarray(jax.jit(jnet.apply)(v, x_nhwc))  # (1, 8, 8, 1)
    net = LayoutNet(torch.Generator(), pooling)
    state = params_from_flax({"cnn": jax.tree_util.tree_map(
        np.asarray, v["params"])})
    net.load_state_dict({k[len("cnn."):]: t for k, t in state.items()})
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()  # (1, 1, 8, 8)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-5,
                               atol=1e-5)


def test_pathmodel_matches_jax_and_golden_outputs(golden):
    parsed, variables, exact, port = golden
    pids = jnp.arange(exact.num_paths, dtype=jnp.int32)
    want = np.asarray(jax.jit(JaxPathModel(**MODEL_KW).apply)(
        variables, exact, pids))
    design = pack_design(parsed, map_size=MAP_SIZE, device="cpu")
    with torch.no_grad():
        got = port(design, torch.arange(design.num_paths)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    frozen = np.load(os.path.join(FIXTURES, "golden_outputs.npz"))["outputs"]
    np.testing.assert_allclose(got, frozen, rtol=2e-4, atol=2e-4)


def test_evaluate_matches_jax_eval_step(golden):
    parsed, variables, exact, port = golden
    n = int(parsed["num_paths"])
    cap = n + 3  # padded entries must not count
    jids, jmask = pad_batch(np.arange(n), cap)
    state = TrainState(params=variables["params"], batch_stats={},
                       opt_state=(), step=jnp.zeros((), jnp.int32),
                       best_f1=jnp.zeros(()), best_r2=jnp.zeros(()))
    jpreds, jmets = make_eval_step(JaxPathModel(**MODEL_KW))(
        state, exact, jids, jmask)
    design = pack_design(parsed, map_size=MAP_SIZE, device="cpu")
    ids, mask = port_pad_batch(np.arange(n), cap, device="cpu")
    preds, mets = evaluate(port, design, ids, mask)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=1e-5,
                               atol=1e-5)
    for key in ("loss", "r2"):
        np.testing.assert_allclose(float(mets[key]), float(jmets[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    for key in ("tp", "fp", "tn", "fn"):
        assert float(mets[key]) == float(jmets[key]), key
    assert sum(float(mets[k]) for k in ("tp", "fp", "tn", "fn")) == n


def test_evaluate_design_prints_the_driver_lines(golden, capsys):
    parsed, _v, _e, port = golden
    preds, mets = evaluate_design(port, parsed, device="cpu", case_idx=3)
    out = capsys.readouterr().out
    assert "case 3, runtime: " in out
    assert "\ttp: " in out and "F1 score:" in out
    design = pack_design(parsed, map_size=MAP_SIZE, device="cpu")
    ids, mask = port_pad_batch(np.arange(len(preds)), len(preds), "cpu")
    want, want_mets = evaluate(port, design, ids, mask)
    np.testing.assert_array_equal(preds, want.numpy())
    assert mets["loss"] == float(want_mets["loss"])
    assert {"acc", "recall", "precision", "f1", "runtime"} <= set(mets)
    levels = np.unique(np.asarray(parsed["path2level"]))
    multi = [l for l in levels
             if (np.asarray(parsed["path2level"]) == l).sum() >= 2]
    assert out.count("level ") == len(multi)


@pytest.mark.parametrize("use_gnn,use_cnn", [(True, False), (False, True)])
def test_ablations_match_jax(use_gnn, use_cnn):
    from test_torch_convert import small_parsed
    parsed = small_parsed(seed=2)
    exact = jax_pack_design(parsed, map_size=16, exact_levels=True,
                            cnn_patches=False)
    jm = JaxPathModel(use_gnn=use_gnn, use_cnn=use_cnn, **MODEL_KW)
    pids = jnp.arange(exact.num_paths, dtype=jnp.int32)
    variables = jax_params(jm, exact, pids)
    want = np.asarray(jax.jit(jm.apply)(variables, exact, pids))
    port = PathModel(10, 3, use_gnn=use_gnn, use_cnn=use_cnn, **MODEL_KW)
    port.load_state_dict(params_from_flax(variables["params"]))
    design = pack_design(parsed, map_size=16, device="cpu")
    with torch.no_grad():
        got = port(design, torch.arange(design.num_paths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,err", [
    (dict(use_gnn=False, use_cnn=False), ValueError),
    (dict(compute_dtype=torch.float16), ValueError),  # float32 or bfloat16
    (dict(flag_attn=True, num_heads=3), ValueError),  # 3 does not divide 16
])
def test_unported_and_invalid_configurations_raise(kw, err):
    with pytest.raises(err):
        PathModel(10, 3, **MODEL_KW, **kw)


def test_init_follows_flax_distributions():
    def build(seed):
        return PathModel(36, 3, generator=torch.Generator().manual_seed(seed))

    a, b, c = build(1), build(1), build(2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for key, val in sa.items():
        torch.testing.assert_close(val, sb[key], rtol=0, atol=0)
        if key.endswith("bias"):
            assert not val.any(), key
            continue
        assert not torch.equal(val, sc[key]), key
        if key == "fcn_kernel":  # xavier uniform over (map^2, cnn_outdim)
            limit = (6.0 / sum(val.shape)) ** 0.5
            assert float(val.abs().max()) <= limit * (1 + 1e-6)  # f32 round
            assert float(val.abs().max()) > 0.9 * limit
            continue
        # lecun normal: N(0, 1/fan_in) truncated at two of its std
        fan_in = val[0].numel()
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        assert float(val.abs().max()) <= 2 * std + 1e-6, key
        if val.numel() >= 4096:
            np.testing.assert_allclose(float(val.std()), fan_in ** -0.5,
                                       rtol=0.1, err_msg=key)
