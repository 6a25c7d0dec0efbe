"""The port's classification task (``--task cls --nlabels 2``) against
the JAX package's: the cross-entropy, the 2-logit head against its
frozen golden, evaluation and train steps."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_reference_parity as trp
import test_variant_goldens as tvg
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.trainer import TrainState, make_eval_step, pad_batch
from prtp_tpu.utils import metrics as jax_metrics
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models import PathModel
from prtp_tpu_torch.test import evaluate
from prtp_tpu_torch.test import pad_batch as port_pad_batch
from prtp_tpu_torch.utils import metrics
from prtp_tpu_torch.utils.convert import params_from_flax

from test_torch_convert import golden_variables, jax_params
from test_torch_model import MAP_SIZE, MODEL_KW
from test_torch_train import assert_steps_match_jax, golden_train  # noqa: F401

import _torch_threads  # noqa: F401  (one torch thread a worker)

CLS_KW = tvg.CLS_KW


@pytest.mark.parametrize("nlabels", [1, 2, 5])
def test_cross_entropy_matches_jax(nlabels):
    """Random logits (some large, so the max shift matters), labels and a
    mask with padding: the loss and its gradient at rtol 1e-6. One label
    is JAX's broadcast case (a (B,) head read as one row of B logits),
    which both packages compute alike."""
    rng = np.random.default_rng(nlabels)
    b = 37
    shape = (b,) if nlabels == 1 else (b, nlabels)
    logits = (rng.standard_normal(shape) * 30).astype(np.float32)
    labels = rng.integers(0, max(nlabels, 2), b).astype(np.int32)
    mask = (np.arange(b) < 29).astype(np.float32)
    want, want_g = jax.value_and_grad(jax_metrics.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    x = torch.from_numpy(logits).requires_grad_()
    got = metrics.cross_entropy_loss(x, torch.from_numpy(labels),
                                     torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-9)
    unmasked = jax_metrics.cross_entropy_loss(jnp.asarray(logits),
                                              jnp.asarray(labels))
    np.testing.assert_allclose(
        float(metrics.cross_entropy_loss(x.detach(),
                                         torch.from_numpy(labels))),
        float(unmasked), rtol=1e-6)


@pytest.fixture(scope="module")
def cls_golden():
    """The golden design and tests/test_variant_goldens.py's jittered
    cls weights; the port's model from them."""
    parsed = trp.parsed.__wrapped__()
    variables = golden_variables(parsed, tvg.MAP_SIZE, **CLS_KW)
    port = PathModel(parsed["cell_feat"].shape[1],
                     parsed["net_feat"].shape[1], **CLS_KW)
    port.load_state_dict(params_from_flax(variables["params"]))
    return parsed, variables, port


def test_cls_head_matches_golden(cls_golden):
    parsed, _v, port = cls_golden
    design = pack_design(parsed, map_size=trp.MAP_SIZE, device="cpu")
    with torch.no_grad():
        got = port(design, torch.arange(design.num_paths)).numpy()
    golden = np.load(os.path.join(trp.FIXTURES, "golden_outputs_cls.npz"))
    assert got.shape == golden["outputs"].shape == (design.num_paths, 2)
    np.testing.assert_allclose(got, golden["outputs"], rtol=2e-4, atol=2e-4)


def test_evaluate_cls_matches_jax_eval_step(cls_golden):
    """``evaluate(task="cls")`` against ``make_eval_step(model, "cls")``
    with padded entries: logits at 1e-5, the loss at rtol 1e-5, r2 0, and
    the confusion counts of the argmax labels equal."""
    parsed, variables, port = cls_golden
    exact = jax_pack_design(parsed, map_size=trp.MAP_SIZE, exact_levels=True,
                            cnn_patches=False)
    n = int(parsed["num_paths"])
    jids, jmask = pad_batch(np.arange(n), n + 3)
    state = TrainState(params=variables["params"], batch_stats={},
                       opt_state=(), step=jnp.zeros((), jnp.int32),
                       best_f1=jnp.zeros(()), best_r2=jnp.zeros(()))
    jpreds, jmets = make_eval_step(JaxPathModel(**CLS_KW), "cls")(
        state, exact, jids, jmask)
    design = pack_design(parsed, map_size=trp.MAP_SIZE, device="cpu")
    ids, mask = port_pad_batch(np.arange(n), n + 3, device="cpu")
    preds, mets = evaluate(port, design, ids, mask, task="cls")
    assert preds.shape == (n + 3, 2)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(mets["loss"]), float(jmets["loss"]),
                               rtol=1e-5)
    assert float(mets["r2"]) == float(jmets["r2"]) == 0.0
    for key in ("tp", "fp", "tn", "fn"):
        assert float(mets[key]) == float(jmets[key]), key
    assert sum(float(mets[k]) for k in ("tp", "fp", "tn", "fn")) == n


def test_cls_train_steps_match_jax_make_train_step(golden_train):  # noqa: F811
    """5 steps of the 2-logit model with the cross-entropy, from a
    converted init, against JAX's ``make_train_step(task="cls")``: the
    bounds of tests/test_torch_train.py (each loss at rtol 1e-5), and
    each step's confusion counts of the argmax labels equal. Adam moves a
    weight by about LR whatever its gradient's size, so a gradient's
    relative rounding moves it by that fraction of LR: after 5 steps one
    of Conv_2's 165,888 weights lies 2.3e-5 off JAX's, so the final
    parameters are held to atol 5e-5 (and rtol 1e-4)."""
    parsed, _v, exact, batches = golden_train
    kw = dict(MODEL_KW, nlabels=2)
    padded = jax_pack_design(parsed, map_size=MAP_SIZE, align=8)
    variables = jax_params(JaxPathModel(**kw), padded,
                           jnp.arange(padded.num_paths, dtype=jnp.int32))
    got, want = assert_steps_match_jax(parsed, kw, variables, exact, batches,
                                       task="cls", param_atol=5e-5)
    for g, w in zip(got, want):
        assert g["r2"] == w["r2"] == 0.0
        assert [g[k] for k in ("tp", "fp", "tn", "fn")] == \
            [w[k] for k in ("tp", "fp", "tn", "fn")]
