"""The port's metrics match prtp_tpu.utils.metrics on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.utils import metrics as JM
from prtp_tpu_torch.utils import metrics as M


def _inputs(seed, n=64):
    rng = np.random.default_rng(seed)
    pred = (5 + rng.normal(size=n)).astype(np.float32)
    target = (5 + rng.normal(size=n)).astype(np.float32)
    target[:3] = 0.0  # MAPE's zero-target guard
    required = (target + rng.normal(size=n) * 0.5).astype(np.float32)
    labels = (rng.random(n) < 0.4).astype(np.int32)
    mask = (rng.random(n) < 0.8).astype(np.float32)
    return pred, target, required, labels, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["r2_score", "mape", "mse_loss"])
def test_regression_metrics_match_jax(name, masked):
    pred, target, _r, _l, mask = _inputs(1)
    args = (pred, target) + ((mask,) if masked else ())
    want = float(getattr(JM, name)(*map(jnp.asarray, args)))
    got = getattr(M, name)(*map(torch.from_numpy, args))
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_confusion_and_classification_match_jax(masked):
    pred, _t, required, labels, mask = _inputs(2)
    pl_j = JM.judge_critical(jnp.asarray(pred), jnp.asarray(required))
    pl_t = M.judge_critical(torch.from_numpy(pred),
                            torch.from_numpy(required))
    np.testing.assert_array_equal(pl_t.numpy(), np.asarray(pl_j))
    m_j = jnp.asarray(mask) if masked else None
    m_t = torch.from_numpy(mask) if masked else None
    want = JM.confusion_counts(pl_j, jnp.asarray(labels), m_j)
    got = M.confusion_counts(pl_t, torch.from_numpy(labels), m_t)
    assert [float(g) for g in got] == [float(w) for w in want]
    assert (M.classification_metrics(*got)
            == JM.classification_metrics(*want))


def test_classification_zero_guards():
    assert M.classification_metrics(0, 0, 0, 0) == (0.0, 0.0, 0.0, 0.0)
    assert M.classification_metrics(0, 3, 5, 2) == (0.5, 0.0, 0.0, 0.0)
