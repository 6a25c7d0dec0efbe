"""The plain versions of the port's kernels match the JAX ops they
replace; on CPU tensors the wrappers run the plain version and launch
nothing. (The CUDA kernels themselves are held against these plain
versions on the card, by chip_smoke.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.ops.fused_gnn import _mean_sum, _softmax_sum
from prtp_tpu.ops.pool import pool_2x2 as jax_pool_2x2
from prtp_tpu_torch.ops import KERNELS, _build, gather_rows, local_mean
from prtp_tpu_torch.ops import softmax_sum
from prtp_tpu_torch.ops.fused_gnn import local_mean_plain, softmax_sum_plain
from prtp_tpu_torch.ops.gather import gather_rows_plain
from prtp_tpu_torch.ops.pool import pool_2x2


@pytest.fixture(autouse=True)
def no_launches():
    before = [k.launches for k in KERNELS]
    yield
    assert [k.launches for k in KERNELS] == before == [0, 0, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_plain_equals_jax_gather(dtype):
    rng = np.random.default_rng(0)
    h = rng.normal(size=(300, 24)).astype(np.float32)
    idx = rng.integers(0, 300, size=517).astype(np.int32)
    h_j = jnp.asarray(h, dtype=dtype)
    want = np.asarray(h_j[jnp.asarray(idx)].astype(jnp.float32))
    h_t = torch.from_numpy(h).to(getattr(torch, dtype))
    for fn in (gather_rows, gather_rows_plain):
        got = fn(h_t, torch.from_numpy(idx))
        assert got.dtype == h_t.dtype and got.shape == (517, 24)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("k", [1, 3, 4, 11])
def test_softmax_sum_matches_jax(k):
    """The cell mailbox read from h by index: slot valid iff its index is
    not num_rows; rows 0 and 7 all-invalid give exactly 0."""
    rng = np.random.default_rng(k)
    num_rows, p, d = 90, 40, 16
    h = (rng.normal(size=(num_rows + 1, d)) * 3).astype(np.float32)
    idx = rng.integers(0, num_rows, size=(p, k)).astype(np.int32)
    idx[rng.random((p, k)) >= 0.7] = num_rows
    idx[[0, 7]] = num_rows
    valid = jnp.asarray(idx != num_rows)[..., None]
    want = np.asarray(_softmax_sum(jnp.asarray(h)[jnp.asarray(idx)],
                                   valid)[0])
    for fn in (softmax_sum, softmax_sum_plain):
        got = fn(torch.from_numpy(h), torch.from_numpy(idx),
                 num_rows).numpy()
        assert got.shape == (p, d)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert np.all(np.isfinite(got))
        np.testing.assert_array_equal(got[[0, 7]], 0.0)


@pytest.mark.parametrize("n_prior", [0, 19])
@pytest.mark.parametrize("k", [1, 2, 5])
def test_local_mean_matches_jax(k, n_prior):
    """Slots below len(new) read new, the next n_prior read prior, and
    num_valid = len(new) + n_prior marks an invalid slot."""
    rng = np.random.default_rng(10 + k + n_prior)
    n_new, d = 38, 16
    num_valid = n_new + n_prior
    new = rng.normal(size=(n_new, d)).astype(np.float32)
    prior = rng.normal(size=(n_prior, d)).astype(np.float32)
    idx = rng.integers(0, num_valid, size=(33, k)).astype(np.int32)
    idx[rng.random((33, k)) < 0.3] = num_valid
    idx[[2, 9]] = num_valid  # all-invalid rows
    buf = np.concatenate([new, prior, np.zeros((1, d), np.float32)])
    m = jnp.asarray(buf)[jnp.asarray(idx)]
    want = np.asarray(_mean_sum(m, jnp.asarray(idx != num_valid)[..., None])[0])
    for fn in (local_mean, local_mean_plain):
        got = fn(torch.from_numpy(new), torch.from_numpy(prior),
                 torch.from_numpy(idx)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[[2, 9]], 0.0)


def test_wrappers_check_their_inputs():
    h = torch.zeros(10, 8)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_rows(h, idx.long())
    with pytest.raises(ValueError):
        gather_rows(h.t(), idx)
    with pytest.raises(TypeError):
        gather_rows(h.double(), idx)
    mail = torch.zeros(4, 3, dtype=torch.int32)
    softmax_sum(h, mail, 9)  # h holds the dummy row 9
    for bad in ((h, mail, 10),            # no dummy row in h
                (h, mail, -1),
                (h.double(), mail, 9),     # dtype
                (h.t(), mail, 9),          # not contiguous
                (h[None], mail, 9),        # rank of h
                (h, mail.long(), 9),       # index dtype
                (h, mail[0], 9),           # rank of idx
                (h, mail.t(), 9)):         # idx not contiguous
        with pytest.raises(ValueError):
            softmax_sum(*bad)
    new, prior = torch.zeros(5, 8), torch.zeros(2, 8)
    local_mean(new, prior, mail)
    local_mean(new, prior[:0], mail)  # no prior rows
    for bad in ((new, torch.zeros(2, 7), mail),  # widths differ
                (new.double(), prior, mail),
                (new, prior.double(), mail),
                (new.t(), prior, mail),
                (new, prior, mail.long()),
                (new, prior, mail[0]),
                (new, prior[0], mail)):
        with pytest.raises(ValueError):
            local_mean(*bad)
    with pytest.raises(ValueError, match="devices"):
        local_mean(new, prior, mail.to("meta"))


@pytest.mark.parametrize("name", _build.KERNEL_NAMES)
def test_each_kernel_has_a_source_and_a_launcher(name):
    src = (_build.SRC_DIR / f"{name}.cu").read_text()
    assert f"PRTP_EXPORT int {name}_launch(" in src
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert _build.library_path(name).parent == _build.BUILD_DIR
    assert _build.library_path(name).name.startswith(f"lib{name}_")


def test_build_refuses_unknown_kernels_and_missing_nvcc(monkeypatch):
    with pytest.raises(ValueError, match="unknown"):
        _build.build(("no_such_kernel",))
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


@pytest.mark.parametrize("pooling", ["max", "avg"])
@pytest.mark.parametrize("hw", [(8, 12), (7, 9)])
def test_pool_matches_jax(pooling, hw):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3) + hw).astype(np.float32)  # NCHW
    want = np.asarray(jax_pool_2x2(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                   pooling))
    got = pool_2x2(torch.from_numpy(x), pooling).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-6,
                               atol=1e-6)


def test_bad_pooling_raises():
    with pytest.raises(ValueError, match="pooling"):
        pool_2x2(torch.zeros(1, 1, 4, 4), "median")
