"""The plain versions of the port's kernels match the JAX ops they
replace; on CPU tensors the wrappers run the plain version and launch
nothing. (The CUDA kernels themselves are held against these plain
versions on the card, by chip_smoke.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.ops.fused_gnn import _mean_sum, _softmax_sum
from prtp_tpu.ops.pool import pool_2x2 as jax_pool_2x2
from prtp_tpu.trainer import make_flat_adam
from prtp_tpu_torch.ops import KERNELS, _build, gather_rows, local_mean
from prtp_tpu_torch.ops import (flat_adam, mailbox_scatter, softmax_sum,
                                softmax_sum_bwd)
from prtp_tpu_torch.ops.adam import flat_adam_plain
from prtp_tpu_torch.ops.fused_gnn import (local_mean_plain,
                                          mailbox_scatter_plain,
                                          softmax_sum_bwd_plain,
                                          softmax_sum_plain)
from prtp_tpu_torch.ops.gather import gather_rows_plain
from prtp_tpu_torch.ops.pool import pool_2x2

import _torch_threads  # noqa: F401  (one torch thread a worker)


@pytest.fixture(autouse=True)
def no_launches():
    before = [k.launches for k in KERNELS]
    yield
    assert [k.launches for k in KERNELS] == before == [0] * len(KERNELS)


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


@pytest.mark.parametrize("k", [1, 3, 4, 11])
def test_softmax_sum_bwd_matches_jax(k):
    """The cell mailbox's cotangent, JAX's ``d_f * w * (1 + m - f)`` on
    ``m = h[idx]``; 0 at invalid slots (rows 0 and 7 all-invalid);
    rtol 1e-5, atol 1e-6 (float32, exp)."""
    rng = np.random.default_rng(20 + k)
    num_rows, p, d = 90, 40, 16
    h = (rng.normal(size=(num_rows + 1, d)) * 3).astype(np.float32)
    idx = rng.integers(0, num_rows, size=(p, k)).astype(np.int32)
    idx[rng.random((p, k)) >= 0.7] = num_rows
    idx[[0, 7]] = num_rows
    d_f = rng.normal(size=(p, d)).astype(np.float32)
    valid = jnp.asarray(idx != num_rows)[..., None]
    m = jnp.asarray(h)[jnp.asarray(idx)]
    f, w = _softmax_sum(m, valid)
    want = np.asarray(jnp.asarray(d_f)[:, None, :] * w
                      * (1.0 + m - f[:, None, :])).reshape(p * k, d)
    args = (torch.from_numpy(h), torch.from_numpy(idx), num_rows,
            torch.from_numpy(np.array(f)), torch.from_numpy(d_f))
    for fn in (softmax_sum_bwd, softmax_sum_bwd_plain):
        got = fn(*args).numpy()
        assert got.shape == (p * k, d)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[(idx == num_rows).reshape(-1)], 0.0)


def _scatter_case(rng, n_cell, pn_n, md_n, n_rows, d, with_cell,
                  seg_len=None):
    """Random sorted unique-row segment tables over ``n_cell`` cell and
    ``pn_n * md_n`` net positions, as the packer builds them; ``seg_len``
    maps destination rows to their segments' lengths (else random)."""
    n_pos = n_cell + pn_n * md_n
    if seg_len is None:
        pos = rng.choice(n_pos, size=min(n_pos, 3 * n_rows // 2),
                         replace=False)
        if not with_cell:
            pos = pos[pos >= n_cell]
        dest_row = rng.integers(0, n_rows, size=len(pos))
    else:
        dest_row = np.repeat(list(seg_len), list(seg_len.values()))
        pos = rng.choice(n_pos, size=len(dest_row), replace=False)
    order = np.argsort(dest_row, kind="stable")
    pos, dest_row = pos[order].astype(np.int32), dest_row[order]
    rows, seg = np.unique(dest_row, return_inverse=True)
    seg_off = np.searchsorted(seg, np.arange(len(rows) + 1)).astype(np.int32)
    return dict(
        dest=rng.normal(size=(n_rows, d)).astype(np.float32),
        rows=rows.astype(np.int32), seg=seg.astype(np.int32),
        seg_off=seg_off, pos=pos,
        d_mail_c=rng.normal(size=(n_cell, d)).astype(np.float32),
        d_pre_n=rng.normal(size=(pn_n, d)).astype(np.float32),
        cnt_n=rng.integers(1, md_n + 1, size=pn_n).astype(np.float32))


@pytest.mark.parametrize("site", ["merged", "intra", "pair0", "empty",
                                  "long"])
def test_mailbox_scatter_matches_jax_segment_sum_and_add(site):
    """JAX's ``dest.at[rows].add(segment_sum(cat[pos], seg))`` with
    ``cat = [d_mail_c | where(valid, d_pre_n / cnt, 0)]``: the merged
    call (cell and net positions), the intra call (net positions only,
    no cell cotangent), pair 0 (cell positions read as 0), an empty
    table, and one segment of 13 entries, longer than any at the
    headline, among one-entry segments; rtol 1e-6, atol 1e-6 (the same
    sums in the same order)."""
    rng = np.random.default_rng(["merged", "intra", "pair0", "empty", "long"]
                                .index(site))
    n_cell, pn_n, md_n, n_rows, d = {
        "merged": (60, 25, 3, 40, 12), "intra": (0, 30, 2, 18, 8),
        "pair0": (20, 25, 2, 30, 8), "empty": (10, 5, 1, 6, 4),
        "long": (30, 20, 2, 12, 8)}[site]
    seg_len = {0: 1, 3: 13, 5: 1, 7: 1, 11: 1} if site == "long" else None
    c = _scatter_case(rng, n_cell, pn_n, md_n, n_rows, d, site != "intra",
                      seg_len)
    if site == "long":
        assert np.diff(c["seg_off"]).tolist() == [1, 13, 1, 1, 1]
    if site == "empty":
        c.update(pos=c["pos"][:0], rows=c["rows"][:0], seg=c["seg"][:0],
                 seg_off=np.zeros(1, np.int32))
    cell = None if site == "pair0" else c["d_mail_c"]
    cell_j = np.zeros((n_cell, d), np.float32) if cell is None else cell
    d_mail_n = jnp.repeat(jnp.asarray(c["d_pre_n"])
                          / jnp.asarray(c["cnt_n"])[:, None], md_n, axis=0)
    cat = jnp.concatenate([jnp.asarray(cell_j), d_mail_n])
    uniq = jax.ops.segment_sum(cat[jnp.asarray(c["pos"])],
                               jnp.asarray(c["seg"]),
                               num_segments=len(c["rows"]),
                               indices_are_sorted=True)
    want = np.asarray(jnp.asarray(c["dest"]).at[jnp.asarray(c["rows"])].add(
        uniq, indices_are_sorted=True, unique_indices=True))
    for fn in (mailbox_scatter, mailbox_scatter_plain):
        dest = torch.from_numpy(c["dest"].copy())
        fn(dest, torch.from_numpy(c["rows"]), torch.from_numpy(c["seg_off"]),
           torch.from_numpy(c["pos"]),
           None if cell is None else torch.from_numpy(cell),
           torch.from_numpy(c["d_pre_n"]), torch.from_numpy(c["cnt_n"]),
           md_n, n_cell)
        np.testing.assert_allclose(dest.numpy(), want, rtol=1e-6, atol=1e-6)
    untouched = np.setdiff1d(np.arange(n_rows), c["rows"])
    np.testing.assert_array_equal(want[untouched], c["dest"][untouched])


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_flat_adam_matches_jax_make_flat_adam(weight_decay):
    """Five updates of JAX's ``make_flat_adam`` (then
    ``optax.apply_updates``) against the port's in-place update, at the
    tolerance of tests/test_flat_adam.py (rtol 1e-6, atol 1e-7): the
    same float32 operations, the bias corrections computed on the host."""
    import optax
    rng = np.random.default_rng(4)
    n, lr = 1001, 1e-2
    p0 = rng.normal(size=n).astype(np.float32)
    tx = make_flat_adam(lr, weight_decay)
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    p = torch.from_numpy(p0.copy())
    mu, nu = torch.zeros(n), torch.zeros(n)
    p_plain, mu_plain, nu_plain = p.clone(), mu.clone(), nu.clone()
    for t in range(1, 6):
        g = rng.normal(size=n).astype(np.float32)
        upd, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, upd)
        flat_adam(p, torch.from_numpy(g), mu, nu, lr, 0.9, 0.999, 1e-8,
                  weight_decay, t)
        flat_adam_plain(p_plain, torch.from_numpy(g), mu_plain, nu_plain, lr,
                        0.9, 0.999, 1e-8, weight_decay, t)
    for got in (p, p_plain):
        np.testing.assert_allclose(got.numpy(), np.asarray(params["w"]),
                                   rtol=1e-6, atol=1e-7)
    for got_mu, got_nu in ((mu, nu), (mu_plain, nu_plain)):
        np.testing.assert_allclose(got_mu.numpy(), np.asarray(state["mu"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got_nu.numpy(), np.asarray(state["nu"]),
                                   rtol=1e-6, atol=1e-9)


def test_new_wrappers_check_their_inputs():
    h, f = torch.zeros(10, 8), torch.zeros(4, 8)
    mail = torch.zeros(4, 3, dtype=torch.int32)
    softmax_sum_bwd(h, mail, 9, f, f)
    for bad in ((h, mail, 10, f, f), (h, mail, 9, f[:3], f),
                (h, mail, 9, f, f.t().contiguous()), (h, mail, 9, f.double(), f),
                (h, mail.long(), 9, f, f)):
        with pytest.raises(ValueError):
            softmax_sum_bwd(*bad)
    i32 = torch.zeros(3, dtype=torch.int32)
    ok = (torch.zeros(6, 8), i32[:2], torch.tensor([0, 1, 3], dtype=torch.int32),
          i32, None, torch.zeros(5, 8), torch.ones(5), 2, 4)
    mailbox_scatter(*ok)
    for i, val in ((1, i32.long()), (2, i32[:2]), (4, torch.zeros(3, 8)),
                   (5, torch.zeros(5, 7)), (6, torch.ones(4)),
                   (6, torch.ones(5).double()), (7, 0), (8, -1)):
        bad = list(ok)
        bad[i] = val
        with pytest.raises(ValueError):
            mailbox_scatter(*bad)
    v = torch.zeros(7)
    flat_adam(v, v.clone(), v.clone(), v.clone(), 1e-3, 0.9, 0.999, 1e-8, 0.0, 1)
    for bad in ((v[:6], v, v, v), (v.double(), v, v, v),
                (v, v[None], v, v), (v, v, v[::2], v)):
        with pytest.raises(ValueError):
            flat_adam(*bad, 1e-3, 0.9, 0.999, 1e-8, 0.0, 1)
    with pytest.raises(ValueError, match="t must"):
        flat_adam(v, v, v, v, 1e-3, 0.9, 0.999, 1e-8, 0.0, 0)


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_pool_backward_splits_exact_ties_as_jax(pooling):
    """The reshape pool's VJP at exact positive ties in a window: max
    splits the cotangent evenly among the tied elements, as JAX's
    reduce-max VJP does (``F.max_pool2d`` would route it to one)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 2, 4, 6)).astype(np.float32)
    x[0, 0, 0:2, 0:2] = 1.5           # four-way tie
    x[0, 1, 2, 2:4] = 2.25            # two-way tie on the window's top row
    x[0, 1, 3, 2:4] = -1.0
    cot = rng.normal(size=(1, 2, 2, 3)).astype(np.float32)
    to_nhwc = (0, 2, 3, 1)

    def jax_loss(xn):
        return (jax_pool_2x2(xn, pooling) * jnp.asarray(cot.transpose(to_nhwc))).sum()

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x.transpose(to_nhwc))))
    xt = torch.from_numpy(x).requires_grad_()
    (pool_2x2(xt, pooling) * torch.from_numpy(cot)).sum().backward()
    got = xt.grad.numpy().transpose(to_nhwc)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if pooling == "max":
        np.testing.assert_allclose(xt.grad[0, 0, 0:2, 0:2].numpy(),
                                   np.full((2, 2), cot[0, 0, 0, 0] / 4),
                                   rtol=1e-6)
        np.testing.assert_allclose(xt.grad[0, 1, 2, 2:4].numpy(),
                                   np.full(2, cot[0, 1, 1, 1] / 2), rtol=1e-6)
