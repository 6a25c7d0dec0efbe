"""The port's graft-style entry (``__graft_entry_torch__.py``) against the
JAX package's (``__graft_entry__.py``): the flagship design, the entry
forward on the same (converted) weights, and the multi-rank dry run.

The dry runs start at the module's first test, each in a clean process
of its own (which spawns its gloo ranks on the CPU), and are read by the
last tests, so that they run while JAX compiles the forward."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import __graft_entry_torch__ as port_entry
from prtp_tpu_torch.utils.convert import params_from_flax

import _torch_threads  # noqa: F401  (one torch thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUNS = (4, 3)  # the (2, 2) segment mesh, and the odd count's 1-D dp
DRYRUN_TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def dryruns():
    """``dryrun_multichip(n, device="cpu")`` for each n of DRYRUNS, each
    in a clean process, started together."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    procs = {n: subprocess.Popen(
        [sys.executable, "-c", "import __graft_entry_torch__ as g; "
         f"g.dryrun_multichip({n}, device='cpu')"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for n in DRYRUNS}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def jax_flagship():
    return jax_entry._flagship(small=True)


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for key in a:
            _assert_same(a[key], b[key], f"{where}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, where
        np.testing.assert_array_equal(x, y, err_msg=where)


def test_flagship_design_equals_jax(jax_flagship):
    _model, _design, want = jax_flagship
    _model, design, got = port_entry._flagship(small=True, device="cpu")
    _assert_same(got, want, "parsed")
    assert design.num_paths == 64
    assert int(got["num_nodes"]) == 464


@pytest.fixture(scope="module")
def jax_entry_init(jax_flagship):
    """JAX's ``entry()`` weights (its init jitted) and ids."""
    model, design, _parsed = jax_flagship
    path_ids = jnp.arange(min(32, design.num_paths), dtype=jnp.int32)
    return jax.jit(model.init)(jax.random.PRNGKey(0), design,
                               path_ids), path_ids


def test_entry_draws_jax_entry_weights(jax_entry_init):
    """``entry()``'s model starts from ``PRNGKey(0)``'s weights, as
    ``__graft_entry__.entry`` does: JAX's init, bit for bit, under the
    port's names."""
    variables, _ids = jax_entry_init
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   variables["params"]))
    _fn, (port, _design, _ids) = port_entry.entry(device="cpu")
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy().view(np.uint32),
                                      want[key].numpy().view(np.uint32),
                                      err_msg=key)


def test_entry_forward_matches_jax(jax_flagship, jax_entry_init):
    """``entry(device="cpu")`` on JAX's ``entry()`` weights (its init
    jitted) against ``jax.jit(fn)(*args)``."""
    model, design, _parsed = jax_flagship
    variables, path_ids = jax_entry_init
    want = np.asarray(jax.jit(model.apply)(variables, design, path_ids))
    fn, (port, port_design, port_ids) = port_entry.entry(device="cpu")
    port.load_state_dict(params_from_flax(variables["params"]))
    got = fn(port, port_design, port_ids)
    assert not got.requires_grad
    got = got.numpy()
    assert got.shape == want.shape == (32,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dryrun_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card, so the CUDA default is valid")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_entry.entry()


@pytest.mark.parametrize("n", DRYRUNS)
def test_dryrun_multichip_from_clean_process(dryruns, n):
    out, err = dryruns[n].communicate(timeout=DRYRUN_TIMEOUT)
    assert dryruns[n].returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    assert f"dryrun_multichip({n}): ok, loss=" in out, out
    matched = f"dryrun_multichip({n}): 2-D segment-reduce step matches " \
              "replicated step (loss/r2/gradients)"
    if n % 2 == 0:
        assert matched in out and "mesh={'dp': 2, 'gp': 2}" in out, out
    else:
        assert "matches" not in out and f"mesh={{'dp': {n}}}" in out, out
