"""``prtp_tpu_torch/utils/jax_random.py`` against ``jax.random`` and
``jax.lax`` on the CPU, bit for bit: the keys of ``PRNGKey`` and
``fold_in``, 32-bit random bits, ``uniform`` (also on a range whose
scaling needs the fused multiply-add), ``truncated_normal``, flax's
lecun-normal and xavier-uniform initializers, XLA's float32 ``erf``,
``erf_inv``, ``log1p`` and ``log``, and flax's per-parameter key
(``param_key``) on a nested module built of ``setup`` and
``nn.compact`` modules, with a scope counter that takes two bytes. Each
draw on seeds 0, 9294 (the CLIs' default) and 2**31 - 1, on odd lengths
and on 2-D and 4-D shapes. Every check is exact: the port's draws must
not be an ulp off JAX's."""

from fractions import Fraction

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prtp_tpu_torch.utils import jax_random as R

import _torch_threads  # noqa: F401  (one torch thread a worker)

SEEDS = (0, 9294, 2**31 - 1)
SHAPES = ((1,), (7,), (1001,), (3, 5), (9, 9, 2, 32), (2, 2, 16, 8))


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS + (-3, 2**32 + 5))
def test_keys_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    _bits_equal(R.prng_key(seed), key)
    for data in (0, 1, 12345, 2**31, 2**32 - 1):
        _bits_equal(R.fold_in(R.prng_key(seed), data),
                    jax.random.fold_in(key, data))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniforms(seed, shape):
    key, nkey = jax.random.PRNGKey(seed), R.prng_key(seed)
    _bits_equal(R.random_bits(nkey, shape),
                jax.random.bits(key, shape, jnp.uint32))
    _bits_equal(R.uniform(nkey, shape), jax.random.uniform(key, shape))
    lo, hi = R.erf(np.float32([-1.0, 1.0]))  # the truncated normal's range
    _bits_equal(R.uniform(nkey, shape, lo, hi),
                jax.random.uniform(key, shape, minval=lo, maxval=hi))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_truncated_normal_and_initializers(seed, shape):
    key, nkey = jax.random.PRNGKey(seed), R.prng_key(seed)
    _bits_equal(R.truncated_normal(nkey, -2, 2, shape),
                jax.random.truncated_normal(key, -2, 2, shape))
    if len(shape) < 2:
        return
    _bits_equal(R.lecun_normal(nkey, shape),
                nn.initializers.lecun_normal()(key, shape))
    _bits_equal(R.xavier_uniform(nkey, shape),
                nn.initializers.xavier_uniform()(key, shape))


def test_fcn_kernel_draw_at_the_headline_width():
    """The headline's 16,384 x 128 ``fcn_kernel`` and its largest conv."""
    key, nkey = jax.random.PRNGKey(9294), R.prng_key(9294)
    _bits_equal(R.xavier_uniform(nkey, (16384, 128)),
                jax.jit(nn.initializers.xavier_uniform(), static_argnums=1)(
                    key, (16384, 128)))
    _bits_equal(R.lecun_normal(nkey, (9, 9, 64, 32)),
                jax.jit(nn.initializers.lecun_normal(), static_argnums=1)(
                    key, (9, 9, 64, 32)))


def test_xla_special_functions():
    x = np.linspace(-5, 5, 400_001, dtype=np.float32)
    _bits_equal(R.erf(x), jax.jit(jax.lax.erf)(x))
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (400_000,),
                                      minval=-0.9999, maxval=0.9999))
    _bits_equal(R.erf_inv(u), jax.jit(jax.lax.erf_inv)(u))
    v = -(u * u)
    _bits_equal(R.log1p(v), jax.jit(jnp.log1p)(v))
    y = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (400_000,),
                                      minval=1e-30, maxval=100.0))
    _bits_equal(R.log(y), jax.jit(jnp.log)(y))


def _round_f32(v: Fraction) -> np.float32:
    """The float32 nearest the rational ``v``, ties to even."""
    near = np.float32(float(v))
    cands = [np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - v),
                                     int(np.array(c).view(np.uint32)) & 1))


def test_fma_rounds_once_on_midpoints():
    """Products that fall on a float32 midpoint, nudged by a tiny addend
    that the float64 sum loses: rounded once, as a fused multiply-add."""
    rng = np.random.default_rng(0)
    a = (rng.integers(1 << 23, 1 << 24, 3000) * 2.0**-23).astype(np.float32)
    b = (1 + rng.integers(1, 1 << 12, 3000) * 2.0**-23).astype(np.float32)
    c = (rng.choice([-1.0, 1.0], 3000) * 2.0**-60).astype(np.float32)
    got = R._fma(a, b, c)
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y))
                       + Fraction(float(z))) for x, y, z in zip(a, b, c)]
    _bits_equal(got, np.array(want, np.float32))


class _Leaf(nn.Module):
    """``n`` parameters, each its own key: counters 1 .. n."""
    n: int

    @nn.compact
    def __call__(self):
        return [self.param(f"p{i}", lambda k: k) for i in range(self.n)]


class _Compact(nn.Module):
    @nn.compact
    def __call__(self):
        self.param("own", lambda k: k)
        _Leaf(2, name="inner")()
        _Leaf(1)()  # auto-named _Leaf_0
        return _Leaf(300, name="wide")()


class _Setup(nn.Module):
    def setup(self):
        self.top = self.param("top", lambda k: k)
        self.body = _Compact()
        self.tail = _Leaf(1)

    def __call__(self):
        self.tail()
        return self.body()


@pytest.mark.parametrize("seed", SEEDS)
def test_param_key_is_flax_static_fold(seed):
    """flax's key of every parameter of a nested module: its scope path
    from the root's child down and its scope's ``make_rng`` counter."""
    params = _Setup().init(jax.random.PRNGKey(seed))["params"]
    root = R.prng_key(seed)
    want = {(): {"top": 1}, ("body",): {"own": 1},
            ("body", "inner"): {"p0": 1, "p1": 2},
            ("body", "_Leaf_0"): {"p0": 1}, ("tail",): {"p0": 1},
            ("body", "wide"): {f"p{i}": i + 1 for i in range(300)}}
    seen = 0
    for scope, names in want.items():
        node = params
        for part in scope:
            node = node[part]
        for name, counter in names.items():
            _bits_equal(R.param_key(root, scope, counter), node[name])
            seen += 1
    assert seen == len(jax.tree_util.tree_leaves(params)) == 306
