"""The port's init against flax's. Bit for bit: the train CLI's
``model_from_options(--seed s)`` is JAX's ``jax.jit(model.init)
(PRNGKey(s))`` (``utils/convert.py::init_from_seed``), every leaf under
the same name and shape with the same bits, for each variant of
EXACT_VARIANTS at EXACT_SEEDS, the U-Net's running averages too. In
distribution: the port's constructor's own draw from a
``torch.Generator`` (the weights of every model the CLIs do not build),
against JAX's ``model.init(PRNGKey(s))`` over SEEDS seeds each, leaf by
leaf (JAX's leaves under the port's names,
``utils/convert.py::params_from_flax``). Every random leaf's standard
deviation within STD_SIGMAS / sqrt(2 n) of JAX's, relative (n its
elements over the seeds); its largest |w| within its initializer's
bound in both packages: 2 sqrt(1 / fan_in) / 0.87962566 for the
lecun-normal kernels (flax's ``fan_in``: a kernel's elements over its
output features, k * k * cin for a conv), sqrt(6 / (fan_in + fan_out))
for the xavier-uniform ``fcn_kernel``; every constant leaf (the biases
zero, the U-Net's BatchNorm scales one) equal to JAX's, exactly. No
other test holds the constructor's draw: the parity tests convert JAX's
weights or draw them from the seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models.fusion import model_from_options as jax_model_from_options
from prtp_tpu.options import get_options as jax_get_options
from prtp_tpu_torch.data.random_design import make_random_design
from prtp_tpu_torch.models import PathModel
from prtp_tpu_torch.models.fusion import model_from_options
from prtp_tpu_torch.options import get_options
from prtp_tpu_torch.utils.convert import params_from_flax

import _torch_threads  # noqa: F401  (one torch thread a worker)

SEEDS = 16
STD_SIGMAS = 5.0
# a float32 draw clamped at a float64 bound may round past it by an ulp
ULP = 1e-6
_TRUNC_STD = 0.87962566103423978
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# the golden fixture's widths (tests/test_torch_model.py); the U-Net
# halves its raster, so its map is half the raster's side
CELL_FEAT, NET_FEAT = 13, 3
WIDTHS = ["--out_dim", "16", "--hidden_dim", "32", "--cnn_outdim", "8"]
# (--attn adds one kernel, fc_attn2, drawn as every other Dense kernel)
VARIANTS = {
    "default": ["--map_size", "16"],
    "unet": ["--map_size", "8", "--unet"],
}
EXACT_VARIANTS = {
    **VARIANTS,
    "attn": ["--map_size", "16", "--attn", "--num_heads", "4"],
    "cls": ["--map_size", "16", "--task", "cls", "--nlabels", "2"],
    "no_gnn": ["--map_size", "16", "--no_gnn"],
    "no_cnn": ["--map_size", "16", "--no_cnn"],
}
EXACT_SEEDS = (0, 9294, 2**31 - 1)


def _jax_init(argv, seeds, compiler_options=None, **pack_kw):
    """``(jopts, parsed, params)``: JAX's ``model_from_options(argv)``
    initialised by ``jax.jit(model.init)`` under ``PRNGKey(s)`` for each
    of ``seeds`` (one vmapped compile; ``params`` has a leading seed
    axis), on a random design of two level pairs at the init's widths."""
    jopts = jax_get_options(argv)
    # the init reads only the widths: a design of two level pairs keeps
    # the traced forward short (a U-Net raster's side is 2 x map_size)
    side = 2 * jopts.map_size if jopts.unet else 4 * jopts.map_size
    parsed = make_random_design([4, 4, 3, 3], cell_feat_dim=CELL_FEAT,
                                net_feat_dim=NET_FEAT,
                                map_size=jopts.map_size,
                                cnn_channels=3 if jopts.unet else 2,
                                cnn_hw=side, mask_nnz_per_path=4, seed=0)
    design = jax_pack_design(parsed, map_size=jopts.map_size, align=8,
                             **pack_kw)
    pids = jnp.arange(design.num_paths, dtype=jnp.int32)
    model = jax_model_from_options(jopts)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    init = jax.jit(jax.vmap(lambda k: model.init(k, design, pids)))
    params = init.lower(keys).compile(compiler_options=compiler_options)(
        keys)
    return jopts, parsed, jax.tree_util.tree_map(np.asarray, params)


def _widths(parsed):
    """The design's cell and net feature widths and raster channels."""
    return (parsed["cell_feat"].shape[1], parsed["net_feat"].shape[1],
            parsed["cnn_input"].shape[0])


def _draws(argv):
    """``(jax, port)``: each package's SEEDS draws of every leaf, stacked
    on a leading axis under the port's names (the port's from its
    constructor's ``torch.Generator`` seeded with s)."""
    # the draws' distribution is the same at any optimization level; this
    # compiles several times faster (their bits are not: XLA contracts
    # other multiply-adds)
    jopts, parsed, variables = _jax_init(argv, range(SEEDS), FAST_COMPILE,
                                         cnn_patches=False)
    params = variables["params"]
    per_seed = [params_from_flax(jax.tree_util.tree_map(
        lambda x, s=s: x[s], params)) for s in range(SEEDS)]
    cell, net, channels = _widths(parsed)
    port = [PathModel(
        cell, net, out_dim=jopts.out_dim, hidden_dim=jopts.hidden_dim,
        cnn_outdim=jopts.cnn_outdim, map_size=jopts.map_size,
        unet=jopts.unet, cnn_channels=channels,
        generator=torch.Generator().manual_seed(s)).state_dict()
        for s in range(SEEDS)]
    jax_leaves = {k: np.stack([d[k].numpy() for d in per_seed])
                  for k in per_seed[0]}
    port_leaves = {k: np.stack([d[k].numpy() for d in port])
                   for k in port[0] if port[0][k].is_floating_point()}
    return jax_leaves, port_leaves


def _fans(key, shape):
    """``(fan_in, fan_out)`` of a kernel leaf as flax counts them, from its
    shape in the port: Linear ``(out, in)``, Conv2d ``(out, in, k, k)``,
    ConvTranspose2d ``(in, out, k, k)``, ``fcn_kernel (map^2, out)``."""
    if key == "fcn_kernel":
        return shape
    if "ConvTranspose" in key:
        return shape[0] * int(np.prod(shape[2:])), shape[1]
    return int(np.prod(shape[1:])), shape[0]


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def draws(request):
    return request.param, _draws(WIDTHS + VARIANTS[request.param])


def test_init_matches_flax_in_distribution(draws):
    variant, (jax_leaves, port_leaves) = draws
    # the running averages are the U-Net's BatchNorm state, not params
    stats = {k for k in port_leaves
             if k.endswith(("running_mean", "running_var"))}
    assert set(port_leaves) - stats == set(jax_leaves), variant
    random = 0
    for key, want in sorted(jax_leaves.items()):
        got = port_leaves[key]
        assert got.shape == want.shape, key
        if np.all(want == want[:1]):  # a constant init: zeros or ones
            assert np.array_equal(got, want), key
            continue
        random += 1
        fan_in, fan_out = _fans(key, want.shape[1:])
        bound = (np.sqrt(6.0 / (fan_in + fan_out)) if key == "fcn_kernel"
                 else 2.0 * np.sqrt(1.0 / fan_in) / _TRUNC_STD)
        for side, w in (("port", got), ("jax", want)):
            assert np.abs(w).max() <= bound * (1 + ULP), (key, side, bound)
        n = want.size
        ratio = got.std() / want.std()
        assert abs(ratio - 1) <= STD_SIGMAS / np.sqrt(2 * n), (
            key, variant, got.std(), want.std(), n)
    assert random >= 8, (variant, random)


@pytest.fixture(scope="module", params=sorted(EXACT_VARIANTS))
def jax_inits(request):
    """One variant's JAX init at every seed of EXACT_SEEDS, compiled as
    the train CLI's ``init_state`` compiles it (the default options: the
    bits of its multiply-adds depend on them), on the packed design's
    default layout (LayoutNet's ``StaticInputConv`` on its patch table)."""
    argv = WIDTHS + EXACT_VARIANTS[request.param]
    return argv, _jax_init(argv, EXACT_SEEDS)


@pytest.mark.parametrize("seed", range(len(EXACT_SEEDS)),
                         ids=[str(s) for s in EXACT_SEEDS])
def test_model_from_options_draws_jax_init_bit_for_bit(jax_inits, seed):
    argv, (_jopts, parsed, variables) = jax_inits
    pick = functools.partial(jax.tree_util.tree_map, lambda x: x[seed])
    want = params_from_flax(pick(variables["params"]),
                            pick(variables.get("batch_stats", {})))
    got = model_from_options(
        get_options(argv + ["--seed", str(EXACT_SEEDS[seed])]),
        *_widths(parsed)).state_dict()
    got = {k: v for k, v in got.items() if v.is_floating_point()}
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(
            got[key].numpy().view(np.uint32),
            want[key].numpy().view(np.uint32), err_msg=key)
