"""The port's init against flax's, in distribution: the train CLI's
``model_from_options(--seed s)`` and JAX's ``model.init(PRNGKey(s))``
over SEEDS seeds each, leaf by leaf (JAX's leaves under the port's names,
``utils/convert.py::params_from_flax``). Every random leaf's standard
deviation within STD_SIGMAS / sqrt(2 n) of JAX's, relative (n its
elements over the seeds); its largest |w| within its initializer's
bound in both packages: 2 sqrt(1 / fan_in) / 0.87962566 for the
lecun-normal kernels (flax's ``fan_in``: a kernel's elements over its
output features, k * k * cin for a conv), sqrt(6 / (fan_in + fan_out))
for the xavier-uniform ``fcn_kernel``; every constant leaf (the biases
zero, the U-Net's BatchNorm scales one) equal to JAX's, exactly. No
other test holds the init: the parity tests convert JAX's weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models.fusion import model_from_options as jax_model_from_options
from prtp_tpu.options import get_options as jax_get_options
from prtp_tpu_torch.data.random_design import make_random_design
from prtp_tpu_torch.models.fusion import model_from_options
from prtp_tpu_torch.options import get_options
from prtp_tpu_torch.utils.convert import params_from_flax

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


def _draws(argv):
    """``(jax, port)``: each package's SEEDS draws of every leaf, stacked
    on a leading axis under the port's names."""
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
                             cnn_patches=False)
    pids = jnp.arange(design.num_paths, dtype=jnp.int32)
    model = jax_model_from_options(jopts)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(SEEDS))
    init = jax.jit(jax.vmap(lambda k: model.init(k, design, pids)["params"]))
    # the draws are the same at any optimization level; this compiles
    # several times faster
    params = init.lower(keys).compile(compiler_options=FAST_COMPILE)(keys)
    params = jax.tree_util.tree_map(np.asarray, params)
    per_seed = [params_from_flax(jax.tree_util.tree_map(
        lambda x, s=s: x[s], params)) for s in range(SEEDS)]
    cnn_channels = parsed["cnn_input"].shape[0]
    port = [model_from_options(
        get_options(argv + ["--seed", str(s)]), parsed["cell_feat"].shape[1],
        parsed["net_feat"].shape[1], cnn_channels).state_dict()
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
