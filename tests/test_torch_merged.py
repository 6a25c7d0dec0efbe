"""The merged super-graph (``--merge_designs``) in the port against the
JAX package, on the CPU, on the tiny designs of ``tests/test_merged.py``:
the merge itself, the grouped forward (LayoutNet, and the U-Net whose
BatchNorm takes its statistics over the K rasters together), the merged
forward against each design alone, the grouped batches, merged train
steps and the bf16 grouped head.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu import trainer as jtrainer
from prtp_tpu.graph import merge_parsed_designs as jax_merge
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu_torch import trainer
from prtp_tpu_torch.graph import merge_parsed_designs, pack_design
from prtp_tpu_torch.models import PathModel
from prtp_tpu_torch.ops import KERNELS
from prtp_tpu_torch.utils.convert import params_from_flax

from test_merged import MODEL_KW, _grouped_ids
from test_models import _tiny_parsed_design
from test_torch_bf16 import BF, _nchw, assert_near_jax_bf16
from test_torch_bf16_model import _bf16_ulp, _Fixed
from test_torch_convert import jax_params
from test_torch_train import assert_steps_match_jax

K_DESIGNS = 3


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors the kernel wrappers run their plain versions."""
    yield
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def _designs(unet=False):
    """test_merged's designs: K_DESIGNS tiny designs of 7 paths, 2 x 64 x
    64 rasters, or 3 x 32 x 32 for the U-Net (which halves the raster to
    MODEL_KW's map of 16)."""
    rng = np.random.default_rng(13 if unet else 11)
    kw = dict(cnn_hw=32, cnn_ch=3) if unet else {}
    return [_tiny_parsed_design(rng, **kw) for _ in range(K_DESIGNS)]


def _assert_same(got, want, what):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert type(got) is type(want) and got == want, what


def test_merge_parsed_designs_matches_jax():
    """The port's copy against JAX's ``merge_parsed_designs``, key by
    key and array by array (dtypes too); designs of uneven depth, one of
    them with its own path universe; both refuse rasters of two shapes."""
    parsed = _designs()
    rng = np.random.default_rng(2)
    parsed.append(dict(_tiny_parsed_design(rng), path_ids=np.array([5, 1])))
    parsed[1] = dict(parsed[1], levels=parsed[1]["levels"][:3])
    want, got = jax_merge(parsed), merge_parsed_designs(parsed)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        _assert_same(got[key], val, key)
    assert got["cnn_input"].shape == (4, 2, 64, 64)
    odd = parsed[:1] + [_tiny_parsed_design(rng, cnn_hw=32)]
    for merge in (jax_merge, merge_parsed_designs):
        with pytest.raises(AssertionError, match="raster shape"):
            merge(odd)


@functools.lru_cache(maxsize=None)  # read-only, shared by the tests
def _merged_case(unet):
    """The merged design (parsed by the port, JAX's exact pack of JAX's
    merge), grouped ids of every path and a jittered JAX init (running
    averages too)."""
    parsed = _designs(unet)
    merged = merge_parsed_designs(parsed)
    d_jax = jax_pack_design(jax_merge(parsed), map_size=16,
                            exact_levels=True)
    gids, gmask = _grouped_ids(parsed, max(p["num_paths"] for p in parsed))
    kw = dict(MODEL_KW, unet=unet)
    variables = jax_params(JaxPathModel(**kw), d_jax, gids)
    return parsed, merged, d_jax, gids, gmask, kw, variables


def _port_model(kw, variables, dtype=None):
    model = PathModel(10, 3, cnn_channels=3 if kw["unet"] else 2,
                      compute_dtype=dtype, **kw)
    model.load_state_dict(params_from_flax(variables["params"],
                                           variables.get("batch_stats")))
    return model


@pytest.mark.parametrize("unet,train", [(False, False), (True, True),
                                        (True, False)],
                         ids=["layoutnet", "unet_train", "unet_eval"])
def test_merged_forward_matches_jax_grouped(unet, train):
    """The port's grouped forward on its merged pack against JAX's
    grouped ``PathModel`` (``path_ids`` (K, Bk), row k reading feature
    map k) on converted weights, rtol/atol 1e-5. The U-Net in train mode
    normalises with the statistics of the K rasters together, and its
    running averages after the forward match flax's too."""
    _p, merged, d_jax, gids, _m, kw, variables = _merged_case(unet)
    model = JaxPathModel(**kw)
    if train:
        want, upd = model.apply(variables, d_jax, gids, train=True,
                                mutable=["batch_stats"])
        want_stats = params_from_flax({}, upd["batch_stats"])
    else:
        want = model.apply(variables, d_jax, gids)
    port = _port_model(kw, variables).train(train)
    design = pack_design(merged, map_size=16, device="cpu")
    assert design.cnn_input.shape[0] == K_DESIGNS
    with torch.no_grad():
        got = port(design, torch.from_numpy(np.asarray(gids, np.int64)))
    assert got.shape == want.shape == gids.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if train:
        buffers = dict(port.named_buffers())
        assert want_stats
        for key, val in want_stats.items():
            np.testing.assert_allclose(buffers[key].numpy(), val.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("unet", [False, True], ids=["layoutnet",
                                                      "unet_eval"])
def test_merged_forward_matches_each_design_alone(unet):
    """Each design's rows of the port's merged forward against the port's
    forward on that design packed alone, at test_merged's bound (rtol
    1e-4, atol 1e-5); the U-Net in eval mode (in train mode its batch
    statistics take the K rasters together, so they differ by design).
    Flat ids on a merged design raise, as in JAX."""
    parsed, merged, _d, gids, _m, kw, variables = _merged_case(unet)
    port = _port_model(kw, variables).eval()
    design = pack_design(merged, map_size=16, device="cpu")
    with torch.no_grad():
        out = port(design, torch.from_numpy(np.asarray(gids, np.int64)))
        for i, p in enumerate(parsed):
            alone = pack_design(p, map_size=16, device="cpu")
            one = port(alone, torch.arange(p["num_paths"]))
            np.testing.assert_allclose(out[i, :p["num_paths"]].numpy(),
                                       one.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"design {i}")
        with pytest.raises(ValueError, match="grouped path_ids"):
            port(design, torch.arange(4))


def test_iterate_grouped_batches_matches_jax():
    """The same rounds as JAX's ``iterate_grouped_batches`` from one
    numpy seed (universes of 7, 3 and 5 paths in batches of 2: four
    rounds, the shorter universes padded with zero-mask rows once
    exhausted), and the generator left in the same state."""
    universes = [np.arange(7), np.arange(7, 10) * 2, np.arange(20, 25)]
    rng_j, rng_p = np.random.default_rng(0), np.random.default_rng(0)
    want = list(jtrainer.iterate_grouped_batches(universes, 2, rng_j))
    got = list(trainer.iterate_grouped_batches(universes, 2, rng_p, "cpu"))
    assert len(got) == len(want) == 4
    for (ids, mask), (jids, jmask) in zip(got, want):
        assert ids.shape == mask.shape == (3, 2)
        assert ids.dtype == torch.int64 and mask.dtype == torch.float32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert float(got[-1][1][1].sum()) == 0.0
    assert rng_p.integers(1 << 30) == rng_j.integers(1 << 30)


@pytest.mark.parametrize("task", ["reg", "cls"])
def test_merged_train_steps_match_jax_make_train_step(task):
    """Three steps on the merged design, grouped (K, 4) batches from
    JAX's iterator, from a converted init: the port's ``train_step`` and
    ``train_steps`` against JAX's ``make_train_step`` with the bounds of
    ``tests/test_torch_train.py`` (first-step gradients, each loss,
    final parameters); ``cls`` with 2 logits and the cross-entropy."""
    parsed = _designs()
    merged = merge_parsed_designs(parsed)
    d_jax = jax_pack_design(jax_merge(parsed), map_size=16,
                            exact_levels=True)
    kw = dict(MODEL_KW, nlabels=2 if task == "cls" else 1)
    rng = np.random.default_rng(0)
    batches = []
    while len(batches) < 3:
        batches += [(np.asarray(i), np.asarray(m)) for i, m in
                    jtrainer.iterate_grouped_batches(
                        merged["path_ids_per_design"], 4, rng)]
    gids = jnp.asarray(batches[0][0])
    variables = jax_params(JaxPathModel(**kw), d_jax, gids)
    got, want = assert_steps_match_jax(merged, kw, variables, d_jax,
                                       batches[:3], task=task)
    assert [m["tp"] + m["fp"] + m["tn"] + m["fn"] for m in got] == \
        [float(m.sum()) for _i, m in batches[:3]]


def test_bf16_grouped_head_matches_jax():
    """The bf16 model on the merged design against JAX's
    ``PathModel(compute_dtype=bfloat16)`` with grouped ids (its exact
    pack: the fused walk, the port's default rounding): predictions
    within 4 bf16 ulps of max |out|, as the flat model's test holds them;
    and the head (each design's fcn product rounded once, the bias sum
    once, as the flat head's; ``mlp_alpha``, ``mlp_fuse``) run by the port
    on JAX's bf16 layout maps and h, within REL_GAP x JAX's own
    bf16-to-float32 distance."""
    _p, merged, d_jax, gids, _m, kw, variables = _merged_case(False)
    out, parts = {}, {}
    for dt in (jnp.bfloat16, None):
        out[dt], st = JaxPathModel(compute_dtype=dt, **kw).apply(
            variables, d_jax, gids,
            capture_intermediates=lambda m, _n: m.name in ("gnn", "cnn"),
            mutable=["intermediates"])
        parts[dt] = {k: v["__call__"][0]
                     for k, v in st["intermediates"].items()}
    port = _port_model(kw, variables, "bfloat16")
    design = pack_design(merged, map_size=16, device="cpu")
    ids = torch.from_numpy(np.asarray(gids, np.int64))
    with torch.no_grad():
        got = port(design, ids)
    want = np.asarray(out[jnp.bfloat16])
    assert got.dtype == torch.float32 and got.shape == want.shape
    ulp = _bf16_ulp(float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= 4 * ulp
    port.cnn = _Fixed(torch.tensor(_nchw(parts[jnp.bfloat16]["cnn"])).to(BF))
    port.gnn = _Fixed(torch.tensor(np.asarray(parts[jnp.bfloat16]["gnn"])))
    with torch.no_grad():
        head = port(design, ids)
    assert_near_jax_bf16(head, want, out[None], "grouped head")
