"""The port's training slice against the JAX package: Conv_0 against
JAX's two routes, train steps from a converted init, the batch
iterators, the design cache, and the entry points' refusal to run
without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prtp_tpu import trainer as jtrainer
from prtp_tpu.graph import make_cnn_patches as jax_make_cnn_patches
from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models import PathModel as JaxPathModel
from prtp_tpu.models.layoutnet import StaticInputConv as JaxStaticInputConv
from prtp_tpu_torch import test as port_test
from prtp_tpu_torch import trainer
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models import PathModel
from prtp_tpu_torch.models.layoutnet import conv2d
from prtp_tpu_torch.ops import KERNELS
from prtp_tpu_torch.utils.convert import params_from_flax

from test_torch_convert import jax_params
from test_torch_graph import golden_parsed
from test_torch_model import MAP_SIZE, MODEL_KW

import _torch_threads  # noqa: F401  (one torch thread a worker)

LR = 1e-3
STEPS = 5
BATCH = 4


# ---- Conv_0 against JAX's patch-table and convolution routes ----

@pytest.fixture(scope="module")
def conv_case():
    """A 2-channel raster, a jittered JAX StaticInputConv(32, 9) and its
    forward and kernel gradient for a random cotangent, by each of JAX's
    routes: ``patches`` (the product with the pack-time patch table,
    JAX's default) and ``conv2d`` (``lax.conv_general_dilated``)."""
    rng = np.random.default_rng(0)
    x = rng.random((1, 2, 24, 20), dtype=np.float32)  # NCHW
    cot = rng.normal(size=(1, 32, 24, 20)).astype(np.float32)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    conv = JaxStaticInputConv(32, 9)
    params = jax.jit(conv.init)(jax.random.PRNGKey(1), x_nhwc)["params"]
    params = {"kernel": params["kernel"],
              "bias": 0.1 * jax.random.normal(jax.random.PRNGKey(2), (32,))}
    cot_nhwc = jnp.asarray(cot.transpose(0, 2, 3, 1))
    to_np = lambda t: np.array(t, np.float32)  # noqa: E731
    want = {}
    for route, patches in (("patches", jax_make_cnn_patches(x_nhwc)),
                           ("conv2d", None)):
        def loss(p, patches=patches):
            out = conv.apply({"params": p}, x_nhwc, patches)
            return (out * cot_nhwc).sum(), out

        (_l, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
        want[route] = (to_np(out).transpose(0, 3, 1, 2),
                       to_np(grads["kernel"]))
    return x, cot, to_np(params["kernel"]), to_np(params["bias"]), want


@pytest.mark.parametrize("route", ["patches", "conv2d"])
def test_static_input_conv_matches_jax(conv_case, route):
    """The port's Conv_0 (``F.conv2d`` through autograd: it builds no
    patch table) against JAX's StaticInputConv by each of its routes,
    forward and kernel gradient, rtol/atol 1e-5 (float32 products of 162
    terms summed in another order)."""
    x, cot, kernel, bias, want = conv_case
    want_out, want_grad = want[route]
    conv = conv2d(2, 32, 9, torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(bias))
    out = conv(torch.from_numpy(x))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5,
                               atol=1e-5)
    got_grad = conv.weight.grad.numpy().transpose(2, 3, 1, 0)  # -> HWIO
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-5)


# ---- train steps against JAX make_train_step ----

@pytest.fixture(scope="module")
def golden_train():
    """The golden design, a jittered JAX init (test_torch_model's), the
    exact JAX pack with its patch table (JAX's default Conv_0 route; the
    port's is ``F.conv2d``), and STEPS distinct batches of
    BATCH paths (JAX's iterator, numpy seed 0, several epochs)."""
    parsed = golden_parsed(MAP_SIZE)
    padded = jax_pack_design(parsed, map_size=MAP_SIZE, align=8)
    variables = jax_params(JaxPathModel(**MODEL_KW), padded,
                           jnp.arange(padded.num_paths, dtype=jnp.int32))
    exact = jax_pack_design(parsed, map_size=MAP_SIZE, exact_levels=True)
    assert exact.cnn_patches is not None
    rng = np.random.default_rng(0)
    batches = []
    while len(batches) < STEPS:
        batches += [(np.asarray(i), np.asarray(m)) for i, m in
                    jtrainer.iterate_batches(np.arange(parsed["num_paths"]),
                                             BATCH, rng)]
    return parsed, variables, exact, batches[:STEPS]


def jax_steps(model_kw, variables, exact, batches, flat=True, task="reg"):
    """JAX's ``make_train_step`` over ``batches`` from ``variables``:
    each step's metrics (numpy), the first step's gradients and the
    parameters after the last step (port names and layouts)."""
    model = JaxPathModel(**model_kw)
    tx = jtrainer.make_optimizer(LR, flat=flat)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jtrainer.TrainState(
        params=params, batch_stats={}, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32), best_f1=jnp.zeros(()),
        best_r2=jnp.zeros(()))
    step = jtrainer.make_train_step(model, tx, task, donate=False)
    mets, first_grads = [], None
    for i, (ids, mask) in enumerate(batches):
        if i == 0:
            def loss_fn(p):
                preds = model.apply({"params": p}, exact, jnp.asarray(ids))
                return jtrainer._task_loss_and_metrics(
                    task, preds, exact, jnp.asarray(ids), jnp.asarray(mask))[0]
            first_grads = jax.jit(jax.grad(loss_fn))(state.params)
        state, m = step(state, exact, jnp.asarray(ids), jnp.asarray(mask))
        mets.append({k: float(v) for k, v in m.items()})
    return (mets, params_from_flax(first_grads),
            params_from_flax(jax.tree_util.tree_map(np.asarray, state.params)))


def assert_steps_match_jax(parsed, model_kw, variables, exact, batches,
                           flat=True, task="reg", param_atol=2e-5):
    """The port's steps (``train_step``, then ``train_steps``) from the
    converted ``variables`` against :func:`jax_steps`, with the bounds of
    :func:`test_train_steps_match_jax_make_train_step` (the final
    parameters' atol ``param_atol``). Returns the two runs' per-step
    metrics (port's as host floats, JAX's)."""
    want_mets, want_grads, want_params = jax_steps(model_kw, variables,
                                                   exact, batches, flat, task)
    model = PathModel(parsed["cell_feat"].shape[1],
                      parsed["net_feat"].shape[1], **model_kw)
    model.load_state_dict(params_from_flax(variables["params"]))
    state = trainer.init_state(model, trainer.make_optimizer(LR),
                               device="cpu")
    assert isinstance(state.optimizer, trainer.FlatAdam)
    design = pack_design(parsed, map_size=model_kw["map_size"], device="cpu",
                         segment=model_kw.get("gnn_reduce") == "segment")
    port_batches = [(torch.from_numpy(i.astype(np.int64)),
                     torch.from_numpy(m.copy())) for i, m in batches]
    first = trainer.train_step(state, design, *port_batches[0], task=task)
    for key, p in model.named_parameters():
        g, want = p.grad.numpy(), want_grads[key].numpy()
        np.testing.assert_allclose(g, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)
    mets = trainer.train_steps(state, design, port_batches[1:], task)
    assert state.step == len(batches)
    assert set(mets) == {"loss", "r2", "tp", "fp", "tn", "fn"}
    assert mets["loss"].shape == (len(batches) - 1,)
    got_mets = [{k: float(v) for k, v in first.items()}] + [
        {k: float(v[i]) for k, v in mets.items()}
        for i in range(len(batches) - 1)]
    np.testing.assert_allclose([m["loss"] for m in got_mets],
                               [m["loss"] for m in want_mets], rtol=1e-5)
    for key, p in model.state_dict().items():
        got, want = p.numpy(), want_params[key].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 * LR * len(batches), err_msg=key)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=param_atol,
                                   err_msg=key)
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    return got_mets, want_mets


@pytest.mark.parametrize("flat", [True, False])
def test_train_steps_match_jax_make_train_step(golden_train, flat):
    """STEPS float32 steps on the golden design from a converted init,
    the port's flat Adam against JAX's ``make_flat_adam`` (``flat``) and
    its optax chain, which computes the same math: the first step's
    gradients leaf by leaf at rtol 1e-4 and atol 1e-5 x the leaf's
    largest |g| (float32 sums of up to thousands of terms, a conv's
    weight gradient, taken in another order); each step's loss at rtol
    1e-5; the parameters after the last step at atol 2e-5 + rtol 1e-4.
    Adam moves a weight by about LR a step whatever the size of its
    gradient, so a gradient whose sign rounding could flip would move it
    by up to 2 x LR: the final parameters also hold every weight within
    2 x LR x STEPS, and that bound is only a backstop."""
    parsed, variables, exact, batches = golden_train
    assert_steps_match_jax(parsed, MODEL_KW, variables, exact, batches, flat)


@pytest.mark.parametrize("ablation", ["no_cnn", "no_gnn"])
def test_ablation_train_steps_match_jax(golden_train, ablation):
    """The recorded configs ``reg_gnn_only`` (``--no_cnn``) and
    ``reg_cnn_only`` (``--no_gnn``): STEPS steps from a converted init of
    the ablated model, with the bounds of the full model's test."""
    parsed, _v, exact, batches = golden_train
    kw = dict(MODEL_KW, use_cnn=ablation != "no_cnn",
              use_gnn=ablation != "no_gnn")
    padded = jax_pack_design(parsed, map_size=MAP_SIZE, align=8)
    variables = jax_params(JaxPathModel(**kw), padded,
                           jnp.arange(padded.num_paths, dtype=jnp.int32))
    assert_steps_match_jax(parsed, kw, variables, exact, batches)


def test_flat_adam_keeps_parameters_and_grads_as_views():
    """FlatAdam's update runs on one vector: every parameter and its
    .grad are views of the optimizer's two flat buffers, through
    backward and step."""
    model = PathModel(10, 3, **MODEL_KW)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = trainer.init_state(model, trainer.make_optimizer(LR),
                               device="cpu")
    opt = state.optimizer
    params = list(model.parameters())
    assert opt.flat.numel() == sum(p.numel() for p in params)
    for key, val in model.state_dict().items():
        torch.testing.assert_close(val, before[key], rtol=0, atol=0)
    sum(p.sum() for p in params).backward()
    np.testing.assert_array_equal(opt.grad.numpy(), 1.0)
    opt.step()
    off = 0
    for p in params:
        assert p.data_ptr() == opt.flat[off:].data_ptr()
        assert p.grad.data_ptr() == opt.grad[off:].data_ptr()
        off += p.numel()
    # Adam's first step moves every weight by lr * g / (|g| + eps)
    np.testing.assert_allclose(
        torch.cat([(p.detach() - before[k]).reshape(-1)
                   for k, p in model.named_parameters()]).numpy(),
        -LR, rtol=1e-4)
    opt.zero_grad()
    assert not opt.grad.any()


# ---- batches, the cache, the card ----

@pytest.mark.parametrize("n,batch,drop_last", [(10, 4, False), (10, 4, True),
                                               (3, 8, False), (12, 4, False)])
def test_batches_match_jax(n, batch, drop_last):
    """The same numpy seed gives JAX's ids and masks exactly."""
    assert trainer.batch_count(n, batch, drop_last) == \
        jtrainer.batch_count(n, batch, drop_last)
    want = list(jtrainer.iterate_batches(np.arange(n) + 100, batch,
                                         np.random.default_rng(5),
                                         drop_last=drop_last))
    got = list(trainer.iterate_batches(np.arange(n) + 100, batch,
                                       np.random.default_rng(5),
                                       drop_last=drop_last, device="cpu"))
    assert len(got) == len(want) == trainer.batch_count(n, batch, drop_last)
    for (ids, mask), (jids, jmask) in zip(got, want):
        assert ids.dtype == torch.int64 and mask.dtype == torch.float32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    ids, mask = trainer.pad_batch(np.array([7, 3]), 5, device="cpu")
    jids, jmask = jtrainer.pad_batch(np.array([7, 3]), 5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert port_test.pad_batch is trainer.pad_batch


def test_design_cache_prefetches_and_reraises_at_get():
    packed = []
    cache = trainer.DesignCache(lambda parsed: packed.append(parsed) or
                                len(packed))
    try:
        cache.prefetch("a", lambda: "A")
        cache.prefetch("a", lambda: "never")  # idempotent
        assert cache.get("a", lambda: "never") == (1, "A")
        assert cache.get("a", lambda: "never") == (1, "A")  # cached

        def broken():
            raise OSError("no such design")

        cache.prefetch("b", broken)
        with pytest.raises(OSError, match="no such design"):
            cache.get("b", lambda: "never")
        assert cache.get("c", lambda: "C") == (2, "C")  # no prefetch
        assert cache.get("c", lambda: "never") == (2, "C")
    finally:
        cache.close()


def test_trainer_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card, so the CUDA default is valid")
    model = PathModel(10, 3, **MODEL_KW)
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.init_state(model, trainer.make_optimizer(LR))
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.pad_batch(np.arange(3), 4)
    with pytest.raises(RuntimeError, match="cuda"):
        next(trainer.iterate_batches(np.arange(3), 4,
                                     np.random.default_rng(0)))
