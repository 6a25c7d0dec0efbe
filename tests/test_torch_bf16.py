"""``--compute_dtype bfloat16`` in the port against the JAX package's
bfloat16, on the CPU: the rounding points, the walk and the packing
(the layout CNNs, the whole model and training:
``tests/test_torch_bf16_model.py``).

The port's bf16 is held against JAX's bf16, never against float32, and
where a comparison could be loose it also computes JAX's own float32
result on the same inputs and asserts that the port's mean distance
from JAX's bf16 is at most ``REL_GAP`` x the mean distance between
JAX's bf16 and JAX's float32: a port that rounds at another place than
JAX moves most elements about as far from JAX's bf16 as float32 does,
and fails. (The mean, not the largest: where a result is itself
rounded to bf16, one element whose float32 sum was taken in another
order can round one ulp the other way, about as far as float32 lies.)

- The rounding points, bit for bit: flax's ``Dense``, ``Conv`` and
  ``ConvTranspose`` with ``dtype=bfloat16`` (product rounded, bias added,
  rounded again), ``BatchNorm(dtype=bfloat16)`` in train and eval mode,
  JAX's bf16 ``leaky_relu`` and both average-pool paths. Their inputs
  lie on a grid (few mantissa bits), so that every float32 sum is exact
  whatever its order: the only roundings left are the ones the test is
  about.
- The walk (bf16 operands, float32 products and carry) forward and
  backward against ``fused_exact_gnn`` with config element 5
  ``'bfloat16'``, with and without ``--attn``, with and without prior
  rows.
- The bf16 packing.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from prtp_tpu.graph import pack_design as jax_pack_design
from prtp_tpu.models.gnn import TimeGNN as JaxTimeGNN
from prtp_tpu.ops.pool import pool_2x2 as jax_pool_2x2
from prtp_tpu_torch.graph import pack_design
from prtp_tpu_torch.models import TimeGNN
from prtp_tpu_torch.models.layoutnet import conv2d, leaky_relu
from prtp_tpu_torch.models.mlp import MLP, dense_bf16
from prtp_tpu_torch.models.unet import BatchNorm, ConvTranspose2d
from prtp_tpu_torch.ops import KERNELS
from prtp_tpu_torch.ops.pool import pool_2x2
from prtp_tpu_torch.utils.convert import params_from_flax

from test_torch_convert import small_parsed
from test_torch_gnn import HID, OUT, _grad_case

BF = torch.bfloat16
# the port's distance from JAX's bf16, at most this share of JAX's own
# bf16-to-float32 distance
REL_GAP = 0.1


@pytest.fixture(autouse=True)
def no_launches():
    """On CPU tensors the kernel wrappers run their plain versions."""
    yield
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)


def _np(t):
    return np.asarray(t, dtype=np.float32) if not torch.is_tensor(t) else \
        t.detach().float().numpy()


def _differ(a, b) -> int:
    return int((_np(a) != _np(b)).sum())


def _grid(rng, shape, steps, scale):
    """Values ``k * scale`` with integer ``|k| <= steps``, float32."""
    return (rng.integers(-steps, steps + 1, shape) * scale).astype(np.float32)


def _nchw(x):
    return np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2))


def _nhwc(x):
    return np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 2, 3, 1))


def assert_near_jax_bf16(got, want16, want32, what):
    """``got`` (the port's bf16 result) against JAX's bf16 ``want16``:
    its mean absolute distance within REL_GAP x that of JAX's float32
    ``want32``. Returns the two distances."""
    got, want16, want32 = _np(got), _np(want16), _np(want32)
    assert got.shape == want16.shape == want32.shape, what
    assert np.all(np.isfinite(got)), what
    gap = float(np.abs(want16 - want32).mean())
    dist = float(np.abs(got - want16).mean())
    assert gap > 0, f"{what}: bf16 and float32 agree, the test is blind"
    assert dist <= REL_GAP * gap, (
        f"{what}: {dist:.3g} from JAX's bf16, whose distance from its "
        f"float32 is {gap:.3g} (allowed {REL_GAP} x)")
    return dist, gap


# ---- the rounding points, bit for bit ----

@pytest.mark.parametrize("din,dout", [(37, 256), (256, 128), (384, 20)])
def test_dense_bf16_matches_flax_dense(din, dout):
    """``dense_bf16`` and the port's bf16 ``MLP`` layer against flax's
    ``Dense(dtype=bfloat16)``: the output and both gradients, 0 elements
    different. ``F.linear`` with the bf16 bias (one rounding) differs."""
    rng = np.random.default_rng(din)
    x = _grid(rng, (24, din), 32, 1 / 8)
    kernel = _grid(rng, (din, dout), 64, 1 / 64)
    bias = _grid(rng, (dout,), 512, 1 / 128)
    cot = _grid(rng, (24, dout), 8, 1 / 4)
    dense = nn.Dense(dout, dtype=jnp.bfloat16)
    params = {"params": {"kernel": jnp.asarray(kernel),
                         "bias": jnp.asarray(bias)}}

    def f(p, x):
        return dense.apply(p, x)

    want, vjp = jax.vjp(f, params, jnp.asarray(x))
    d_params, d_x = vjp(jnp.asarray(cot, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    w = torch.tensor(kernel.T.copy(), requires_grad=True)
    b = torch.tensor(bias, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    got = dense_bf16(xt, w, b)
    assert got.dtype == BF
    assert _differ(got, want) == 0
    got.backward(torch.tensor(cot).to(BF))
    assert w.grad.dtype == b.grad.dtype == torch.float32
    assert _differ(w.grad.t(), d_params["params"]["kernel"]) == 0
    assert _differ(b.grad, d_params["params"]["bias"]) == 0
    assert _differ(xt.grad, d_x) == 0
    once = F.linear(xt.detach().to(BF), w.detach().to(BF), b.detach().to(BF))
    assert _differ(once, want) > want.size // 20
    mlp = MLP(din, (dout,), torch.Generator(), compute_dtype="bfloat16")
    mlp.load_state_dict({"fc0.weight": w.detach(), "fc0.bias": b.detach()})
    with torch.no_grad():
        assert _differ(mlp(torch.tensor(x)), want) == 0


def _flax_conv(kind, cin, cout):
    if kind == "conv_transpose":
        return nn.ConvTranspose(cout, (2, 2), strides=(2, 2),
                                dtype=jnp.bfloat16)
    k = 7 if kind == "conv" else 3
    return nn.Conv(cout, (k, k), padding="SAME", use_bias=kind == "conv",
                   dtype=jnp.bfloat16)


@pytest.mark.parametrize("kind", ["conv", "conv_no_bias", "conv_transpose"])
def test_conv_bf16_matches_flax(kind):
    """The port's bf16 convolutions against flax's with
    ``dtype=bfloat16``: LayoutNet's biased 7x7 conv, the U-Net's 3x3 conv
    without a bias and its 2x2 stride-2 ConvTranspose; the output and
    the weight and input gradients, 0 elements different. A conv with
    its bf16 bias inside (one rounding) differs."""
    rng = np.random.default_rng(len(kind))
    cin, cout = 6, 5
    x = _grid(rng, (1, 12, 10, cin), 16, 1 / 8)
    module = _flax_conv(kind, cin, cout)
    variables = jax.tree_util.tree_map(
        np.asarray, module.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    kernel = _grid(rng, variables["params"]["kernel"].shape, 64, 1 / 128)
    params = {"kernel": jnp.asarray(kernel)}
    if "bias" in variables["params"]:
        params["bias"] = jnp.asarray(_grid(rng, (cout,), 256, 1 / 64))

    def f(p, x):
        return module.apply({"params": p}, x)

    want, vjp = jax.vjp(f, params, jnp.asarray(x))
    cot = _grid(rng, want.shape, 8, 1 / 4)
    d_params, d_x = vjp(jnp.asarray(cot, jnp.bfloat16))
    if kind == "conv_transpose":
        conv = nn_conv_transpose(cin, cout)
        w = torch.tensor(np.ascontiguousarray(
            kernel[::-1, ::-1].transpose(2, 3, 0, 1)))
    else:
        conv = conv2d(cin, cout, kernel.shape[0], torch.Generator(),
                      bias=kind == "conv", compute_dtype=BF)
        w = torch.tensor(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    with torch.no_grad():
        conv.weight.copy_(w)
        if conv.bias is not None:
            conv.bias.copy_(torch.tensor(np.asarray(params["bias"])))
    xt = torch.tensor(_nchw(x), requires_grad=True)
    got = conv(xt)
    assert got.dtype == BF
    assert _differ(got, _nchw(want)) == 0
    got.backward(torch.tensor(_nchw(cot)).to(BF))
    assert _differ(xt.grad, _nchw(d_x)) == 0
    d_kernel = np.asarray(d_params["kernel"], np.float32)
    want_w = (d_kernel[::-1, ::-1].transpose(2, 3, 0, 1)
              if kind == "conv_transpose" else d_kernel.transpose(3, 2, 0, 1))
    assert _differ(conv.weight.grad, want_w) == 0
    if conv.bias is not None:
        assert _differ(conv.bias.grad, d_params["bias"]) == 0
        with torch.no_grad():
            xb, wb = xt.to(BF), conv.weight.to(BF)
            bb = conv.bias.to(BF)
            once = (F.conv_transpose2d(xb, wb, bb, stride=2)
                    if kind == "conv_transpose"
                    else F.conv2d(xb, wb, bb, padding=3))
        assert _differ(once, _nchw(want)) > want.size // 20


def nn_conv_transpose(cin, cout):
    conv = torch.nn.utils.skip_init(ConvTranspose2d, cin, cout, 2, stride=2)
    conv.compute_dtype = BF
    return conv


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_bf16_matches_flax(train):
    """``BatchNorm(compute_dtype=bfloat16)`` against flax's
    ``BatchNorm(momentum=0.9, dtype=bfloat16)``: the output 0 elements
    different; in train mode the running averages after the call at
    1e-6 (float32, the same statistics). The float32 normalisation of
    ``F.batch_norm`` and ``torch.rsqrt`` on the CPU round otherwise and
    differ in a few elements."""
    rng = np.random.default_rng(5)
    x = _grid(rng, (2, 16, 8, 6), 32, 1 / 8) + 1.0
    scale = _grid(rng, (6,), 64, 1 / 32)
    bias = _grid(rng, (6,), 64, 1 / 32)
    mean0 = _grid(rng, (6,), 16, 1 / 16)
    var0 = np.abs(_grid(rng, (6,), 16, 1 / 16)) + 0.5
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                      dtype=jnp.bfloat16)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    xb = jnp.asarray(x, jnp.bfloat16)
    if train:
        want, upd = bn.apply(variables, xb, mutable=["batch_stats"])
    else:
        want, upd = bn.apply(variables, xb), None
    port = BatchNorm(6, compute_dtype="bfloat16").train(train)
    with torch.no_grad():
        port.weight.copy_(torch.tensor(scale))
        port.bias.copy_(torch.tensor(bias))
        port.running_mean.copy_(torch.tensor(mean0))
        port.running_var.copy_(torch.tensor(var0))
    got = port(torch.tensor(_nchw(x)).to(BF))
    assert got.dtype == BF
    assert _differ(got, _nchw(want)) == 0
    if train:
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(port, name).numpy(),
                np.asarray(upd["batch_stats"][key]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw", [(12, 10), (13, 11)], ids=["even", "odd"])
@pytest.mark.parametrize("pooling", ["avg", "max"])
def test_pools_bf16_match_jax(pooling, hw):
    """``pool_2x2`` on bf16 against ``prtp_tpu/ops/pool.py`` on bf16 at
    even extents (the reshaped mean or max) and odd ones (the windowed
    fallback: JAX's ``avg_pool`` adds the window in order with a rounding
    after each add): 0 elements different; ``F.avg_pool2d`` on bf16
    differs at odd extents."""
    rng = np.random.default_rng(hw[0])
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    want = jax_pool_2x2(jnp.asarray(x, jnp.bfloat16), pooling)
    assert want.dtype == jnp.bfloat16
    xt = torch.tensor(_nchw(x)).to(BF)
    got = pool_2x2(xt, pooling)
    assert got.dtype == BF
    assert _differ(got, _nchw(want)) == 0
    if pooling == "avg" and hw[0] % 2:
        assert _differ(F.avg_pool2d(xt, 2), _nchw(want)) > 0


def test_leaky_relu_bf16_matches_jax():
    """LayoutNet's last activation in bf16: JAX rounds the slope 0.1 to
    bf16 before the product, so ``F.leaky_relu`` differs; the port's
    ``leaky_relu`` gives JAX's bits, and float32 is ``F.leaky_relu``."""
    x = np.random.default_rng(0).normal(size=(4, 1000)).astype(np.float32)
    want = jax.nn.leaky_relu(jnp.asarray(x, jnp.bfloat16), negative_slope=0.1)
    xt = torch.tensor(x).to(BF)
    assert _differ(leaky_relu(xt, 0.1), want) == 0
    assert _differ(F.leaky_relu(xt, 0.1), want) > 100
    x32 = torch.tensor(x)
    assert torch.equal(leaky_relu(x32, 0.1), F.leaky_relu(x32, 0.1))


# ---- the walk ----

def _jax_walk_model(nh, dtype):
    return JaxTimeGNN(out_dim=OUT, hidden_dim=HID, dgl_parity=True,
                      flag_attn=nh > 0, num_heads=max(nh, 1),
                      fused_vjp=True, mlp_dtype=dtype)


@functools.lru_cache(maxsize=None)
def _walk_case(which, nh):
    """A graph (port and JAX packs), jittered JAX params of a TimeGNN
    (``--attn`` with ``nh`` heads, or the softmax reduce at 0), h0 and a
    cotangent."""
    graph, g_jax, cfd = _grad_case(which)
    v = jax.jit(_jax_walk_model(nh, None).init)(jax.random.PRNGKey(0), g_jax)
    leaves, treedef = jax.tree_util.tree_flatten(v)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    v = jax.tree_util.tree_unflatten(
        treedef, [l + 0.1 * jax.random.normal(k, l.shape, l.dtype)
                  for l, k in zip(leaves, keys)])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    rng = np.random.default_rng(8)
    n1 = graph.num_rows + 1
    h0 = (0.3 * rng.normal(size=(n1, OUT))).astype(np.float32)
    cot = rng.normal(size=(n1, OUT)).astype(np.float32)
    return graph, g_jax, cfd, params, h0, cot


def _jax_walk_grads(g_jax, nh, dtype, params, h0, cot):
    model = _jax_walk_model(nh, dtype)

    def loss(p, h0):
        return (model.apply({"params": p}, g_jax, h0) * cot).sum()

    hf = jax.jit(model.apply)({"params": params}, g_jax, jnp.asarray(h0))
    d_params, d_h0 = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(h0))
    grads = params_from_flax({"gnn": jax.tree_util.tree_map(np.asarray,
                                                            d_params)})
    return np.asarray(hf), grads, np.asarray(d_h0)


WALK_CASES = [("no_prior", 0), ("prior", 0), ("no_prior", 1), ("prior", 1),
              ("no_prior", 2), ("prior", 2)]


@pytest.mark.parametrize("which,nh", WALK_CASES)
def test_bf16_walk_matches_jax(which, nh):
    """The port's ``TimeGNN(mlp_dtype=bfloat16)`` against JAX's (the
    fused exact path: ``_forward_impl`` and ``_bwd`` with config element
    5 ``'bfloat16'``), softmax or ``--attn`` with 1 and 2 heads, on a
    design without and with prior rows. Both compute exact products of
    bf16 operands summed in float32, so the forward holds at
    1e-5 x max |h| (measured 1.6e-8 to 8.3e-8) and the gradients at
    rtol 2e-4 and atol 1e-5 x the leaf's max |g| (the float32 tests'
    bounds). A float32 sum taken in another order can round an operand
    of a later product to the other bf16 neighbour: one such flip moves
    that product's terms by a bf16 ulp (2^-8) of the operand, which the
    float32 sum then carries at its own size, so the results stay at
    float32 noise (the measured h above, with such flips in the
    walk's later pairs). All also lie within REL_GAP x JAX's
    bf16-to-float32 distance."""
    graph, g_jax, cfd, params, h0, cot = _walk_case(which, nh)
    want = _jax_walk_grads(g_jax, nh, jnp.bfloat16, params, h0, cot)
    f32 = _jax_walk_grads(g_jax, nh, None, params, h0, cot)
    gnn = TimeGNN(cfd, 3, torch.Generator().manual_seed(0), out_dim=OUT,
                  hidden_dim=HID, flag_attn=nh > 0, num_heads=max(nh, 1),
                  mlp_dtype="bfloat16")
    state = params_from_flax({"gnn": params})
    gnn.load_state_dict({k[len("gnn."):]: v for k, v in state.items()})
    h0_t = torch.from_numpy(h0).requires_grad_()
    hf = gnn(graph, h0_t)
    assert hf.dtype == torch.float32
    (hf * torch.from_numpy(cot)).sum().backward()
    scale = float(np.abs(want[0]).max())
    np.testing.assert_allclose(hf.detach().numpy(), want[0], rtol=0,
                               atol=1e-5 * scale)
    assert_near_jax_bf16(hf, want[0], f32[0], "h")
    got = {f"gnn.{k}": p.grad for k, p in gnn.named_parameters()}
    assert sorted(got) == sorted(want[1])
    for key, val in want[1].items():
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=2e-4,
                                   atol=1e-5 * float(val.abs().max()),
                                   err_msg=key)
        assert_near_jax_bf16(got[key], val, f32[1][key], key)
    np.testing.assert_allclose(h0_t.grad.numpy(), want[2], rtol=2e-4,
                               atol=1e-5 * float(np.abs(want[2]).max()))
    assert_near_jax_bf16(h0_t.grad, want[2], f32[2], "d_h0")


# ---- packing ----

def test_bf16_pack_holds_jax_bf16_values():
    """``pack_design(compute_dtype=torch.bfloat16)`` holds the feature
    tables and the raster in bf16 with JAX's bf16 values (its exact
    pack), everything else as the default pack; the default pack is
    float32 with JAX's float32 values."""
    parsed = small_parsed(seed=2)
    packs = {dt: pack_design(parsed, map_size=16, device="cpu",
                             compute_dtype=dt)
             for dt in (torch.float32, BF)}
    assert pack_design(parsed, map_size=16, device="cpu").cnn_input.dtype \
        == torch.float32
    for dt, jdt in ((torch.float32, jnp.float32), (BF, jnp.bfloat16)):
        want = jax_pack_design(parsed, map_size=16, exact_levels=True,
                               cnn_patches=False, compute_dtype=jdt)
        got = packs[dt]
        assert got.cnn_input.dtype == dt
        np.testing.assert_array_equal(_np(got.cnn_input),
                                      _nchw(want.cnn_input))
        for key in ("cell_feat_lvl", "net_feat_lvl"):
            for a, b in zip(getattr(got.graph, key),
                            getattr(want.graph, key)):
                assert a.dtype == dt
                np.testing.assert_array_equal(_np(a), _np(b))
    for key, val in vars(packs[torch.float32].graph).items():
        if key in ("cell_feat_lvl", "net_feat_lvl"):
            continue
        other = getattr(packs[BF].graph, key)
        if isinstance(val, tuple) and val and torch.is_tensor(val[0]):
            assert all(torch.equal(a, b) for a, b in zip(val, other)), key
        else:
            assert val == other, key


# ---- the reference ----

@pytest.mark.parametrize("what", ["padded_scan", "jit"])
def test_jax_bf16_is_not_one_function(what):
    """Why the port is held to JAX's fused exact walk run op by op: JAX's
    own bf16 has other rounding points elsewhere. ``padded_scan``: its
    padded scan, which its CLIs evaluate through, computes the pair-step
    MLPs as flax ``Dense(bfloat16)`` and rounds their outputs to bf16,
    where its fused exact walk keeps them float32: one bf16 model's
    predictions on the two packings of one design differ by more than
    1e-3 of max |out| (7.4e-3 measured), while in float32 they agree
    within 1e-6 (2.3e-7). ``jit``: under ``jax.jit`` XLA may keep a
    fused intermediate in float32 past a flax rounding point (excess
    precision): a bf16 ``DoubleConv`` in eval mode, jitted, moves more
    than 0.3 x (0.68 measured) its bf16-to-float32 mean distance from
    the same block run op by op."""
    from prtp_tpu.graph import pack_design as jax_pack_design
    from prtp_tpu.models import PathModel as JaxPathModel
    from prtp_tpu.models import unet as junet

    from test_torch_convert import jax_params

    if what == "jit":
        x = jnp.asarray(_nhwc(np.random.default_rng(1).standard_normal(
            (2, 3, 16, 16))))
        block = junet.DoubleConv(6, dtype=jnp.bfloat16)
        variables = jax.jit(block.init)(jax.random.PRNGKey(2), x)
        leaves, treedef = jax.tree_util.tree_flatten(variables)
        keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
        variables = jax.tree_util.tree_unflatten(  # running averages too
            treedef, [l + 0.1 * jax.random.normal(k, l.shape, l.dtype)
                      for l, k in zip(leaves, keys)])
        eager = _np(block.apply(variables, x))
        jitted = _np(jax.jit(block.apply)(variables, x))
        f32 = _np(junet.DoubleConv(6).apply(variables, x))
        ratio = np.abs(jitted - eager).mean() / np.abs(eager - f32).mean()
        assert ratio > 0.3
        return
    kw = dict(out_dim=16, hidden_dim=32, cnn_outdim=8, map_size=16,
              global_dim=8)
    parsed = small_parsed(seed=2)
    exact = jax_pack_design(parsed, map_size=16, exact_levels=True,
                            cnn_patches=False)
    padded = jax_pack_design(parsed, map_size=16, align=8,
                             cnn_patches=False)
    pids = jnp.arange(exact.num_paths, dtype=jnp.int32)
    variables = jax_params(JaxPathModel(**kw), exact, pids)
    rel = {}
    for dt in (jnp.bfloat16, None):
        model = JaxPathModel(compute_dtype=dt, **kw)
        a = _np(model.apply(variables, exact, pids))
        b = _np(model.apply(variables, padded, pids))
        rel[dt] = float(np.abs(a - b).max() / np.abs(a).max())
    assert rel[None] <= 1e-6 and rel[jnp.bfloat16] > 1e-3
