"""The gradients of kernel B's bfloat16 route, their plain versions against
``jax.vjp`` of flax ``nn.Conv(dtype="bfloat16")`` on the CPU.

What JAX computes there (probed layer by layer; the same under
``jax_disable_most_optimizations``): every bf16 x bf16 product exact in
float32, the input and weight gradients summed in float32 and rounded to
bfloat16 once; the bias gradient is XLA's reduce of the bfloat16
cotangent, accumulated in bfloat16 with each add rounded, in the order of
XLA's tree reduction on the CPU: while every reduced axis (batch, [depth,]
rows, columns) is at most 32 long, one chain over the cells in row-major
order; otherwise windows of 32 along each longer axis, padded evenly to a
multiple of 32 (an axis of at most 32 is one window), a chain over each
window, then a chain over the windows (``conv_grad.py::bias_windows``).
The plain versions (``conv2d_dgrad_bf16_plain``,
``conv2d_wgrad_bf16_plain``, ``bias_grad_plain``) round at the same
points, and ``ConvNHWC`` runs them on bfloat16 CPU tensors.

* One layer of each kind the 2-D nets train, through
  ``conv2d_nhwc_autograd`` on weights packed as ``pack_weights`` packs
  them (thin layers padded to 32 input channels and to 32 output channels,
  or 8 for an output layer; the input widened with zeros): 1x1, 3x3 at
  stride 1 and 2 (even and odd maps), dilation 2, PUNet's skip concat,
  ScaleNet's 5x5 layers, the tower's thin ones, an output layer on a 64^2
  map whose bias gradient XLA windows. dx (its padded channels exactly 0),
  the float32 parameters' weight gradient (through the bfloat16 cast, as
  flax's ``promote_dtype`` passes it back) and the bias gradient against
  ``jax.vjp``: each value within one bfloat16 ulp, or within 1e-5 of the
  tensor's largest value where a cancellation leaves it near zero (a
  float32 sum taken in another order may then round to a bfloat16 further
  off); at most one value in every 1000 (or part of 1000) off; the bias
  bit for bit.
* The bias gradient alone, bit for bit, on shapes that do and do not
  trigger XLA's windows, in 2-D and in 3-D (``conv_grad3.py``'s bias
  gradient shares it); one chain over the cells in order (what the 3-D
  wrapper computed before) is shown to miss where XLA windows.
* The wrappers refuse other devices.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fluidnet_cxx_tpu.config import ModelConfig as JModelConfig
from fluidnet_cxx_tpu.config import SimConfig as JSimConfig
from fluidnet_cxx_tpu.config import TrainConfig as JTrainConfig
from fluidnet_cxx_tpu.models import fluidnet as j_fn
from fluidnet_cxx_tpu.models.multi_scale import MultiScaleNet as JScaleNet
from fluidnet_cxx_tpu.models.multi_scale import _resize as j_resize
from fluidnet_cxx_tpu.train import trainer as j_trainer
from fluidnet_cxx_tpu_torch.config import ModelConfig, SimConfig, TrainConfig
from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                   random_flax_params)
from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet, avg_pool, make_net
from fluidnet_cxx_tpu_torch.models.multi_scale import resize
from fluidnet_cxx_tpu_torch.ops.kernels import conv_grad, conv_grad3, punet
from fluidnet_cxx_tpu_torch.sim.step import DynParams
from fluidnet_cxx_tpu_torch.train.trainer import (Batch, init_train_state,
                                                  make_train_step)
from test_torch_train_grad import T, _batch, _jax_params

torch.set_num_threads(1)
BF16 = torch.bfloat16


def _ulps(got, want):
    """|got - want| in bfloat16 ulps of want (equal values: 0)."""
    a = np.abs(want)
    ulp = np.where(a > 0, np.exp2(np.floor(np.log2(np.maximum(a, 1e-30)))
                                  - 7), 2.0 ** -133)
    return np.where(got == want, 0.0, np.abs(got - want) / ulp)


def _ulp(a):
    """One bfloat16 ulp of each |a| (0 for 0)."""
    a = np.abs(a)
    return np.where(a > 0, np.exp2(np.floor(np.log2(np.maximum(a, 1e-30)))
                                   - 7), 0.0)


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


# (kernel, stride, dilation, relu, real c1, c2, co, stored c1 + c2, co,
# side)
LAYERS = [
    (1, 1, 1, True, 128, 0, 64, 128, 64, 8),      # PUNet embed
    (3, 1, 1, True, 64, 0, 64, 64, 64, 16),       # enc
    (3, 2, 1, True, 64, 0, 64, 64, 64, 16),       # down, even map
    (3, 2, 1, True, 32, 0, 32, 32, 32, 15),       # down, odd map
    (3, 1, 2, True, 64, 0, 64, 64, 64, 8),        # mid, dilation 2
    (1, 1, 1, False, 64, 0, 256, 64, 256, 8),     # up
    (3, 1, 1, True, 64, 64, 64, 128, 64, 16),     # dec0_0, skip concat
    (1, 1, 1, False, 64, 0, 64, 64, 64, 16),      # head
    (5, 1, 1, True, 3, 0, 32, 32, 32, 16),        # ScaleNet Conv_0
    (5, 1, 1, False, 32, 0, 8, 32, 32, 16),       # ScaleNet convN_1/Conv_5
    (3, 1, 1, True, 16, 0, 16, 32, 32, 32),       # tower bank conv
    (1, 1, 1, False, 8, 0, 1, 32, 8, 64),         # tower convOut, windows
]


@pytest.mark.parametrize(
    "k,stride,dil,relu,c1,c2,co,cs,cos,side", LAYERS,
    ids=[f"k{c[0]}-s{c[1]}-d{c[2]}-{'relu' if c[3] else 'lin'}-"
         f"{c[4]}+{c[5]}to{c[6]}-{c[9]}sq" for c in LAYERS])
def test_layer_gradients_match_flax_vjp(rng, k, stride, dil, relu, c1, c2,
                                        co, cs, cos, side):
    """dx, dW and db of one packed layer against jax.vjp (module
    docstring)."""
    ci = c1 + c2
    x = _bf16(rng.standard_normal((2, side, side, ci)))
    kernel = (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)
              ).astype(np.float32)
    bias = (0.1 * rng.standard_normal(co)).astype(np.float32)
    so = -(-side // stride)
    g = _bf16(rng.standard_normal((2, so, so, co)))

    conv = nn.Conv(co, (k, k), strides=(stride, stride), padding="SAME",
                   kernel_dilation=(dil, dil), dtype="bfloat16")

    def f(xx, kk, bb):
        y = conv.apply({"params": {"kernel": kk, "bias": bb}}, xx)
        return nn.relu(y) if relu else y

    y, vjp = jax.vjp(f, jnp.asarray(x, jnp.bfloat16), kernel, bias)
    dx_w, dk_w, db_w = (np.asarray(a.astype(jnp.float32))
                        for a in vjp(jnp.asarray(g, y.dtype)))

    # The port: float32 parameters packed as pack_weights packs them.
    w = torch.from_numpy(kernel).permute(3, 2, 0, 1).contiguous()
    w.requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    w_hwio = F.pad(w.permute(2, 3, 1, 0), (0, cos - co, 0, cs - ci)).to(BF16)
    b_pad = F.pad(b, (0, cos - co)).to(BF16).float()
    xt = F.pad(torch.from_numpy(x), (0, cs - ci)).to(BF16)
    x1 = xt[..., :cs - c2].contiguous().requires_grad_()
    x2 = xt[..., cs - c2:].contiguous().requires_grad_() if c2 else None
    out = punet.conv2d_nhwc_autograd(x1, w_hwio.contiguous(), b_pad, stride,
                                     dil, relu, x2)
    gt = F.pad(torch.from_numpy(g), (0, cos - co)).to(BF16)
    out.backward(gt)
    dx = x1.grad if x2 is None else torch.cat([x1.grad, x2.grad], dim=-1)
    assert dx.dtype == BF16 and w.grad.dtype == torch.float32
    assert float(dx[..., ci:].abs().max() if cs > ci else 0.0) == 0.0
    report = []
    for name, got, want in (
            ("dx", dx[..., :ci].float().numpy(), dx_w),
            ("dW", w.grad.permute(2, 3, 1, 0).numpy(), dk_w),
            ("db", b.grad.numpy(), db_w)):
        assert np.array_equal(got, _bf16(got)), name   # bf16 values
        u = _ulps(got, want)
        near0 = np.abs(got - want) <= 1e-5 * np.abs(want).max()
        report.append((name, int((u > 0).sum()),
                       float(np.where(near0, 0.0, u).max()), u.size))
    print(f"values off flax (count, largest ulps outside cancellation, "
          f"of): {report}")
    for name, n_off, worst, size in report:
        assert worst <= 1.0, (name, worst)
        assert n_off <= -(-size // 1000), (name, n_off)
    assert report[2][1] == 0, "the bias gradient is not bit for bit"


def _flax_bias_grad(g):
    """jax.vjp of a bfloat16 1x1 conv's bias (2-D or 3-D) at ``g``."""
    nd = g.ndim - 2
    co = g.shape[-1]
    conv = nn.Conv(co, (1,) * nd, dtype="bfloat16")
    x = jnp.zeros(g.shape[:-1] + (8,), jnp.bfloat16)
    kernel = np.zeros((1,) * nd + (8, co), np.float32)
    y, vjp = jax.vjp(lambda bb: conv.apply(
        {"params": {"kernel": kernel, "bias": bb}}, x),
        np.zeros(co, np.float32))
    return np.asarray(vjp(jnp.asarray(g, y.dtype))[0])


def _chain(dy):
    """One bfloat16 chain over the cells in row-major order."""
    acc = torch.zeros_like(dy.reshape(-1, dy.shape[-1])[0])
    for row in dy.reshape(-1, dy.shape[-1]):
        acc = acc + row
    return acc.float().numpy()


# dy shapes: (windows expected, shape).
BIAS_SHAPES = [(False, (2, 32, 32, 8)), (True, (2, 64, 64, 16)),
               (True, (2, 48, 40, 16)), (True, (3, 33, 70, 8)),
               (True, (40, 8, 8, 8)), (False, (4, 8, 8, 8, 16)),
               (True, (2, 40, 6, 6, 8))]


@pytest.mark.parametrize("windows,shape", BIAS_SHAPES,
                         ids=["x".join(map(str, s)) for _, s in BIAS_SHAPES])
def test_bias_grad_matches_xla_tree_reduction(rng, windows, shape):
    """bias_grad_plain bit for bit against jax.vjp of a bfloat16 conv's
    bias, in 2-D and 3-D (conv3d_wgrad_plain's db), the windows where an
    axis is above 32; where XLA windows, one chain over the cells misses
    it."""
    g = _bf16(rng.standard_normal(shape))
    want = _flax_bias_grad(g)
    dy = torch.from_numpy(g).to(BF16)
    got = conv_grad.bias_grad_plain(dy).numpy()
    assert np.array_equal(got, want), np.abs(got - want).max()
    if len(shape) == 5:
        x = torch.zeros(shape[:-1] + (8,), dtype=BF16)
        _, db = conv_grad3.conv3d_wgrad_plain(x, dy, 1, 1)
        assert np.array_equal(db.numpy(), want)
    nwin = np.prod([n for _, _, n in conv_grad.bias_windows(shape[:-1])])
    assert (nwin > 1) == windows
    if windows:
        assert not np.array_equal(_chain(dy), want)
    table = list(conv_grad.bias_table(shape[:-1]))
    assert len(table) == 16 and table[:4] == [1] * (5 - len(shape)) + list(
        shape[:-1])


def test_bias_windows_follow_xla():
    """The window plan: no windows up to 32 on every axis; 32-wide windows
    padded evenly on the longer axes; too many windows on an axis
    raises."""
    assert conv_grad.bias_windows((16, 16, 16)) == ((16, 0, 1),) * 3
    assert conv_grad.bias_windows((64, 128, 128)) == (
        (32, 0, 2), (32, 0, 4), (32, 0, 4))
    assert conv_grad.bias_windows((3, 33, 70)) == (
        (3, 0, 1), (32, 15, 2), (32, 13, 3))
    with pytest.raises(ValueError, match="windows"):
        conv_grad.bias_windows((2, 2048, 8))


def test_bf16_grad_wrappers_refuse_other_devices():
    """The wrappers run their plain versions only on CPU tensors and raise
    for any other device."""
    dy = torch.zeros((1, 4, 4, 32), device="meta", dtype=BF16)
    w = torch.zeros((3, 3, 32, 32), device="meta", dtype=BF16)
    for call in (lambda: conv_grad.conv2d_dgrad_bf16(dy, w, 1, 1),
                 lambda: conv_grad.conv2d_wgrad_bf16(dy, dy, 3),
                 lambda: conv_grad.bias_grad(dy)):
        with pytest.raises(ValueError, match="device"):
            call()


# ---- A.4.3: the tower and ScaleNet in bfloat16 ----

def _seeded_net(model, dtype="bfloat16", seed=1):
    net = make_net(ModelConfig(model=model, compute_dtype=dtype))
    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table,
                                                              seed)))
    return net


@pytest.mark.parametrize("model", ["FluidNet", "ScaleNet"])
def test_bf16_train_step_through_the_trainer(rng, model):
    """One bfloat16 train step of the tower and of ScaleNet through the
    trainer's make_train_step (LT on, the packed route, the bfloat16
    backward's plain versions) at 32^2, batch 2: every parameter updated;
    its loss terms within 2e-2 of jax.value_and_grad's (JAX's make_loss_fn
    with compute_dtype bfloat16 on the same weights, batch and draw), and
    each gradient within 5e-2 of JAX's (relative L2), or within twice what
    JAX's own gradients move when one value of the batch's velocity moves
    by one bfloat16 ulp: bfloat16 ReLU masks that flip (ScaleNet's
    branches, seed weights: 5-19% in JAX itself)."""
    kw = dict(batch_size=2, lt_num_steps=(1, 2), p_l2_lambda=0.3,
              p_l1_lambda=0.2, div_l1_lambda=0.5)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jsc, sc = JSimConfig(max_disp=2), SimConfig(max_disp=2)
    mcfg = ModelConfig(model=model, compute_dtype="bfloat16")
    net = _seeded_net(model)
    sub, params = _jax_params(net, model)
    jmodel = j_fn.FluidNet(JModelConfig(model=model,
                                        compute_dtype="bfloat16"))
    data = _batch(rng)
    jkey = jax.random.PRNGKey(3)
    dyn, n = j_trainer._sample_dyn(jkey, jsc, jtc)
    value_and_grad = jax.jit(jax.value_and_grad(
        j_trainer.make_loss_fn(jmodel, jsc, jtc), has_aux=True))

    def jax_step(batch):
        jbatch = j_trainer.Batch(**{k: jnp.asarray(v)
                                    for k, v in batch.items()})
        (_, terms), grads = value_and_grad(params, jbatch, jkey)
        return terms, flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, grads["params"][sub]))

    jterms, want = jax_step(data)
    moved = dict(data, U_div=data["U_div"].copy())
    moved["U_div"][0, 0, 9, 11] *= 1 + 2.0 ** -7
    _, witness = jax_step(moved)

    fnet = FluidNet(mcfg, net)
    ts = init_train_state(fnet, tc)
    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table, 1)))
    train_step, _ = make_train_step(fnet, sc, tc)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    draw = (DynParams(float(dyn.dt), float(dyn.buoyancy_scale),
                      float(dyn.gravity_scale),
                      tuple(float(g) for g in dyn.gravity_vec)), int(n))
    ts, terms = train_step(ts, Batch(**{k: T(v) for k, v in data.items()}),
                           draw=draw)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    names = [k for k, _ in net.named_parameters()]
    got = {k: p.grad for k, p in net.named_parameters()}
    gaps = {k: rel(got[k], want[k]) for k in names}
    own = {k: rel(witness[k], want[k]) for k in names}
    whole, whole_own = (rel(torch.cat([g[k].flatten() for k in names]),
                            torch.cat([want[k].flatten() for k in names]))
                        for g in (got, witness))
    term_gaps = [abs(float(g) - float(w)) / max(abs(float(w)), 1e-30)
                 for g, w in zip(terms, jterms)]
    print(f"bf16 {model} step: loss terms' gaps {term_gaps}; gradient gap "
          f"(relative L2 over all parameters) {whole:.4f}, JAX moved by one "
          f"ulp {whole_own:.4f}; per tensor (port | moved) "
          f"{ {k: (round(gaps[k], 4), round(own[k], 4)) for k in names} }")
    assert ts.step == 1 and all(torch.isfinite(t) for t in terms)
    for k, p in net.named_parameters():
        assert p.dtype == torch.float32 and not torch.equal(p, before[k]), k
    assert max(term_gaps) <= 2e-2
    assert whole <= max(5e-2, 2 * whole_own)


def _flax_net(model):
    return (JScaleNet(dtype="bfloat16") if model == "ScaleNet"
            else j_fn.FluidNetTower(dtype="bfloat16"))


def _input(rng, shape):
    x = rng.standard_normal(shape + (2,)).astype(np.float32)
    x[..., 1] = x[..., 1] > 0
    return x


def test_bf16_tower_forward_equals_flax(rng):
    """FluidNetTower in bfloat16 (seed weights) bit for bit against flax's
    (jitted) at 32^2, batch 2, and 64x32: the pools (a chain over the
    window, then the divide), the repeats and the three-bank sum (rounded
    after each add) as XLA rounds them; the packed route equals the
    module's forward."""
    net = _seeded_net("FluidNet")
    apply = jax.jit(_flax_net("FluidNet").apply)
    params = {"params": _jax_params(net, "FluidNet")[1]["params"][
        "FluidNetTower_0"]}
    for shape in ((2, 32, 32), (1, 64, 32)):
        x = _input(rng, shape)
        want = np.asarray(apply(params, jnp.asarray(x)))
        with torch.no_grad():
            got = net(T(x))
            packed = punet.net_forward(net, punet.pack_weights(net), T(x))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want), shape
        assert torch.equal(packed, got)
    a = _bf16(np.abs(rng.standard_normal((2, 16, 16, 8))))
    for k in (2, 4):
        want = np.asarray(nn.avg_pool(jnp.asarray(a, jnp.bfloat16), (k, k),
                                      strides=(k, k)).astype(jnp.float32))
        got = avg_pool(T(a).to(BF16), k)
        assert got.dtype == BF16 and np.array_equal(got.float().numpy(),
                                                    want)


def test_bf16_scalenet_layers_and_resize_match_flax(rng):
    """MultiScaleNet in bfloat16 (seed weights), 32^2, batch 2: each conv
    layer fed flax's own input within one bfloat16 ulp at each of its two
    rounding points of flax's output (the ulp of the output plus the ulp
    of the float32 sum, which the bias add carries into the output where
    it cancels most of the sum), or within 1e-5 of the largest output
    where the sum itself cancels (a float32 sum in another order), with
    at most one value in every 1000 off; the bfloat16 resizes of the
    branches' outputs bit for bit against jax.image.resize (one axis, then
    the other, each rounded); the whole net within 2e-2 of the largest
    output (the layers' flips propagate, as ROADMAP C.7 finds for
    MGCoarse_128)."""
    net = _seeded_net("ScaleNet")
    params = {"params": _jax_params(net, "ScaleNet")[1]["params"][
        "MultiScaleNet_0"]}
    x = _input(rng, (2, 32, 32))
    out, st = _flax_net("ScaleNet").apply(params, jnp.asarray(x),
                                          capture_intermediates=True)
    inter = st["intermediates"]

    def flax_out(branch, i):
        return inter[branch][f"Conv_{i}"]["__call__"][0]

    torch.set_grad_enabled(False)
    try:
        for branch, n in (("convN_4", 4), ("convN_2", 6), ("convN_1", 6)):
            for i in range(1, n):
                h = flax_out(branch, i - 1)
                h = jax.nn.relu(h) if i - 1 < n - 2 else h
                name = f"{branch}/Conv_{i}"
                hin = T(h.astype(jnp.float32)).to(BF16)
                got = net._plain_conv(name, hin, relu=False).float().numpy()
                want = np.asarray(flax_out(branch, i).astype(jnp.float32))
                c = net.convs[name]
                presum = punet.conv2d_nhwc_plain(
                    hin.float(), c.weight.to(BF16).float(),
                    torch.zeros_like(c.bias), 1, 1).numpy()
                tol = (_ulp(np.maximum(np.abs(got), np.abs(want)))
                       + _ulp(1.01 * presum))
                tol = np.maximum(tol, 1e-5 * np.abs(want).max())
                assert (np.abs(got - want) <= tol).all(), name
                assert (got != want).sum() <= -(-got.size // 1000), name
        for src, hw in ((flax_out("convN_4", 3), (16, 16)),
                        (flax_out("convN_2", 5), (32, 32))):
            want = np.asarray(j_resize(src, hw).astype(jnp.float32))
            got = resize(T(src.astype(jnp.float32)).to(BF16), hw)
            assert got.dtype == BF16
            assert np.array_equal(got.float().numpy(), want)
        got = net(T(x)).numpy()
    finally:
        torch.set_grad_enabled(True)
    want = np.asarray(out)
    gap = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"bf16 ScaleNet whole net: largest gap {gap:.3e} of the largest "
          "output")
    assert gap <= 2e-2
