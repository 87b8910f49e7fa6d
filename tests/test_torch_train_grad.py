"""The gradient route of the port's training, against autograd and against
the JAX package on the CPU.

* The plain twins of the backward route: ``ConvNHWC`` (kernel B's
  autograd function; on a CPU tensor its forward is ``conv2d_nhwc``'s plain
  version, its input gradient ``conv2d_dgrad``'s transposed conv and
  its weight gradient ``torch.nn.grad.conv2d_weight`` plus a sum) against
  autograd through ``conv2d_nhwc_plain``, k 1, 3 and 5, dilation 1 and 2,
  with and without ReLU, an output layer's 4 channels; the wgrad twin at
  stride 2. Tolerance 1e-5 of each gradient's largest value (sums in
  another order).
* The packed route (``pack_weights`` while autograd records, 32-channel
  activations) against the plain net's autograd: the same parameter
  gradients within 1e-5 of each one's largest value, the padded channels
  passing none.
* One train step's ``LossTerms`` and every parameter's gradient, LT on,
  for FluidNetTower and MultiScaleNet at 32^2, batch 2, against
  ``jax.value_and_grad`` of JAX's ``make_loss_fn`` on the same weights and
  batch, the rollout's draw taken from JAX's ``_sample_dyn``
  (``lt_num_steps`` (1, 2), ``max_disp`` 2: cheap compiles), every loss
  weight non-zero; the terms within 1e-5, the gradients (converted with
  ``flax_to_state_dict``) within 1e-4 of each tensor's largest value (the
  loss runs two forwards, a rollout and their backward, each conv summed
  in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.config import ModelConfig as JModelConfig
from fluidnet_cxx_tpu.config import SimConfig as JSimConfig
from fluidnet_cxx_tpu.config import TrainConfig as JTrainConfig
from fluidnet_cxx_tpu.models import fluidnet as j_fn
from fluidnet_cxx_tpu.train import trainer as j_trainer
from fluidnet_cxx_tpu_torch.config import ModelConfig, SimConfig, TrainConfig
from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                   random_flax_params)
from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet, make_net
from fluidnet_cxx_tpu_torch.ops.kernels import punet as k_punet
from fluidnet_cxx_tpu_torch.ops.kernels.conv_grad import conv2d_wgrad
from fluidnet_cxx_tpu_torch.sim.step import DynParams
from fluidnet_cxx_tpu_torch.train.trainer import Batch, make_loss_fn

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _seeded(model, seed=1):
    net = make_net(ModelConfig(model=model))
    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table,
                                                              seed)))
    return net


CONV_CASES = [(3, 1, True, 32, 32), (3, 2, False, 32, 32),
              (1, 1, True, 32, 32), (1, 1, False, 32, 4),
              (5, 1, True, 64, 32), (5, 2, False, 32, 4)]


@pytest.mark.parametrize("k,dil,relu,ci,co", CONV_CASES,
                         ids=[f"k{c[0]}-d{c[1]}-{'relu' if c[2] else 'lin'}"
                              f"-{c[3]}to{c[4]}" for c in CONV_CASES])
def test_conv_backward_twins_match_autograd(rng, k, dil, relu, ci, co):
    x = T(rng.standard_normal((2, 12, 12, ci)).astype(np.float32))
    w = T(0.2 * rng.standard_normal((k, k, ci, co)).astype(np.float32))
    b = T(0.1 * rng.standard_normal(co).astype(np.float32))
    up = T(rng.standard_normal((2, 12, 12, co)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    want = k_punet.conv2d_nhwc_plain(leaves[0], leaves[1].permute(3, 2, 0, 1),
                                     leaves[2], 1, dil, relu)
    want_grads = torch.autograd.grad((want * up).sum(), leaves)
    mine = [t.clone().requires_grad_() for t in (x, w, b)]
    got = k_punet.conv2d_nhwc_autograd(*mine, 1, dil, relu)
    assert got.grad_fn is not None and "ConvNHWC" in type(got.grad_fn).__name__
    got_grads = torch.autograd.grad((got * up).sum(), mine)
    _close(got, want.detach(), 1e-6)
    for g, w_ in zip(got_grads, want_grads):
        _close(g, w_, 1e-5)
    # The two halves on their own: the transposed conv and wgrad.
    gy = torch.where(want > 0, up, 0.0) if relu else up
    _close(k_punet.conv2d_dgrad(gy, w, dil), want_grads[0], 1e-5)
    dw, db = conv2d_wgrad(x, gy, k, 1, dil, k_punet.same_pads(12, k, 1, dil))
    _close(dw, want_grads[1], 1e-5)
    _close(db, want_grads[2], 1e-5)


def test_wgrad_twin_at_stride_2(rng):
    """The weight gradient's plain version at stride 2 with flax's (0, 1)
    SAME pads, as the PUNet slice will call it."""
    x = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    w = T(0.2 * rng.standard_normal((3, 3, 32, 8)).astype(np.float32))
    xl = T(x).requires_grad_()
    wl = w.clone().requires_grad_()
    y = k_punet.conv2d_nhwc_plain(xl, wl.permute(3, 2, 0, 1), None, 2)
    up = T(rng.standard_normal(tuple(y.shape)).astype(np.float32))
    (gw,) = torch.autograd.grad((y * up).sum(), [wl])
    dw, db = conv2d_wgrad(T(x), up, 3, 2, 1, k_punet.same_pads(16, 3, 2, 1))
    _close(dw, gw, 1e-5)
    _close(db, up.sum(dim=(0, 1, 2)), 1e-6)


@pytest.mark.parametrize("model", ["FluidNet", "ScaleNet"])
def test_packed_route_gradient_matches_plain_net(rng, model):
    """Weights packed while autograd records: the padded chain's parameter
    gradients equal the plain net's; the padded rows and columns of the
    packed weights pass nothing back."""
    net = _seeded(model)
    x = T(rng.standard_normal((2, 32, 32, 2)).astype(np.float32))
    up = T(rng.standard_normal((2, 32, 32, 1)).astype(np.float32))
    want = torch.autograd.grad((net(x) * up).sum(), list(net.parameters()))
    packed = k_punet.pack_weights(net)
    assert all(w.requires_grad for w, _ in packed.values())
    got_out = k_punet.net_forward(net, packed, x)
    got = torch.autograd.grad((got_out * up).sum(), list(net.parameters()))
    for g, w_ in zip(got, want):
        _close(g, w_, 1e-5)


def _jax_params(net, model):
    sub = "MultiScaleNet_0" if model == "ScaleNet" else "FluidNetTower_0"
    tree = {}
    for key, t in net.state_dict().items():
        _, name, kind = key.rsplit(".", 2)
        *outer, last = name.split("/")
        node = tree
        for part in outer:
            node = node.setdefault(part, {})
        node.setdefault(last, {})["kernel" if kind == "weight" else "bias"] = (
            t.permute(2, 3, 1, 0).numpy() if kind == "weight" else t.numpy())
    return sub, {"params": {sub: tree}}


def _batch(rng, b=2, h=32, w=32):
    flags = random_flags(rng, b, h, w, p_obstacle=0.08)
    U = (0.5 * rng.standard_normal((b, 2, h, w))).astype(np.float32)
    p = rng.standard_normal((b, h, w)).astype(np.float32)
    mask = (rng.random((b, h, w)) > 0.2).astype(np.float32)
    zero = np.zeros((b, h, w), np.float32)
    return dict(p_div=zero, U_div=U, flags=flags, density_div=zero,
                p_target=p, U_target=U, density_target=zero, div_mask=mask)


# (model, JAX key of the LT draw, its rollout's steps (asserted)): both
# draws have buoyancy on.
STEP_CASES = [("FluidNet", 3, 1), ("ScaleNet", 26, 2)]


@pytest.mark.parametrize("model,key,n_lt", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_train_step_terms_and_gradients_match_jax(rng, model, key, n_lt):
    kw = dict(batch_size=2, lt_num_steps=(1, 2), p_l2_lambda=0.3,
              p_l1_lambda=0.2, div_l1_lambda=0.5)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jsc, sc = JSimConfig(max_disp=2), SimConfig(max_disp=2)
    net = _seeded(model)
    sub, params = _jax_params(net, model)
    jmodel = j_fn.FluidNet(JModelConfig(model=model))
    data = _batch(rng)
    jkey = jax.random.PRNGKey(key)
    dyn, n = j_trainer._sample_dyn(jkey, jsc, jtc)
    assert int(n) == n_lt
    jloss = j_trainer.make_loss_fn(jmodel, jsc, jtc)
    jbatch = j_trainer.Batch(**{k: jnp.asarray(v) for k, v in data.items()})
    (_, jterms), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, jbatch, jkey)

    fnet = FluidNet(ModelConfig(model=model), net)
    loss_fn = make_loss_fn(fnet, sc, tc)
    batch = Batch(**{k: T(v) for k, v in data.items()})
    draw = (DynParams(float(dyn.dt), float(dyn.buoyancy_scale),
                      float(dyn.gravity_scale),
                      tuple(float(g) for g in dyn.gravity_vec)), int(n))
    total, terms = loss_fn(batch, draw=draw)
    total.backward()
    for got, want in zip(terms, jterms):
        _close(got, want, 1e-5)
    assert float(terms.div_lt) > 0 and float(terms.p_l1) > 0
    want_grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jgrads["params"][sub]))
    got_grads = {k: p.grad for k, p in net.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for k, g in got_grads.items():
        assert float(g.abs().max()) > 0, k
        _close(g, want_grads[k], 1e-4)
