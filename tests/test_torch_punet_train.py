"""PUNet's training route (PUNetD2_128's architecture) against autograd and
against the JAX package on the CPU.

* The stride-2 input gradient's plain version (``conv2d_dgrad``:
  F.conv_transpose2d cut to the SAME window) against autograd through the
  forward's plain version, flax's (0, 1) pads on an even input and (1, 1)
  on an odd one, k 3 and 1, dilation 1 and 2: 1e-5 of the largest value.
* ``ConvNHWC`` over every case PUNet has: stride 2, the skip concat (the
  input gradient split into the two tensors'), ``in_scale`` (the weight
  gradient on the scaled input; the input and scale refuse a gradient):
  every gradient against autograd of the plain conv, 1e-5.
* The polish adjoint's plain version (``jacobi_adjoint_fixed``) against
  ``jax.vjp`` of JAX's ``solve_jacobi_fixed`` and against autograd of the
  port's plain sweeps, walls and obstacles, damped and not, 1 to 9
  sweeps: 1e-6 of the largest value; ``solve_jacobi`` under autograd is
  ``JacobiPolish`` and refuses a ``div`` that needs a gradient.
* One train step of a small PUNet (64^2, patch 8, widths 32/32/32,
  dilation 2, 8 damped polish sweeps, "xla", batch 2, LT on with JAX's
  draw) against ``jax.value_and_grad`` of JAX's ``make_loss_fn``: the loss
  terms within 1e-5, every parameter's gradient within 1e-4 of its
  tensor's largest value.
* The training entry point's PUNet flags and ``check_trainable``.
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
from fluidnet_cxx_tpu.ops import jacobi as j_jac
from fluidnet_cxx_tpu.train import trainer as j_trainer
from fluidnet_cxx_tpu_torch.config import ModelConfig, SimConfig, TrainConfig
from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                   random_flax_params)
from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet, make_net
from fluidnet_cxx_tpu_torch.ops import jacobi as t_jac
from fluidnet_cxx_tpu_torch.ops.kernels import jacobi as k_jac
from fluidnet_cxx_tpu_torch.ops.kernels import punet as k_punet
from fluidnet_cxx_tpu_torch.sim.step import DynParams
from fluidnet_cxx_tpu_torch.train import __main__ as t_main
from fluidnet_cxx_tpu_torch.train.trainer import (Batch, check_trainable,
                                                  make_loss_fn)

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def randn(rng, *shape, scale=1.0):
    return T((scale * rng.standard_normal(shape)).astype(np.float32))


# (side, kernel, dilation, c_in, c_out)
STRIDED = [(16, 3, 1, 32, 64), (15, 3, 1, 8, 32), (16, 1, 1, 32, 32),
           (16, 3, 2, 16, 32)]


@pytest.mark.parametrize("side,k,dil,ci,co", STRIDED,
                         ids=[f"{c[0]}-k{c[1]}-d{c[2]}" for c in STRIDED])
def test_strided_dgrad_plain_matches_autograd(rng, side, k, dil, ci, co):
    x = randn(rng, 2, side, side, ci).requires_grad_()
    w = randn(rng, k, k, ci, co, scale=0.2)
    assert k_punet.same_pads(16, 3, 2, 1) == (0, 1)
    y = k_punet.conv2d_nhwc_plain(x, w.permute(3, 2, 0, 1), None, 2, dil)
    up = randn(rng, *y.shape)
    (want,) = torch.autograd.grad((y * up).sum(), [x])
    got = k_punet.conv2d_dgrad(up, w, dil, 2, (side, side))
    assert got.shape == x.shape
    close(got, want, 1e-5)


# (stride, with x2, with in_scale)
CONV_CASES = [(2, False, False), (1, True, False), (2, True, False),
              (1, False, True)]


@pytest.mark.parametrize("stride,skip,scaled", CONV_CASES,
                         ids=["down", "concat", "concat-s2", "in_scale"])
def test_conv_function_matches_autograd(rng, stride, skip, scaled):
    """``conv2d_nhwc_autograd`` (``ConvNHWC``) against autograd through the
    plain conv: the output, the input gradients of x and x2, the weight
    and bias gradients."""
    c1, c2, co = 32, 32 if skip else 0, 32
    x = randn(rng, 2, 16, 16, c1)
    x2 = randn(rng, 2, 16, 16, c2) if skip else None
    w = randn(rng, 3, 3, c1 + c2, co, scale=0.2)
    b = randn(rng, co, scale=0.1)
    s = T(np.array([0.5, 2.0], np.float32)) if scaled else None
    grad_in = not scaled

    def leaves():
        out = [x.clone().requires_grad_(grad_in), w.clone().requires_grad_(),
               b.clone().requires_grad_()]
        if skip:
            out.append(x2.clone().requires_grad_())
        return out

    ref = leaves()
    want = k_punet.conv2d_nhwc_plain(ref[0], ref[1].permute(3, 2, 0, 1),
                                     ref[2], stride, 1, True,
                                     ref[3] if skip else None, s, 2)
    up = randn(rng, *want.shape)
    wrt = [t for t in ref if t.requires_grad]
    want_g = torch.autograd.grad((want * up).sum(), wrt)
    mine = leaves()
    got = k_punet.conv2d_nhwc_autograd(mine[0], mine[1], mine[2], stride, 1,
                                       True, mine[3] if skip else None, s, 2)
    assert "ConvNHWC" in type(got.grad_fn).__name__
    got_g = torch.autograd.grad((got * up).sum(),
                                [t for t in mine if t.requires_grad])
    close(got, want.detach(), 1e-6)
    for g, wg in zip(got_g, want_g):
        close(g, wg, 1e-5)
    if scaled:
        with pytest.raises(ValueError, match="in_scale"):
            k_punet.conv2d_nhwc_autograd(x.clone().requires_grad_(), w, b, 1,
                                         1, True, None, s, 2)


def _polish_case(rng, b=2, h=24, w=20):
    """Obstacle walls, an open (empty) top row as the plume's, 15%
    obstacles."""
    flags = random_flags(rng, b, h, w, p_obstacle=0.15)
    flags[:, -1, 1:-1] = 4
    div = rng.standard_normal((b, h, w)).astype(np.float32)
    p0 = rng.standard_normal((b, h, w)).astype(np.float32)
    g = rng.standard_normal((b, h, w)).astype(np.float32)
    return flags, div, p0, g


@pytest.mark.parametrize("iters", [1, 4, 9])
@pytest.mark.parametrize("damping", [1.0, 2.0 / 3.0])
def test_polish_adjoint_matches_jax_vjp_and_autograd(rng, iters, damping):
    flags, div, p0, g = _polish_case(rng)
    _, vjp = jax.vjp(lambda q: j_jac.solve_jacobi_fixed(
        jnp.asarray(flags), jnp.asarray(div), iters, p0=q, damping=damping),
        jnp.asarray(p0))
    (want,) = vjp(jnp.asarray(g))
    got = t_jac.jacobi_adjoint_fixed(T(flags), T(g), iters, damping)
    close(got, want, 1e-6)
    q = T(p0).requires_grad_()
    out = t_jac.solve_jacobi_fixed(T(flags), T(div), iters, p0=q,
                                   damping=damping)
    (auto,) = torch.autograd.grad((out * T(g)).sum(), [q])
    close(got, auto, 1e-6)
    # The open top, pinned in the forward, has a gradient; the walls none.
    assert float(got[:, -1, 1:-1].abs().max()) > 0
    assert float(got[:, 0].abs().max()) == 0


def test_solve_jacobi_under_autograd_is_the_polish_function(rng):
    flags, div, p0, g = _polish_case(rng)
    q = T(p0).requires_grad_()
    out = k_jac.solve_jacobi(T(flags), T(div), 8, p0=q, damping=2.0 / 3.0)
    assert "JacobiPolish" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert torch.equal(out, k_jac.solve_jacobi(T(flags), T(div), 8,
                                                   p0=T(p0),
                                                   damping=2.0 / 3.0))
    (got,) = torch.autograd.grad((out * T(g)).sum(), [q])
    assert torch.equal(got, t_jac.jacobi_adjoint_fixed(T(flags), T(g), 8,
                                                       2.0 / 3.0))
    with pytest.raises(ValueError, match="not div"):
        k_jac.solve_jacobi(T(flags), T(div).requires_grad_(), 8, p0=q)


PUNET = dict(model="PUNet", punet_patch=8, punet_widths=(32, 32, 32),
             punet_bottleneck_dilation=2, polish_sweeps=8,
             polish_impl="xla")


def _jax_params(net):
    tree = {}
    for key, t in net.state_dict().items():
        _, name, kind = key.split(".")
        tree.setdefault(name, {})["kernel" if kind == "weight" else
                                  "bias"] = (
            t.permute(2, 3, 1, 0).numpy() if kind == "weight" else t.numpy())
    return {"params": {"PUNet_0": tree}}


def test_punet_train_step_matches_jax(rng):
    kw = dict(batch_size=2, lt_num_steps=(1, 2), p_l2_lambda=0.3,
              p_l1_lambda=0.2, div_l1_lambda=0.5)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jsc, sc = JSimConfig(max_disp=2), SimConfig(max_disp=2)
    mcfg = ModelConfig(**PUNET)
    net = make_net(mcfg)
    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table, 1)))
    params = _jax_params(net)
    b, h, w = 2, 64, 64
    flags = random_flags(rng, b, h, w, p_obstacle=0.08)
    U = (0.5 * rng.standard_normal((b, 2, h, w))).astype(np.float32)
    zero = np.zeros((b, h, w), np.float32)
    data = dict(p_div=zero, U_div=U, flags=flags, density_div=zero,
                p_target=rng.standard_normal((b, h, w)).astype(np.float32),
                U_target=U, density_target=zero,
                div_mask=(rng.random((b, h, w)) > 0.2).astype(np.float32))
    jkey = jax.random.PRNGKey(3)
    dyn, n = j_trainer._sample_dyn(jkey, jsc, jtc)
    assert int(n) == 1
    jmodel = j_fn.FluidNet(JModelConfig(**PUNET))
    jloss = j_trainer.make_loss_fn(jmodel, jsc, jtc)
    jbatch = j_trainer.Batch(**{k: jnp.asarray(v) for k, v in data.items()})
    (_, jterms), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, jbatch, jkey)

    loss_fn = make_loss_fn(FluidNet(mcfg, net), sc, tc)
    draw = (DynParams(float(dyn.dt), float(dyn.buoyancy_scale),
                      float(dyn.gravity_scale),
                      tuple(float(g) for g in dyn.gravity_vec)), int(n))
    total, terms = loss_fn(Batch(**{k: T(v) for k, v in data.items()}),
                           draw=draw)
    total.backward()
    for got, want in zip(terms, jterms):
        close(got, want, 1e-5)
    assert float(terms.div_lt.detach()) > 0
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jgrads["params"]["PUNet_0"]))
    got = {k: p.grad for k, p in net.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        assert float(g.abs().max()) > 0, k
        close(g, want[k], 1e-4)


def test_entry_point_punet_flags_and_check_trainable():
    args = t_main.parse_args(["--onDevice", "2", "--model", "PUNet",
                              "--punetWidths", "96,128,128",
                              "--punetDilation", "2", "--polishSweeps",
                              "32"])
    mcfg, tc, _ = t_main.configs(args)
    assert (mcfg.model, mcfg.punet_widths, mcfg.punet_bottleneck_dilation,
            mcfg.polish_sweeps, mcfg.polish_impl) == (
                "PUNet", (96, 128, 128), 2, 32, "xla")
    assert tc.batch_size == 64
    check_trainable(mcfg, "cuda")
    for impl in ("fused", "mg"):
        bad = ModelConfig(**dict(PUNET, polish_impl=impl))
        with pytest.raises(NotImplementedError,
                           match="JAX does not differentiate"):
            check_trainable(bad, "cuda")
        check_trainable(bad, "cpu")
    # bfloat16 trains on the card too: kernel B's bfloat16 route has its
    # backward kernels (ROADMAP A.5.3).
    check_trainable(ModelConfig(**dict(PUNET, compute_dtype="bfloat16")),
                    "cuda")
