"""The flax-path learned 3-D projection (``models/punet3d.py::FluidNet3``,
``make_project_fn3``) and kernel N's flax route, port against the JAX
package's ``FluidNet3`` and flax ``nn.Conv`` on the CPU.

flax ``nn.Conv(dtype="bfloat16")`` casts the input, kernel and bias to
bfloat16; JAX on the CPU sums the exact bf16 x bf16 products in float32,
rounds the sum to bfloat16, adds the bias and rounds again. Every conv of
the flax PUNet3 does so, the up conv and the head too, and the network's
output is cast to float32 at the end. ``conv3d_ndhwc_plain(...,
round_sum=True)`` on a PUNet3 built with ``rounding="flax"`` rounds at the
same points.

Tolerances:
- one layer on inputs whose every float32 sum is exact: bit for bit;
- every layer of the trained PUNet3p8_64 in bfloat16, fed the port's own
  activations: within one bfloat16 ulp of flax's layer on the same input,
  and at most one value in 1000 off (a float32 sum taken in another order
  lands on the other side of a rounding point);
- the whole flax path in float32 against ``FluidNet3.apply``: 1e-5 of each
  output's largest value, with polish "xla" (16 sweeps), no polish, and a
  ``punet_refine_convs`` of 1, which both sides ignore.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.config import ModelConfig as JModelConfig
from fluidnet_cxx_tpu.models.punet3d import FluidNet3 as JFluidNet3
from fluidnet_cxx_tpu.ops import ops3d as j_ops3d
from fluidnet_cxx_tpu_torch.config import ModelConfig, load_model_config
from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict3,
                                                   random_flax_params3)
from fluidnet_cxx_tpu_torch.models.punet3d import (
    FluidNet3, PUNet3, init_params3, make_project_fn3,
    make_project_fn3_fused_forward)
from fluidnet_cxx_tpu_torch.ops.kernels import punet3 as k_punet3
from fluidnet_cxx_tpu_torch.run_plume3d import MODELS, build_punet3, \
    run_plume3d
from test_torch_ops3d import random_flags3

torch.set_num_threads(1)
BF16 = torch.bfloat16
MODEL_P8 = MODELS / "PUNet3p8_64"

# (kernel, stride, relu, c1, c2, co): the flax PUNet3's kinds of layer.
LAYERS = [(1, 1, True, 64, 0, 32), (3, 1, True, 32, 0, 32),
          (3, 2, True, 32, 0, 64), (1, 1, False, 64, 0, 256),
          (3, 1, True, 32, 32, 32), (1, 1, False, 32, 0, 64)]


def dyadic(rng, shape, num, den):
    """Values k / den, |k| <= num: exact in bfloat16, and every product
    and partial sum of the layers below exact in float32."""
    return (rng.integers(-num, num + 1, shape) / den).astype(np.float32)


def flax_layer(x, kernel, bias, k, stride, relu):
    conv = nn.Conv(kernel.shape[-1], (k, k, k), strides=(stride,) * 3,
                   padding="SAME", dtype="bfloat16")
    y = conv.apply({"params": {"kernel": kernel, "bias": bias}}, x)
    return np.asarray((nn.relu(y) if relu else y).astype(jnp.float32))


def _ulps(got, want):
    """|got - want| in bfloat16 ulps of want (values that are equal: 0)."""
    a = np.abs(want)
    ulp = np.where(a > 0, np.exp2(np.floor(np.log2(np.maximum(a, 1e-30)))
                                  - 7), 2.0 ** -133)
    return np.abs(got - want) / ulp


@pytest.mark.parametrize("k,stride,relu,c1,c2,co", LAYERS,
                         ids=[f"k{c[0]}-s{c[1]}-{'relu' if c[2] else 'lin'}"
                              f"-{c[3]}+{c[4]}to{c[5]}" for c in LAYERS])
def test_layer_bit_equal_to_flax(rng, k, stride, relu, c1, c2, co):
    """One layer of each kind on exact sums: the sum rounded to bfloat16,
    the bias add rounded again, a bfloat16 output; the concat takes both
    halves in bfloat16. One rounding after the bias add misses flax."""
    x = dyadic(rng, (1, 8, 8, 8, c1 + c2), 16, 8)
    kernel = dyadic(rng, (k, k, k, c1 + c2, co), 16, 64)
    bias = (dyadic(rng, (co,), 64, 128) + np.float32(1 / 3)).astype(
        np.float32)
    want = flax_layer(x, kernel, bias, k, stride, relu)
    xt = torch.from_numpy(x).to(BF16)
    x1, x2 = ((xt, None) if not c2 else
              (xt[..., :c1].contiguous(), xt[..., c1:].contiguous()))
    w = torch.from_numpy(kernel).permute(4, 3, 0, 1, 2).to(BF16)
    got = k_punet3.conv3d_ndhwc_plain(x1, w, torch.from_numpy(bias), stride,
                                      relu, x2, BF16, round_sum=True)
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)
    once = k_punet3.conv3d_ndhwc_plain(
        x1, w, torch.from_numpy(bias).to(BF16).float(), stride, relu, x2,
        BF16)
    assert (once.float().numpy() != want).sum() > 0


def _divergent(seed, res, p_obstacle=0.08):
    """(p, U, flags, density) numpy: flags with obstacles, a random U."""
    rng = np.random.default_rng(seed)
    flags = random_flags3(rng, (1, res, res, res), p_obstacle=p_obstacle)
    U = (0.5 * rng.standard_normal((1, 3, res, res, res))).astype(np.float32)
    p = np.zeros((1, res, res, res), np.float32)
    return p, U, flags, p.copy()


def test_trained_layers_match_flax_on_their_inputs():
    """Every layer of the trained PUNet3p8_64 on the flax route in
    bfloat16 at 32^3, fed the port's own activations, against flax's
    bfloat16 layer on the same input."""
    net = build_punet3(load_model_config(str(MODEL_P8)), rounding="flax")
    assert net.act_dtype == BF16 and net.round_sum
    p, U, flags, _ = _divergent(3, 32)
    div = j_ops3d.velocity_divergence3(jnp.asarray(U), jnp.asarray(flags))
    x = torch.stack([torch.from_numpy(np.array(div)) / float(np.std(div)),
                     torch.from_numpy((flags == 2).astype(np.float32))],
                    dim=-1)
    report = []

    def conv(name, h, x2=None, relu=True):
        y = net._plain_conv(name, h, x2, relu)
        assert y.dtype == BF16
        c = net.convs[name]
        hin = h if x2 is None else torch.cat([h, x2], dim=-1)
        want = flax_layer(hin.float().numpy(),
                          c.weight.detach().permute(2, 3, 4, 1, 0).numpy(),
                          c.bias.detach().numpy(), c.kernel_size[0],
                          net.strides[name], relu)
        u = _ulps(y.float().numpy(), want)
        report.append((name, int((u > 0).sum()), float(u.max()), u.size))
        return y

    with torch.no_grad():
        out = net(x, conv=conv)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    print(f"layers' values off flax (count, largest in ulps, of): {report}")
    assert len(report) == 9
    for name, n_off, worst, size in report:
        assert worst <= 1.0, (name, worst)
        assert n_off <= size // 1000, (name, n_off)


def test_packed_route_equals_the_module_forward():
    """pack_weights3 on the flax route: bfloat16 weights, biases rounded
    to bfloat16 in float32; punet3_forward (what kernel N is handed) equals
    the module's own forward bit for bit on the CPU; the fused route keeps
    float32 biases."""
    mcfg = load_model_config(str(MODEL_P8))
    net = build_punet3(mcfg, rounding="flax")
    packed = k_punet3.pack_weights3(net)
    for name, (w, b) in packed.items():
        assert w.dtype == BF16 and torch.equal(b, b.to(BF16).float()), name
    x = torch.randn((1, 16, 16, 16, 2),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = k_punet3.punet3_forward(net, packed, x)
        want = net(x)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    fused = k_punet3.pack_weights3(build_punet3(mcfg))
    assert not all(torch.equal(b, b.to(BF16).float())
                   for _, b in fused.values())


@pytest.mark.parametrize("polish", ["xla16", "none", "refine"])
def test_flax_path_matches_jax_float32(polish):
    """FluidNet3 in float32 on PUNet3p8_64's architecture with seed
    weights, one projection at 32^3 with 8% obstacles, against JAX's
    FluidNet3.apply: polish "xla" (kernel I's plain version, 16 sweeps
    damped 2/3), no polish, and a refinement count both sides ignore."""
    changes = {"xla16": dict(polish_impl="xla", polish_sweeps=16),
               "none": dict(polish_sweeps=0),
               "refine": dict(polish_impl="xla", polish_sweeps=16,
                              punet_refine_convs=1)}[polish]
    mcfg = dataclasses.replace(load_model_config(str(MODEL_P8)),
                               compute_dtype="float32", **changes)
    model = init_params3(FluidNet3(mcfg), 2)
    params = random_flax_params3(model.net.table, 2)
    jmodel = JFluidNet3(JModelConfig(**dataclasses.asdict(mcfg)))
    p, U, flags, rho = _divergent(4, 32)
    want = jax.jit(lambda *a: jmodel.apply(
        {"params": {"PUNet3_0": params}}, *a))(p, U, flags, rho)
    got = make_project_fn3(mcfg, model.net)(
        *(torch.from_numpy(a) for a in (p, U, flags, rho)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_init_params3_and_the_fused_forwards_refusals():
    """init_params3 loads random_flax_params3(seed) into a FluidNet3 or a
    PUNet3; the fused forward raises ValueError where JAX's raises (a
    refinement stack, another polish_impl, a grid that is not a cube) and
    on a net of the other route; FluidNet3 refuses a fused-route net."""
    mcfg = ModelConfig(model="PUNet3", punet_patch=2, punet_widths=(16, 16),
                       compute_dtype="float32", polish_impl="fused",
                       polish_sweeps=2)
    model = init_params3(FluidNet3(mcfg), 9)
    want = flax_to_state_dict3(random_flax_params3(model.net.table, 9))
    for key, t in model.net.state_dict().items():
        assert torch.equal(t, want[key]), key
    net = init_params3(PUNet3.from_config(mcfg), 9)
    assert torch.equal(net.convs["embed"].weight,
                       model.net.convs["embed"].weight)
    for bad in (dict(punet_refine_convs=1), dict(polish_impl="xla")):
        with pytest.raises(ValueError, match="fused 3-D forward"):
            make_project_fn3_fused_forward(
                dataclasses.replace(mcfg, **bad), net)
    with pytest.raises(ValueError, match="rounding"):
        make_project_fn3_fused_forward(mcfg, model.net)
    with pytest.raises(ValueError, match="rounding"):
        FluidNet3(mcfg, net)
    project = make_project_fn3_fused_forward(mcfg, net)
    p, U, flags, rho = (torch.from_numpy(a) for a in _divergent(5, 8))
    assert project(p, U, flags, rho)[0].shape == p.shape
    flat = (torch.from_numpy(np.array(a[:, :, :, :4])) if a.dim() == 4
            else torch.from_numpy(np.array(a[:, :, :, :, :4]))
            for a in (p, U, flags, rho))
    with pytest.raises(ValueError, match="cubic"):
        project(*flat)


def test_run_plume3d_flax_path_on_cpu():
    """run_plume3d's learned case on the flax path (the model as its
    model_config.json ships it: bfloat16, 16 "xla" sweeps) on the CPU:
    finite fields, no kernel launched."""
    out = run_plume3d(16, 2, device="cpu", sim_method="convnet",
                      path="flax")
    st = out["state"]
    assert all(bool(torch.isfinite(t).all()) for t in st[:4])
    assert out["launches_per_step"] == {} and out["weights"] == "trained"
