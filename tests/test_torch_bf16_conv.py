"""Kernel B's bfloat16 route, its plain version against flax on the CPU.

flax ``nn.Conv(dtype="bfloat16")`` casts the input, kernel and bias to
bfloat16; JAX on the CPU computes the convolution in float32 (every
bf16 x bf16 product is exact there), rounds the sum to bfloat16, adds the
bias in float32 and rounds again, then the ReLU (the optimised HLO keeps
both converts; ``jax_disable_most_optimizations`` changes no layer's
output). ``conv2d_nhwc_plain`` on bfloat16 inputs rounds at the same
points.

* One layer, bit for bit: inputs of a few significand bits, so that every
  float32 sum is exact whatever its order and only the rounding points
  are under test: 3x3 at stride 1, dilation 2 and stride 2 (flax's (0, 1)
  SAME pads), 1x1, with and without ReLU, the skip concat; and a single
  rounding after the bias add is shown to miss.
* Every layer of the trained MGCoarse_128 on a 128^2 coarse solve, each
  fed the port's own activations and held to flax's layer on the same
  input: within one bfloat16 ulp, and in fewer than one value in 1000 (a
  float32 sum taken in another order lands on the other side of a
  rounding point).
* The packed route (``pack_weights``/``net_forward``, what kernel B is
  handed) equal to the module's own bfloat16 forward.
* The trained net and the V-cycle around it (one cold V-cycle at 256^2,
  the 128^2 cut level) against JAX's under both XLA settings the tests
  use, default and ``jax_disable_most_optimizations``: the gaps printed
  (``pytest -s``) and held as tests/test_torch_mg_learned.py holds them
  (output 3e-2, pressure 8e-3 of the largest value); JAX's net gives the
  same output under both settings (1e-6), its V-cycle's pressure does
  not (printed: the scale of the gap that rounding order leaves).
* The summation-order witness inside JAX (ROADMAP C.7): JAX's own
  bfloat16 net on the transposed problem (flags and rhs transposed, each
  kernel's taps transposed, the space-to-depth channel orders folded into
  the weights that read or write them), which differs from the direct one
  only in the order of its float32 sums (the float32 net commutes with the
  transposition to 1e-5), transposed back and held to JAX's direct output:
  its largest gap over the two 128^2 cut inputs within 3x of the port's
  largest (``pytest -s`` prints both).
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.models import mg_coarse as j_mgc
from fluidnet_cxx_tpu.models import punet as j_punet
from fluidnet_cxx_tpu.ops import multigrid as j_mg
from fluidnet_cxx_tpu.ops import stencils as j_st
from fluidnet_cxx_tpu_torch.models import mg_coarse as t_mgc
from fluidnet_cxx_tpu_torch.ops import multigrid as t_mg
from fluidnet_cxx_tpu_torch.ops.kernels import mg as k_mg
from fluidnet_cxx_tpu_torch.ops.kernels import punet as k_punet
from fluidnet_cxx_tpu_torch.run_plume import build_mg_coarse

torch.set_num_threads(1)
BF16 = torch.bfloat16

# (kernel, stride, dilation, relu, c1, c2, co)
LAYERS = [(3, 1, 1, True, 32, 0, 32), (3, 1, 2, True, 32, 0, 32),
          (3, 2, 1, True, 32, 0, 64), (1, 1, 1, False, 64, 0, 64),
          (3, 1, 1, True, 32, 32, 32), (3, 1, 1, False, 32, 0, 16)]


def dyadic(rng, shape, num, den):
    """Values k / den, |k| <= num: exact in bfloat16, and every product
    and partial sum of the layers below exact in float32."""
    return (rng.integers(-num, num + 1, shape) / den).astype(np.float32)


def flax_layer(x, kernel, bias, k, stride, dil, relu):
    conv = nn.Conv(kernel.shape[-1], (k, k), strides=(stride, stride),
                   padding="SAME", dtype="bfloat16",
                   kernel_dilation=(dil, dil))
    y = conv.apply({"params": {"kernel": kernel, "bias": bias}}, x)
    return np.asarray((nn.relu(y) if relu else y).astype(jnp.float32))


def port_layer(x, kernel, bias, stride, dil, relu, c1):
    xt = torch.from_numpy(x).to(BF16)
    x1, x2 = (xt, None) if c1 == x.shape[-1] else (xt[..., :c1].contiguous(),
                                                   xt[..., c1:].contiguous())
    w = torch.from_numpy(kernel).permute(3, 2, 0, 1)
    y = k_punet.conv2d_nhwc_plain(x1, w, torch.from_numpy(bias), stride,
                                  dil, relu, x2)
    assert y.dtype == BF16
    return y.float().numpy()


@pytest.mark.parametrize("k,stride,dil,relu,c1,c2,co", LAYERS,
                         ids=[f"k{c[0]}-s{c[1]}-d{c[2]}-"
                              f"{'relu' if c[3] else 'lin'}-{c[4]}+{c[5]}"
                              f"to{c[6]}" for c in LAYERS])
def test_layer_bit_equal_to_flax(rng, k, stride, dil, relu, c1, c2, co):
    x = dyadic(rng, (2, 16, 16, c1 + c2), 16, 8)
    kernel = dyadic(rng, (k, k, c1 + c2, co), 16, 64)
    bias = (dyadic(rng, (co,), 64, 128) + np.float32(1 / 3)).astype(
        np.float32)
    want = flax_layer(x, kernel, bias, k, stride, dil, relu)
    got = port_layer(x, kernel, bias, stride, dil, relu, c1)
    np.testing.assert_array_equal(got, want)
    # One rounding, after a float32 bias add, misses flax.
    xt = torch.from_numpy(x).to(BF16).float()
    once = k_punet.conv2d_nhwc_plain(
        xt, torch.from_numpy(kernel).to(BF16).float().permute(3, 2, 0, 1),
        torch.from_numpy(bias).to(BF16).float(), stride, dil, relu)
    assert (once.to(BF16).float().numpy() != want).sum() > 0


def _scene(rng, p_obstacle):
    """(flags, div) at 256^2: walls, random obstacles, the divergence of a
    random U after the wall BCs (tests/test_torch_mg_learned.py's)."""
    flags = random_flags(rng, 1, 256, 256, p_obstacle=p_obstacle)
    U = j_st.set_wall_bcs(jnp.asarray(rng.standard_normal((1, 2, 256, 256)),
                                      jnp.float32), jnp.asarray(flags))
    return flags, np.array(j_st.velocity_divergence(U, jnp.asarray(flags)))


def _coarse_input(rng, p_obstacle):
    """The trained net's input on the cut level of one cold V-cycle at
    256^2 (tests/test_torch_mg_learned.py's coarse solve)."""
    flags, div = _scene(rng, p_obstacle)
    flags_c, rhs_c = t_mg.mg_cut_rhs(torch.from_numpy(flags),
                                     torch.from_numpy(div), coarse_size=128)
    cont = t_mgc._cont(flags_c)
    n_live = cont.sum(dim=(1, 2), keepdim=True).clamp(min=1.0)
    s = torch.sqrt(((rhs_c * cont) ** 2).sum(dim=(1, 2), keepdim=True)
                   / n_live) + 1e-8
    return torch.stack([rhs_c / s * cont, cont], dim=-1)


def _ulps(got, want):
    """|got - want| in bfloat16 ulps of want (values that are equal: 0)."""
    a = np.abs(want)
    ulp = np.where(a > 0, np.exp2(np.floor(np.log2(np.maximum(a, 1e-30)))
                                  - 7), 2.0 ** -133)
    return np.abs(got - want) / ulp


@pytest.mark.parametrize("p_obstacle", [0.0, 0.08])
def test_trained_layers_match_flax_on_their_inputs(rng, p_obstacle):
    model = build_mg_coarse()
    assert model.punet.compute_dtype == BF16
    net = model.punet
    x = _coarse_input(rng, p_obstacle)
    report = []

    def conv(name, h, x2=None, relu=True, in_scale=None, scale_mod=1):
        y = net._plain_conv(name, h, x2, relu)
        k, stride, dil = net.geometry[name]
        c = net.convs[name]
        hin = h.to(BF16) if x2 is None else torch.cat(
            [h.to(BF16), x2.to(BF16)], dim=-1)
        want = flax_layer(hin.float().numpy(),
                          c.weight.detach().permute(2, 3, 1, 0).numpy(),
                          c.bias.detach().numpy(), k, stride, dil, relu)
        u = _ulps(y.float().numpy(), want)
        report.append((name, int((u > 0).sum()), float(u.max()), u.size))
        return y

    with torch.no_grad():
        out = net(x, conv=conv)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    print(f"obstacles {p_obstacle}: layers' values off flax (count, "
          f"largest in ulps, of): {report}")
    for name, n_off, worst, size in report:
        assert worst <= 1.0, (name, worst)
        assert n_off <= size // 1000, (name, n_off)


def test_packed_route_equals_the_module_forward(rng):
    """pack_weights casts the weights once (bfloat16 weights, biases
    rounded to bfloat16 in float32) and net_forward the input; on the CPU
    the result equals the module's own bfloat16 forward bit for bit. A
    bfloat16 conv that autograd follows runs ConvNHWC (its gradients:
    tests/test_torch_bf16_grad.py): a bfloat16 output, a bfloat16 weight
    gradient."""
    model = build_mg_coarse()
    x = _coarse_input(rng, 0.08)
    with torch.no_grad():
        packed = k_punet.pack_weights(model.punet)
        w, b = packed["enc0_0"]
        assert w.dtype == BF16 and b.dtype == torch.float32
        assert torch.equal(b, b.to(BF16).float())
        got = k_punet.net_forward(model.punet, packed, x)
        want = model.punet(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    y = k_punet.conv2d_nhwc_autograd(
        x[..., :1].repeat(1, 1, 1, 64).to(BF16), w.requires_grad_(), b, 1)
    assert y.dtype == BF16 and y.requires_grad
    y.float().sum().backward()
    assert w.grad.dtype == BF16 and float(w.grad.abs().max()) > 0


def _flax_params(model):
    out = {}
    for key, t in model.state_dict().items():
        _, _, name, kind = key.split(".")
        out.setdefault(name, {})["kernel" if kind == "weight" else "bias"] = (
            t.permute(2, 3, 1, 0).numpy() if kind == "weight" else t.numpy())
    return {"params": {"punet": out}}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("p_obstacle", [0.0, 0.08])
def test_trained_gap_under_both_xla_settings(rng, p_obstacle):
    model = build_mg_coarse()
    flags, div = _scene(rng, p_obstacle)
    flags_c, rhs_c = t_mg.mg_cut_rhs(torch.from_numpy(flags),
                                     torch.from_numpy(div), coarse_size=128)
    with torch.no_grad():
        got = model(flags_c, rhs_c).numpy()
        got_p = k_mg.solve_mg(torch.from_numpy(flags), torch.from_numpy(div),
                              n_vcycles=1,
                              coarse_fn=t_mgc.make_coarse_fn(model)).numpy()
    jnet = j_mgc.MGCoarseNet(j_mgc.MGCoarseConfig(**vars(model.cfg)))
    params = _flax_params(model)
    old = jax.config.read("jax_disable_most_optimizations")
    want = {}
    try:
        for flag in (False, True):
            jax.config.update("jax_disable_most_optimizations", flag)
            want[flag] = (
                np.asarray(jax.jit(jnet.apply)(params, flags_c.numpy(),
                                               rhs_c.numpy())),
                np.asarray(jax.jit(lambda f, d: j_mg.solve_mg(
                    f, d, n_vcycles=1,
                    coarse_fn=j_mgc.make_coarse_fn(jnet, params)))(flags,
                                                                   div)))
    finally:
        jax.config.update("jax_disable_most_optimizations", old)
    for flag, (w, wp) in want.items():
        print(f"obstacles {p_obstacle}, optimisations "
              f"{'off' if flag else 'default'}: gap to JAX's bfloat16 net, "
              f"output {_rel(got, w):.2e}, p {_rel(got_p, wp):.2e}")
        assert _rel(got, w) <= 3e-2 and _rel(got_p, wp) <= 8e-3
    (a, ap), (b, bp) = want[False], want[True]
    print(f"obstacles {p_obstacle}: JAX default against optimisations off, "
          f"output {_rel(b, a):.2e}, p {_rel(bp, ap):.2e}")
    assert _rel(b, a) <= 1e-6


def _s2d_order(p, c):
    """Channel j of space_to_depth(p) of a transposed map is channel
    order[j] of the map's (patch offsets (dy, dx) swapped)."""
    return np.arange(p * p * c).reshape(p, p, c).transpose(1, 0, 2).reshape(-1)


def _transposed_params(params, patch):
    """The flax PUNet's params for transposed inputs: every kernel's taps
    transposed, s2d(patch)'s channel order folded into embed's input rows,
    depth_to_space's into the up convs' (2) and head's (patch) outputs."""
    out = {}
    for name, d in params.items():
        k = np.asarray(d["kernel"]).transpose(1, 0, 2, 3)
        b = np.asarray(d["bias"])
        if name == "embed":
            k = k[:, :, _s2d_order(patch, k.shape[2] // patch ** 2)]
        p = 2 if name.startswith("up") else patch if name == "head" else 0
        if p:
            order = _s2d_order(p, k.shape[-1] // p ** 2)
            k, b = k[..., order], b[order]
        out[name] = {"kernel": k, "bias": b}
    return out


def test_c7_summation_order_witness():
    model = build_mg_coarse()
    cfg = model.cfg
    params = _flax_params(model)
    net = params["params"]["punet"]
    tparams = {"params": {"punet": _transposed_params(net, cfg.patch)}}
    # The witness changes nothing but the summation order: in float32 the
    # net commutes with the transposition.
    p32 = j_punet.PUNet(patch=cfg.patch, widths=tuple(cfg.widths),
                        level_convs=cfg.level_convs,
                        bottleneck_convs=cfg.bottleneck_convs,
                        bottleneck_dilation=cfg.bottleneck_dilation,
                        refine_convs=0, dtype="float32")
    x = np.random.default_rng(1).standard_normal((1, 128, 128, 2)).astype(
        np.float32)
    f32 = jax.jit(p32.apply)
    a = np.asarray(f32({"params": net}, x))
    b = np.asarray(f32({"params": tparams["params"]["punet"]},
                       x.transpose(0, 2, 1, 3)))
    commute = _rel(b.transpose(0, 2, 1, 3), a)
    print(f"float32 net, transposed problem against direct: {commute:.2e}")
    assert commute <= 1e-5

    jnet = j_mgc.MGCoarseNet(j_mgc.MGCoarseConfig(**vars(cfg)))
    apply = jax.jit(jnet.apply)
    gaps = []
    for p_obstacle in (0.0, 0.08):
        flags, div = _scene(np.random.default_rng(0), p_obstacle)
        flags_c, rhs_c = t_mg.mg_cut_rhs(torch.from_numpy(flags),
                                         torch.from_numpy(div),
                                         coarse_size=128)
        with torch.no_grad():
            got = model(flags_c, rhs_c).numpy()
        f, r = flags_c.numpy(), rhs_c.numpy()
        want = np.asarray(apply(params, f, r))
        swapped = np.asarray(apply(tparams, f.transpose(0, 2, 1).copy(),
                                   r.transpose(0, 2, 1).copy()))
        gaps.append((_rel(got, want), _rel(swapped.transpose(0, 2, 1), want)))
        print(f"obstacles {p_obstacle}: gap to JAX's bfloat16 net at the "
              f"128^2 cut, port {gaps[-1][0]:.3e}, JAX's own on the "
              f"transposed problem {gaps[-1][1]:.3e}")
    port, own = max(g[0] for g in gaps), max(g[1] for g in gaps)
    assert own * 3 >= port
