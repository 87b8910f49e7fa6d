"""Kernel N's plain versions against the JAX package on the CPU: the
space-to-depth reshapes, one convolution of each layer kind, the port's
PUNet3 forward against the interpreted Pallas kernel
(``make_punet3_apply(..., interpret=True)``, also with the trained
``PUNet3p8_64``), the flax-to-torch converter and the wrapper's CPU path.

Tolerances:
- float32: 1e-5 of the largest output for one layer, 1e-4 for the whole
  forward (the two frameworks sum each convolution in another order);
- bfloat16, one layer: each value within one bfloat16 ulp of JAX's, or
  1e-5 of the largest output near zero (a sum in another order may round
  to the neighbouring bfloat16);
- bfloat16, the whole forward: 5e-3 of the largest output. Measured here
  against the interpreted kernel: 8.3e-4 (16^3, patch 4), 2.9e-6 (32^3,
  patch 8), 2.7e-3 (32^3, patch 4; 1.8e-3 on another input). Summing the
  port's own convolutions in float64 instead of float32, at the same
  rounding points, moves the 32^3 patch-4 forward by 2.1e-3: an activation
  near a rounding boundary lands on the neighbouring bfloat16 and the
  next layers carry it on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.config import ModelConfig as JaxModelConfig
from fluidnet_cxx_tpu.models.punet3d import PUNet3 as FlaxPUNet3
from fluidnet_cxx_tpu.models.punet3d import depth_to_space3 as jax_d2s3
from fluidnet_cxx_tpu.models.punet3d import space_to_depth3 as jax_s2d3
from fluidnet_cxx_tpu.ops.pallas.punet3_pallas import make_punet3_apply
from fluidnet_cxx_tpu_torch.config import ModelConfig, load_model_config
from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict3,
                                                   load_state_dict_file,
                                                   random_flax_params3)
from fluidnet_cxx_tpu_torch.models.punet3d import (PUNet3, depth_to_space3,
                                                   layer_table3,
                                                   space_to_depth3)
from fluidnet_cxx_tpu_torch.ops.kernels import punet3

torch.set_num_threads(1)

WIDTHS = (96, 128)
BF16_FORWARD_REL = 5e-3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _port_net(patch, dtype, params):
    net = PUNet3(2, patch, WIDTHS, 1, 2, dtype)
    net.load_state_dict(flax_to_state_dict3(params))
    return net


def _jax_forward(patch, dtype, params, x):
    """The interpreted Pallas kernel's forward of NDHWC ``x``."""
    cfg = JaxModelConfig(model="PUNet3", punet_patch=patch,
                         punet_widths=WIDTHS, punet_level_convs=1,
                         punet_bottleneck_convs=2, punet_refine_convs=0,
                         compute_dtype=dtype)
    d = x.shape[1]
    fwd = make_punet3_apply(cfg, params, d, d, d, interpret=True,
                            compute_dtype=DTYPES[dtype][0])
    return np.asarray(fwd(jnp.asarray(x)))


def _inputs(rng, res):
    """[divergence-like noise, 10% occupancy] at res^3, NDHWC."""
    x = rng.standard_normal((1, res, res, res, 2)).astype(np.float32)
    x[..., 1] = rng.random((1, res, res, res)) < 0.1
    return x


def test_space_to_depth3_keeps_flax_channel_order(rng):
    """Channels are ordered (pz, py, px, c), as JAX's; torch's
    pixel-shuffle order differs; depth_to_space3 inverts both ways."""
    x = rng.standard_normal((2, 8, 8, 8, 3)).astype(np.float32)
    got = space_to_depth3(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_s2d3(jnp.asarray(x), 4)))
    y = rng.standard_normal((1, 2, 2, 2, 8 * 96)).astype(np.float32)
    np.testing.assert_array_equal(
        depth_to_space3(torch.from_numpy(y), 2).numpy(),
        np.asarray(jax_d2s3(jnp.asarray(y), 2)))
    np.testing.assert_array_equal(depth_to_space3(got, 4).numpy(), x)
    # The pixel-shuffle order (c, pz, py, px) is another permutation.
    t = torch.from_numpy(x).reshape(2, 2, 4, 2, 4, 2, 4, 3)
    shuffle_order = t.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(
        2, 2, 2, 2, 192)
    assert not torch.equal(shuffle_order, got)


def _jax_layer(x, w, b, stride, relu, x2, out_dtype):
    """One layer with the TPU kernel's arithmetic in JAX: SAME conv of the
    (already rounded) inputs with float32 products and sums, bias, ReLU,
    then the output's rounding."""
    h = jnp.asarray(x.float().numpy())
    if x2 is not None:
        h = jnp.concatenate([h, jnp.asarray(x2.float().numpy())], axis=-1)
    y = jax.lax.conv_general_dilated(
        h, jnp.asarray(w.float().numpy()), (stride,) * 3, "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST) + jnp.asarray(b.numpy())
    if relu:
        y = jnp.maximum(y, 0.0)
    return np.asarray(y.astype(DTYPES[out_dtype][0]).astype(jnp.float32))


LAYERS = {  # kind: (input shape, skip channels, c_out, k, stride, relu)
    "1x1": ((1, 4, 4, 4, 64), 0, 48, 1, 1, True),
    "3x3x3": ((1, 6, 6, 6, 32), 0, 40, 3, 1, True),
    "stride2": ((2, 8, 8, 8, 32), 0, 24, 3, 2, True),
    "stride2_odd": ((1, 5, 5, 5, 16), 0, 24, 3, 2, True),
    "concat": ((1, 6, 6, 6, 32), 32, 24, 3, 1, True),
    "head": ((1, 4, 4, 4, 32), 0, 64, 1, 1, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_conv3d_plain_matches_jax_layer(kind, dtype):
    """conv3d_ndhwc_plain (flax SAME padding, (0, 1) for stride 2 on an
    even input; DHWIO weights; the concat's [x | skip] with x float32 and
    the skip in the compute dtype) against lax.conv_general_dilated."""
    shape, c2, co, k, stride, relu = LAYERS[kind]
    gen = torch.Generator().manual_seed(1)
    act = DTYPES[dtype][1]
    x = torch.randn(shape, generator=gen).to(torch.float32 if c2 else act)
    x2 = (torch.randn(shape[:-1] + (c2,), generator=gen).to(act) if c2
          else None)
    cin = shape[-1] + c2
    w = (torch.randn((k, k, k, cin, co), generator=gen)
         / (k ** 3 * cin) ** 0.5).to(act)
    b = 0.1 * torch.randn((co,), generator=gen)
    out_dtype = dtype if relu else "float32"
    got = punet3.conv3d_ndhwc_plain(x, w.permute(4, 3, 0, 1, 2), b, stride,
                                    relu, x2, DTYPES[out_dtype][1])
    want = _jax_layer(x, w, b, stride, relu, x2, out_dtype)
    assert got.dtype == DTYPES[out_dtype][1]
    assert tuple(got.shape) == want.shape
    got, scale = got.float().numpy(), np.abs(want).max()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        a = np.abs(want)
        ulp = np.where(a > 0, np.exp2(np.floor(np.log2(np.where(
            a > 0, a, 1.0))) - 7), 0.0)
        assert (np.abs(got - want) <= np.maximum(ulp, 1e-5 * scale)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("patch,res", [(4, 16), (8, 32), (4, 32)])
def test_punet3_forward_matches_interpreted_kernel(rng, patch, res, dtype):
    """The port's PUNet3 forward (kernel N's plain version, with the TPU
    kernel's rounding points) against the interpreted Pallas kernel at
    full widths: g0 4 (patch 4 at 16^3, patch 8 at 32^3) and g0 8."""
    params = random_flax_params3(layer_table3(2, patch, WIDTHS, 1, 2),
                                 seed=1)
    x = _inputs(rng, res)
    want = _jax_forward(patch, dtype, params, x)
    with torch.no_grad():
        got = _port_net(patch, dtype, params)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (1, res, res, res, 1)
    rel = 1e-4 if dtype == "float32" else BF16_FORWARD_REL
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_converter3_against_flax_init(rng):
    """The converter (DHWIO -> OIDHW) on flax-initialised params, held to
    the flax PUNet3 in float32; the port's numpy initialiser draws the
    same tree of shapes at lecun-normal scale (fan_in 27 c_in, c_in for a
    1x1x1 conv) with zero biases."""
    flax_net = FlaxPUNet3(patch=4, widths=WIDTHS, level_convs=1,
                          bottleneck_convs=2, dtype="float32")
    x = _inputs(rng, 16)
    params = flax_net.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(flax_net.apply({"params": params}, jnp.asarray(x)))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    with torch.no_grad():
        got = _port_net(4, "float32", np_params)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())

    mine = random_flax_params3(layer_table3(2, 4, WIDTHS, 1, 2), seed=0)
    assert set(mine) == set(params)
    for name, leaf in mine.items():
        assert leaf["kernel"].shape == params[name]["kernel"].shape, name
        assert leaf["bias"].shape == params[name]["bias"].shape, name
        assert not leaf["bias"].any()
        k = leaf["kernel"]
        lecun = np.sqrt(1.0 / np.prod(k.shape[:4]))
        assert abs(k.std() / lecun - 1.0) < 0.1, name


def test_trained_checkpoint3_matches_interpreted_kernel(rng):
    """The trained PUNet3p8_64 as the port loads it (its committed
    conversion, which tests/test_torch_weights.py holds bit for bit to the
    orbax checkpoint read by the JAX package's loader): the port's
    bfloat16 forward at 32^3 against the interpreted fused forward on the
    same parameters carried back to flax's layout, and
    random_flax_params3 draws the checkpoint's shapes."""
    model_dir = "trained_models/PUNet3p8_64"
    sd = load_state_dict_file(model_dir)
    params = {}
    for key, t in sd.items():
        _, name, kind = key.split(".")
        params.setdefault(name, {})[
            "kernel" if kind == "weight" else "bias"] = (
            t.permute(2, 3, 4, 1, 0).numpy() if kind == "weight"
            else t.numpy())
    mcfg = load_model_config(model_dir)
    assert mcfg.compute_dtype == "bfloat16" and mcfg.punet_patch == 8
    net = PUNet3.from_config(mcfg)
    net.load_state_dict(flax_to_state_dict3(params))
    x = _inputs(rng, 32)
    want = _jax_forward(8, "bfloat16", params, x)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_FORWARD_REL * np.abs(want).max())

    mine = random_flax_params3(net.table, seed=0)
    assert set(mine) == set(params)
    for name, leaf in mine.items():
        assert leaf["kernel"].shape == params[name]["kernel"].shape, name
        assert leaf["bias"].shape == params[name]["bias"].shape, name


def test_from_config_takes_both_dtypes_and_refuses_the_rest():
    """bfloat16 and float32 build on both rounding routes; a refinement
    stack is ignored, as the JAX PUNet3 has none; another dtype raises,
    another model raises naming ROADMAP A.4, another rounding ValueError."""
    for dtype in ("bfloat16", "float32"):
        cfg = ModelConfig(model="PUNet3", punet_patch=4, punet_widths=WIDTHS,
                          punet_bottleneck_convs=2, compute_dtype=dtype)
        net = PUNet3.from_config(cfg)
        assert net.act_dtype == DTYPES[dtype][1]
        assert [name for name, *_ in net.table] == [
            "embed", "enc0_0", "down1", "enc1_0", "mid0", "mid1", "up0",
            "dec0_0", "head"]
        for rounding in ("flax", "fused"):
            net = PUNet3.from_config(cfg, rounding)
            assert net.round_sum == (rounding == "flax"
                                     and dtype == "bfloat16")
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        PUNet3.from_config(ModelConfig(model="PUNet3",
                                       compute_dtype="float16"))
    refine = PUNet3.from_config(ModelConfig(model="PUNet3",
                                            punet_refine_convs=1))
    assert [name for name, *_ in refine.table][-1] == "head"
    with pytest.raises(NotImplementedError, match="ROADMAP A.4"):
        PUNet3.from_config(ModelConfig(model="PUNet"))
    with pytest.raises(ValueError, match="rounding"):
        PUNet3.from_config(ModelConfig(model="PUNet3"), "xla")


def test_kernel_wrapper_on_cpu_runs_the_plain_version():
    """On CPU tensors punet3_forward runs the module's plain convolutions
    (weights packed once, DHWIO, bfloat16) and launches nothing."""
    cfg = ModelConfig(model="PUNet3", punet_patch=4, punet_widths=WIDTHS,
                      punet_bottleneck_convs=2, compute_dtype="bfloat16")
    net = PUNet3.from_config(cfg)
    packed = punet3.pack_weights3(net)
    w, b = packed["dec0_0"]
    assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
    assert tuple(w.shape) == (3, 3, 3, 192, 96) and w.is_contiguous()
    x = torch.randn((1, 16, 16, 16, 2),
                    generator=torch.Generator().manual_seed(0))
    before = punet3.conv3d_ndhwc.launches
    with torch.no_grad():
        got = punet3.punet3_forward(net, packed, x)
        want = net(x)
    assert punet3.conv3d_ndhwc.launches == before
    assert torch.equal(got, want)


def test_conv_wrapper_refuses_other_devices():
    """N's wrapper runs its plain version only for CPU tensors and
    launches its kernel only for CUDA tensors; any other device raises."""
    x = torch.zeros((1, 4, 4, 4, 16), device="meta")
    w = torch.zeros((1, 1, 1, 16, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        punet3.conv3d_ndhwc(x, w, torch.zeros((16,), device="meta"))
