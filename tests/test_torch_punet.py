"""The port's PUNet and its flax-to-torch converter against the JAX
package's flax PUNet, on the CPU.

Tolerance: the two frameworks sum each convolution in a different order,
so outputs are held to 1e-4 relative to the output's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fluidnet_cxx_tpu.models.fluidnet import FluidNet
from fluidnet_cxx_tpu.models.punet import PUNet as FlaxPUNet
from fluidnet_cxx_tpu.models.punet import space_to_depth as flax_s2d
from fluidnet_cxx_tpu.train import TrainConfig, init_train_state
from fluidnet_cxx_tpu.train.checkpoint import load_train_checkpoint
from fluidnet_cxx_tpu_torch.config import load_model_config
from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                   random_flax_params)
from fluidnet_cxx_tpu_torch.models.punet import (PUNet, depth_to_space,
                                                 layer_table, space_to_depth)
from fluidnet_cxx_tpu_torch.ops.kernels.punet import same_pads

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """The JAX reference is compile-bound here (one small XLA program per
    op and window offset); XLA's optimisation passes change no result
    beyond rounding and double its compile time, so this module runs
    without them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)

MODEL_DIR = "trained_models/PUNetD2_128"


def _flax_net(mcfg):
    return FlaxPUNet(patch=mcfg.punet_patch, widths=mcfg.punet_widths,
                     level_convs=mcfg.punet_level_convs,
                     bottleneck_convs=mcfg.punet_bottleneck_convs,
                     bottleneck_dilation=mcfg.punet_bottleneck_dilation,
                     dtype="float32")


def _port_net(mcfg, flax_params):
    net = PUNet.from_config(mcfg)
    net.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, flax_params)))
    return net


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_space_to_depth_keeps_flax_channel_order(rng):
    """Trap 1: flax orders s2d channels (py, px, c); pixel_unshuffle orders
    them (c, py, px). The port keeps flax's order, and d2s inverts it."""
    x = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    got = space_to_depth(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(flax_s2d(jnp.asarray(x), 4)))
    shuffled = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 4)
    assert not torch.equal(shuffled.permute(0, 2, 3, 1), got)
    np.testing.assert_array_equal(depth_to_space(got, 4).numpy(), x)


@pytest.mark.parametrize("size,k,stride,dil", [(64, 3, 2, 1), (16, 3, 1, 2),
                                               (64, 1, 1, 1), (32, 3, 1, 1)])
def test_same_padding_matches_flax(size, k, stride, dil):
    """Trap 2: flax 'SAME' on an even input pads a stride-2 conv (0, 1)."""
    want = jax.lax.padtype_to_pads((size,), ((k - 1) * dil + 1,), (stride,),
                                   "SAME")[0]
    assert same_pads(size, k, stride, dil) == tuple(want)


def test_converter_random_flax_params_full_widths(rng):
    """The converter (trap 3: HWIO -> OIHW) on flax-initialised params at
    PUNetD2_128's full widths; the port's numpy initialiser draws the same
    tree of shapes as flax's, at lecun-normal scale."""
    mcfg = load_model_config(MODEL_DIR)
    flax_net = _flax_net(mcfg)
    x = rng.standard_normal((1, 64, 64, 2)).astype(np.float32)
    params = jax.jit(flax_net.init)(jax.random.PRNGKey(0),
                                    jnp.asarray(x))["params"]
    want = jax.jit(flax_net.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port_net(mcfg, params)(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 64, 64, 1)
    _close(got, want)

    net = PUNet.from_config(mcfg)
    mine = random_flax_params(
        layer_table(2, mcfg.punet_patch, mcfg.punet_widths, 1, 3, 2), seed=0)
    assert set(mine) == set(params)
    for name, leaf in mine.items():
        assert leaf["kernel"].shape == params[name]["kernel"].shape
        assert leaf["bias"].shape == params[name]["bias"].shape
        k = leaf["kernel"]
        lecun = np.sqrt(1.0 / np.prod(k.shape[:3]))
        assert abs(k.std() / lecun - 1.0) < 0.1, name
    net.load_state_dict(flax_to_state_dict(mine))


def test_trained_checkpoint_forward_matches_flax(rng):
    """The PUNetD2_128 orbax checkpoint, read on the CPU by the JAX
    package's loader and converted: the port's forward equals flax's."""
    from fluidnet_cxx_tpu.train.checkpoint import load_model_config as jload

    jcfg = jload(MODEL_DIR)
    template = jax.jit(lambda k: init_train_state(
        FluidNet(jcfg), k, TrainConfig(), 64, 64))(jax.random.PRNGKey(0))
    ts, _, _ = load_train_checkpoint(MODEL_DIR, template, best=True)
    params = ts.params["params"]["PUNet_0"]
    mcfg = load_model_config(MODEL_DIR)
    x = rng.standard_normal((1, 64, 64, 2)).astype(np.float32)
    want = jax.jit(_flax_net(mcfg).apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port_net(mcfg, params)(torch.from_numpy(x)).numpy()
    _close(got, want)
