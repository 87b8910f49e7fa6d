"""Each CUDA kernel's plain PyTorch version against the TPU kernel it
replaces, run as the JAX package's own tests run it on the CPU
(``interpret=True``), at the sizes of tests/test_pallas.py (block 16).

On the CPU the port's kernel wrappers run their plain versions (the
tensors lie on the CPU), so these tests pin the semantics the CUDA kernels
are held to on the card by chip_smoke.py.

Tolerances, relative to the largest magnitude of the reference output:
advection and the projection tail are the same float32 operations in the
same order as the JAX code, held to 1e-5 (XLA's CPU fusion of an
interpreted kernel may contract a multiply-add, which moves the last bits
of a bilinear weight); the PUNet sums its convolutions in another order
than XLA and is held to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.config import ModelConfig
from fluidnet_cxx_tpu.ops import advection as j_adv
from fluidnet_cxx_tpu.ops.pallas.advect_pallas import advect_all_pallas
from fluidnet_cxx_tpu.ops.pallas.proj_tail_pallas import project_tail_pallas
from fluidnet_cxx_tpu.ops.pallas.punet_pallas import make_punet_apply
from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                   random_flax_params)
from fluidnet_cxx_tpu_torch.models.punet import PUNet, layer_table
from fluidnet_cxx_tpu_torch.ops.kernels.advect import advect_all
from fluidnet_cxx_tpu_torch.ops.kernels.proj_tail import project_tail
from fluidnet_cxx_tpu_torch.ops.kernels.punet import (conv2d_nhwc,
                                                      pack_weights,
                                                      net_forward)

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


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=rel * max(1.0, np.abs(want).max()),
                               rtol=0)


def _advect_inputs(rng, n, disp):
    """Flags with obstacles, velocities whose dt*|u| reaches ~``disp``
    cells (up to the window clamp), density in [0, 1)."""
    flags = random_flags(rng, 1, n, n, p_obstacle=0.1)
    U = (disp / 0.3 * rng.uniform(-1, 1, (1, 2, n, n))).astype(np.float32)
    rho = rng.random((1, n, n)).astype(np.float32)
    return flags, U, rho


def test_advect_all_plain_matches_pallas(rng):
    """Kernel A at max_disp 1, line trace on, against advect_all_pallas
    (interpret). The trace-off variant is held to the JAX window engine at
    max_disp 4 below and at max_disp 1 in tests/test_torch_ops.py; each
    interpreted variant costs ~5-10 s of compile here."""
    line_trace = True
    flags, U, rho = _advect_inputs(rng, 32, 1.5)
    want_rho, want_U = advect_all_pallas(
        0.3, jnp.asarray(rho), jnp.asarray(U), jnp.asarray(flags), 0.6,
        max_disp=1, block=16, interpret=True, line_trace=line_trace)
    got_rho, got_U = advect_all(0.3, T(rho), T(U), T(flags), 0.6,
                                max_disp=1, line_trace=line_trace)
    close(got_rho, want_rho, 1e-5)
    close(got_U, want_U, 1e-5)


@pytest.mark.parametrize("line_trace", [False, True])
def test_advect_all_plain_matches_window_d4(rng, line_trace):
    """Kernel A at the slice's max_disp 4, displacements up to the window
    clamp, against the JAX window engine (which tests/test_pallas.py holds
    equal to the Pallas kernel at max_disp 4; interpreting the Pallas
    kernel itself at max_disp 4 takes over a minute on this CPU)."""
    flags, U, rho = _advect_inputs(rng, 32, 5.0)
    kw = dict(maccormack_strength=0.6, impl="window", max_disp=4)
    want_rho = j_adv.advect_scalar(0.3, jnp.asarray(rho), jnp.asarray(U),
                                   jnp.asarray(flags), line_trace=line_trace,
                                   line_trace_impl="firsthit", **kw)
    want_U = j_adv.advect_velocity(0.3, jnp.asarray(U), jnp.asarray(U),
                                   jnp.asarray(flags), **kw)
    got_rho, got_U = advect_all(0.3, T(rho), T(U), T(flags), 0.6,
                                max_disp=4, line_trace=line_trace)
    close(got_rho, want_rho, 1e-5)
    close(got_U, want_U, 1e-5)


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("with_inlet", [False, True])
def test_project_tail_plain_matches_pallas(rng, with_scale, with_inlet):
    """Kernel C against project_tail_pallas (interpret), 32 sweeps."""
    b, h, w = 2, 16, 24
    flags = random_flags(rng, b, h, w, p_obstacle=0.1, p_empty=0.05)
    U = rng.standard_normal((b, 2, h, w)).astype(np.float32)
    p0 = rng.standard_normal((b, h, w)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (b,)).astype(np.float32)
    bc = (rng.standard_normal((b, 2, h, w)) *
          (rng.random((b, 2, h, w)) < 0.2)).astype(np.float32)
    inv = (bc == 0).astype(np.float32)
    jkw, tkw = {}, {}
    if with_scale:
        jkw["scale"], tkw["scale"] = jnp.asarray(scale), T(scale)
    if with_inlet:
        jkw.update(U_bc=jnp.asarray(bc), U_bc_inv_mask=jnp.asarray(inv))
        tkw.update(U_bc=T(bc), U_bc_inv_mask=T(inv))
    want_p, want_U = project_tail_pallas(
        jnp.asarray(flags), jnp.asarray(U), jnp.asarray(p0), 32,
        damping=2.0 / 3.0, interpret=True, **jkw)
    got_p, got_U = project_tail(T(flags), T(U), T(p0), 32,
                                damping=2.0 / 3.0, **tkw)
    close(got_p, want_p, 1e-5)
    close(got_U, want_U, 1e-5)


def test_punet_plain_matches_pallas(rng):
    """Kernel B's forward (PUNet, narrow widths, dilation-2 bottleneck,
    input scaled in the forward) against the fused Pallas forward
    (interpret, float32)."""
    cfg = ModelConfig(model="PUNet", punet_patch=4, punet_widths=(16, 32, 32),
                      punet_level_convs=1, punet_bottleneck_convs=2,
                      punet_bottleneck_dilation=2)
    n = 32
    table = layer_table(2, cfg.punet_patch, cfg.punet_widths, 1, 2, 2)
    params = random_flax_params(table, seed=3)
    for leaf in params.values():   # non-zero biases exercise the bias path
        leaf["bias"] = (0.1 * rng.standard_normal(leaf["bias"].shape)
                        ).astype(np.float32)
    x = rng.standard_normal((2, n, n, 2)).astype(np.float32)
    inv = np.asarray([0.5, 2.0], np.float32)
    fwd = make_punet_apply(cfg, params, n, n, interpret=True,
                           compute_dtype=jnp.float32)
    want = np.asarray(fwd(jnp.asarray(x), inv_scale=jnp.asarray(inv)))
    net = PUNet.from_config(cfg)
    net.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = net_forward(net, pack_weights(net), T(x),
                          inv_scale=T(inv)).numpy()
    assert got.shape == want.shape == (2, n, n, 1)
    close(torch.from_numpy(got), want, 1e-4)


@pytest.mark.parametrize("kernel", ["advect_all", "project_tail", "conv2d"])
def test_wrappers_refuse_other_devices(kernel):
    """A wrapper runs its plain version only for CPU tensors and launches
    its kernel only for CUDA tensors; any other device raises."""
    meta = dict(device="meta")
    flags = torch.ones((1, 8, 8), dtype=torch.int32, **meta)
    U = torch.zeros((1, 2, 8, 8), **meta)
    f = torch.zeros((1, 8, 8), **meta)
    with pytest.raises(ValueError, match="device"):
        if kernel == "advect_all":
            advect_all(0.1, f, U, flags)
        elif kernel == "project_tail":
            project_tail(flags, U, f, 2)
        else:
            conv2d_nhwc(torch.zeros((1, 8, 8, 16), **meta),
                        torch.zeros((1, 1, 16, 16), **meta),
                        torch.zeros((16,), **meta))
