"""The unfused advection branch against the JAX package, on the CPU:
kernels D (scalar) and E (velocity, with and without a viscous ``orig``)
and A with ``orig``, each as its plain PyTorch version against the TPU
kernel it replaces run in interpret mode (as tests/test_pallas.py runs
them, block 16), then three steps of the 64^2 plume with unfused
advection against ``simulate_step``; the knobs that raised before the
port took their branches (the march trace and the gather engine, stepped
against the JAX step); and the sim_method the step does not know, which
raises.

On the CPU the kernel wrappers run their plain versions (the tensors lie
on the CPU), so these tests pin the semantics the CUDA kernels are held to
on the card by chip_smoke.py.

Tolerances: the kernels' plain versions are the same float32 operations
in the same order as the JAX code and are held to 1e-5 of the largest
output (XLA's CPU fusion of an interpreted kernel may contract a
multiply-add, which moves the last bits of a bilinear weight); the steps
to 1e-4 of each field's largest value, for the Jacobi sums of 28 sweeps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.ops.pallas.advect_pallas import (advect_all_pallas,
                                                       advect_scalar_pallas,
                                                       advect_velocity_pallas)
from fluidnet_cxx_tpu.sim import create_plume_scene as j_scene
from fluidnet_cxx_tpu.sim import plume_config as j_config
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu_torch.config import ModelConfig
from fluidnet_cxx_tpu_torch.models.fluidnet import make_net
from fluidnet_cxx_tpu_torch.models.punet import PUNet
from fluidnet_cxx_tpu_torch.ops.kernels.advect import (advect_all,
                                                       advect_scalar,
                                                       advect_velocity)
from fluidnet_cxx_tpu_torch.run_plume import plume_case
from fluidnet_cxx_tpu_torch.sim.scenes import plume_config
from fluidnet_cxx_tpu_torch.sim.step import simulate_step

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


def _inputs(rng, n=32, disp=1.5):
    """Flags with obstacles, velocities whose dt*|u| reaches ~``disp``
    cells at dt 0.3, density in [0, 1), and an ``orig`` far from U (U
    plus a field of the same scale)."""
    flags = random_flags(rng, 1, n, n, p_obstacle=0.1)
    U = (disp / 0.3 * rng.uniform(-1, 1, (1, 2, n, n))).astype(np.float32)
    rho = rng.random((1, n, n)).astype(np.float32)
    orig = (U + disp / 0.3 * rng.uniform(-1, 1, U.shape)).astype(np.float32)
    return flags, U, rho, orig


def test_advect_scalar_plain_matches_pallas(rng):
    """Kernel D, first-hit trace, max_disp 1, against
    advect_scalar_pallas (interpret)."""
    flags, U, rho, _ = _inputs(rng)
    want = advect_scalar_pallas(
        0.3, jnp.asarray(rho), jnp.asarray(U), jnp.asarray(flags), 0.6,
        max_disp=1, block=16, interpret=True, line_trace=True)
    got = advect_scalar(0.3, T(rho), T(U), T(flags), 0.6, max_disp=1,
                        line_trace=True)
    close(got, want, 1e-5)


@pytest.mark.parametrize("with_orig", [False, True])
def test_advect_velocity_plain_matches_pallas(rng, with_orig):
    """Kernel E, max_disp 1, against advect_velocity_pallas (interpret),
    U advecting itself and U advecting an ``orig`` far from it (the MAC
    vectors come from U, the samples, correction and clamp from orig)."""
    flags, U, _, orig = _inputs(rng)
    j_orig = jnp.asarray(orig) if with_orig else None
    t_orig = T(orig) if with_orig else None
    want = advect_velocity_pallas(0.3, jnp.asarray(U), jnp.asarray(flags),
                                  0.6, max_disp=1, block=16, interpret=True,
                                  orig=j_orig)
    got = advect_velocity(0.3, T(U), T(flags), 0.6, max_disp=1,
                          orig=t_orig)
    close(got, want, 1e-5)
    if with_orig:   # the test can tell orig from U
        self_adv = advect_velocity(0.3, T(U), T(flags), 0.6, max_disp=1)
        assert float((self_adv - got).abs().max()) > 1.0


def test_advect_all_with_orig_matches_pallas(rng):
    """Kernel A with an ``orig`` far from U, max_disp 1, line trace on,
    against advect_all_pallas (interpret)."""
    flags, U, rho, orig = _inputs(rng)
    want_rho, want_U = advect_all_pallas(
        0.3, jnp.asarray(rho), jnp.asarray(U), jnp.asarray(flags), 0.6,
        max_disp=1, block=16, interpret=True, line_trace=True,
        orig=jnp.asarray(orig))
    got_rho, got_U = advect_all(0.3, T(rho), T(U), T(flags), 0.6,
                                max_disp=1, line_trace=True, orig=T(orig))
    close(got_rho, want_rho, 1e-5)
    close(got_U, want_U, 1e-5)


def test_unfused_plume_steps_match_jax():
    """Three steps of the 64^2 plume, jacobi-28, with the density and the
    velocity advected separately (D then E in the port), against the JAX
    step. JAX runs max_disp 1 and the port 4: equal while no back-trace
    exceeds one cell (asserted), as in tests/test_torch_step.py."""
    res = 64
    cfg, state, _ = plume_case(res, device="cpu", sim_method="jacobi",
                               jacobi_iter=28, fuse_advection=False)
    assert not cfg.fuse_advection and cfg.max_disp == 4
    jcfg = j_config(dt=0.1, line_trace=True, line_trace_impl="firsthit",
                    max_disp=1, use_pallas=False, sim_method="jacobi",
                    jacobi_iter=28, fuse_advection=False)
    jstate = j_scene(res, res, density_val=0.1, u_scale=2.0 * res / 128.0,
                     rad=0.145)
    jax_step = jax.jit(lambda s: j_step(jcfg, s))
    with torch.no_grad():
        for _ in range(3):
            assert 0.1 * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step(cfg, state)
            for field in ("U", "density", "p"):
                want = np.asarray(getattr(jstate, field))
                np.testing.assert_allclose(
                    getattr(state, field).numpy(), want, rtol=0,
                    atol=1e-4 * max(np.abs(want).max(), 1e-6))
    assert float(state.density.max()) > 0.09


@pytest.mark.parametrize("knob", ["march", "compute_dtype", "gather",
                                  "mg_learned"])
def test_unported_knobs_raise(knob):
    """The knobs that raised before the port took their branches: the
    march trace of the XLA path (use_pallas off) and the gather engine
    now step as the JAX step does (two steps of the 16^2 plume against
    ``simulate_step`` at 1e-5 of each field's largest value; JAX at
    max_disp 1, which gives the same fields while no back-trace reaches a
    cell away: the inlet moves 0.025 cells a step); every 2-D net takes
    bfloat16 and another dtype raises; a sim_method the step does not
    know (mg_learned, which the JAX step would run as Jacobi) raises
    naming the projection to pass with sim_method "convnet"."""
    if knob == "compute_dtype":
        # Every 2-D net takes bfloat16 (kernel B's bfloat16 route; the
        # tower and ScaleNet since ROADMAP A.4.3); another dtype raises.
        net = PUNet.from_config(ModelConfig(model="PUNet",
                                            compute_dtype="bfloat16"))
        assert net.compute_dtype == torch.bfloat16
        for model in ("FluidNet", "ScaleNet"):
            net = make_net(ModelConfig(model=model, compute_dtype="bfloat16"))
            assert net.compute_dtype == torch.bfloat16
            with pytest.raises(ValueError, match="float16"):
                make_net(ModelConfig(model=model, compute_dtype="float16"))
        return
    cfg, state, _ = plume_case(16, device="cpu", sim_method="jacobi",
                               jacobi_iter=2)
    assert cfg.use_pallas and simulate_step(cfg, state) is not None
    if knob == "mg_learned":
        with pytest.raises(NotImplementedError,
                           match="make_project_fn_mg_learned"):
            simulate_step(dataclasses.replace(cfg, sim_method="mg_learned"),
                          state)
        return
    bad = {"march": dict(use_pallas=False),
           "gather": dict(use_pallas=False, advection_impl="gather")}[knob]
    cfg = dataclasses.replace(cfg, **bad)
    jcfg = j_config(**{f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(cfg)})
    jcfg = dataclasses.replace(jcfg, max_disp=1)
    jstate = j_scene(16, 16, density_val=0.1, u_scale=0.25, rad=0.145)
    jax_step = jax.jit(lambda s: j_step(jcfg, s))
    with torch.no_grad():
        for _ in range(2):
            jstate = jax_step(jstate)
            state = simulate_step(cfg, state)
            assert cfg.dt * float(jnp.abs(jstate.U).max()) < 1.0
            for field in ("U", "density", "p"):
                want = np.asarray(getattr(jstate, field))
                np.testing.assert_allclose(
                    getattr(state, field).numpy(), want, rtol=0,
                    atol=1e-5 * max(np.abs(want).max(), 1e-6))


def test_march_without_density_runs():
    """The march condition needs scalar advection: with the shipped
    defaults (use_pallas off, march) a scene without a density field, such
    as the cylinder's, runs."""
    cfg = plume_config(advect_density=False, jacobi_iter=2,
                       buoyancy_scale=0.0)
    assert not cfg.use_pallas and cfg.line_trace_impl == "march"
    _, state, _ = plume_case(16, device="cpu", sim_method="jacobi")
    assert torch.isfinite(simulate_step(cfg, state).U).all()


@pytest.mark.parametrize("kernel", ["advect_scalar", "advect_velocity"])
def test_split_wrappers_refuse_other_devices(kernel):
    """D's and E's wrappers run their plain versions only for CPU tensors
    and launch their kernels only for CUDA tensors; any other device
    raises."""
    meta = dict(device="meta")
    flags = torch.ones((1, 8, 8), dtype=torch.int32, **meta)
    U = torch.zeros((1, 2, 8, 8), **meta)
    with pytest.raises(ValueError, match="device"):
        if kernel == "advect_scalar":
            advect_scalar(0.1, torch.zeros((1, 8, 8), **meta), U, flags)
        else:
            advect_velocity(0.1, U, flags)
