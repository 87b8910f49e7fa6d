"""Kernel F's plain version and the Jacobi branch of the step, port against
the JAX package on the CPU from the same numpy inputs.

On a CPU tensor ``ops/kernels/jacobi.py::solve_jacobi`` runs its plain
version (``ops/jacobi.py::solve_jacobi_fixed``); the CUDA kernel is held
to it on the card by chip_smoke.py. Here the plain version is held to the
TPU kernel ``solve_jacobi_pallas`` in interpret mode (as
tests/test_pallas.py runs it), the early-exit ``solve_jacobi`` to JAX's,
and three steps of the 32^2 plume under jacobi-28 to JAX's
``simulate_step``.

Tolerances: the sweeps are the same float32 operations in the same order
as the XLA solver (1e-6 absolute here); the interpreted Pallas kernel may
fuse differently (1e-5, as tests/test_pallas.py holds it to XLA); the
step is held to 1e-4 of each field's largest magnitude, as
tests/test_torch_step.py holds the convnet step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu import ops as j_ops
from fluidnet_cxx_tpu.ops import jacobi as j_jac
from fluidnet_cxx_tpu.sim import create_plume_scene as j_scene
from fluidnet_cxx_tpu.sim import plume_config as j_config
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu_torch.ops import jacobi as t_jac
from fluidnet_cxx_tpu_torch.ops.kernels import jacobi as k_jac
from fluidnet_cxx_tpu_torch.run_plume import plume_case
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


@pytest.fixture
def system(rng):
    """Flags with 10% obstacles, a divergence RHS and a warm start."""
    flags = random_flags(rng, 2, 16, 24, p_obstacle=0.1)
    U = rng.standard_normal((2, 2, 16, 24)).astype(np.float32)
    div = np.asarray(j_ops.velocity_divergence(U, flags))
    p0 = rng.standard_normal((2, 16, 24)).astype(np.float32)
    return flags, div, p0


@pytest.mark.parametrize("iters,damping,warm", [(30, 1.0, False),
                                                (13, 2.0 / 3.0, True)])
def test_plain_matches_pallas_kernel(system, monkeypatch, iters, damping,
                                     warm):
    """F's plain version == solve_jacobi_pallas (interpret mode), cold and
    warm-started with the 2/3 damping of the polish."""
    from jax.experimental import pallas as pl

    from fluidnet_cxx_tpu.ops.pallas import jacobi_pallas as jp

    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    flags, div, p0 = system
    p0 = p0 if warm else None
    want = np.asarray(jp.solve_jacobi_pallas(flags, div, iters, p0=p0,
                                             damping=damping))
    got = k_jac.solve_jacobi(T(flags), T(div), iters,
                             p0=None if p0 is None else T(p0),
                             damping=damping)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_fixed_with_residual_matches_jax(system):
    flags, div, p0 = system
    want_p, want_r = j_jac.solve_jacobi_fixed(flags, div, 7,
                                              with_residual=True, p0=p0)
    got_p, got_r = t_jac.solve_jacobi_fixed(T(flags), T(div), 7,
                                            with_residual=True, p0=T(p0))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(float(got_r), float(want_r), rtol=1e-5)


@pytest.mark.parametrize("p_tol,max_iter", [(0.45, 500), (1e-9, 12)])
def test_early_exit_solve_matches_jax(system, p_tol, max_iter):
    """The p_tol solver stops after the same sweep as JAX's while_loop:
    on the tolerance, and on max_iter."""
    flags, div, _ = system
    want_p, want_r = j_jac.solve_jacobi(flags, div, p_tol, max_iter)
    got_p, got_r = t_jac.solve_jacobi(T(flags), T(div), p_tol, max_iter)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(float(got_r), float(want_r), rtol=1e-5)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def test_plume_jacobi_steps_match_jax():
    """Three steps of the 32^2 plume under jacobi-28. The port runs the
    slice's max_disp 4, JAX max_disp 1 (a tenth of the compile time here),
    equal while no back-trace exceeds one cell (asserted)."""
    res = 32
    cfg, state, _ = plume_case(res, device="cpu", sim_method="jacobi",
                               jacobi_iter=28)
    assert cfg.max_disp == 4 and cfg.p_tol == 0
    jcfg = j_config(dt=0.1, line_trace=True, line_trace_impl="firsthit",
                    max_disp=1, use_pallas=False, sim_method="jacobi",
                    jacobi_iter=28)
    jstate = j_scene(res, res, density_val=0.1, u_scale=2.0 * res / 128.0,
                     rad=0.145)
    jax_step = jax.jit(lambda s: j_step(jcfg, s))
    with torch.no_grad():
        for _ in range(3):
            assert 0.1 * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step(cfg, state)
            _close(state.U, jstate.U)
            _close(state.density, jstate.density)
            _close(state.p, jstate.p)
    assert torch.isfinite(state.U).all()
