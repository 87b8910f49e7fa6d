"""The plain versions of kernels G and H and the multigrid branches of the
step, port against the JAX package on the CPU from the same numpy inputs.

On a CPU tensor ``ops/kernels/mg.py::solve_mg`` (G) and ``project_mg``
(H) run their plain versions (``ops/multigrid.py::solve_mg`` and the chain
velocity_divergence -> solve_mg -> velocity_update -> set_wall_bcs); the
CUDA kernels are held to them on the card by chip_smoke.py. Here the plain
versions are held to the JAX package's XLA solver and chain, which
tests/test_pallas.py holds equal to the TPU kernels ``solve_mg_pallas`` and
``project_mg_pallas``; each JAX reference runs under one ``jax.jit``.

Tolerances: 5e-5 absolute for the solver and the chain, as
tests/test_pallas.py holds the TPU kernel to the same XLA functions (the
sums of the compatibility projection and the gauge run in another order);
the learned projection with the multigrid polish and the steps to 1e-4 of
each field's largest magnitude, as tests/test_torch_step.py holds the
convnet step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu import ops as j_ops
from fluidnet_cxx_tpu.config import ModelConfig as JModelConfig
from fluidnet_cxx_tpu.models import FluidNet
from fluidnet_cxx_tpu.models import (
    make_project_fn_fused_forward as j_fused_forward)
from fluidnet_cxx_tpu.ops import multigrid as j_mg
from fluidnet_cxx_tpu.sim import create_plume_scene as j_plume
from fluidnet_cxx_tpu.sim import create_rayleigh_taylor_scene as j_rt
from fluidnet_cxx_tpu.sim import plume_config as j_plume_config
from fluidnet_cxx_tpu.sim import rayleigh_taylor_config as j_rt_config
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu_torch.config import ModelConfig
from fluidnet_cxx_tpu_torch.models.convert import random_flax_params
from fluidnet_cxx_tpu_torch.models.fluidnet import (
    make_project_fn_fused_forward, scale_std)
from fluidnet_cxx_tpu_torch.ops import multigrid as t_mg
from fluidnet_cxx_tpu_torch.ops.kernels import mg as k_mg
from fluidnet_cxx_tpu_torch.ops.stencils import (flags_to_occupancy,
                                                 velocity_divergence)
from fluidnet_cxx_tpu_torch.run_plume import build_net, plume_case
from fluidnet_cxx_tpu_torch.run_rayleigh_taylor import rt_case
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


def _close(got, want, atol=None, rel=1e-4):
    want = np.asarray(want)
    if atol is None:
        atol = rel * max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.fixture
def system(rng):
    """32^2 flags with 8% obstacles, velocities and a warm start that is 0
    off fluid cells, as tests/test_pallas.py builds them."""
    flags = random_flags(rng, 2, 32, 32, p_obstacle=0.08)
    U = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    p0 = rng.standard_normal((2, 32, 32)).astype(np.float32)
    p0[flags != 1] = 0.0
    return flags, U, p0


@pytest.mark.parametrize("h,w", [(32, 32), (64, 32), (40, 24), (20, 20)])
def test_levels_match_jax(rng, h, w):
    """Level shapes and coarse flags (the 'all children' rule and the
    forced border ring), with interior obstacles and empty cells."""
    flags = random_flags(rng, 2, h, w, p_obstacle=0.3, p_empty=0.1)
    want = j_mg._levels(flags, 8)
    got = t_mg._levels(T(flags), 8)
    assert [tuple(f.shape) for f in got] == [tuple(f.shape) for f in want]
    for g, f in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(f))


def test_plain_solve_mg_matches_jax(system):
    """G's plain version == ops.multigrid.solve_mg: 2 V-cycles cold and 1
    warm (the closed-loop path)."""
    flags, U, p0 = system
    div = np.asarray(j_ops.velocity_divergence(U, flags))

    @jax.jit
    def ref(flags, div, p0):
        return (j_mg.solve_mg(flags, div, n_vcycles=2),
                j_mg.solve_mg(flags, div, n_vcycles=1, p0=p0))

    cold, warm = ref(flags, div, p0)
    _close(k_mg.solve_mg(T(flags), T(div), n_vcycles=2), cold, atol=5e-5)
    _close(k_mg.solve_mg(T(flags), T(div), n_vcycles=1, p0=T(p0)), warm,
           atol=5e-5)


def test_plain_project_mg_matches_jax_chain(system):
    """H's plain version == the chain tests/test_pallas.py holds
    project_mg_pallas to: div -> warm V-cycle -> velocity_update ->
    set_wall_bcs."""
    flags, U, p0 = system

    @jax.jit
    def ref(flags, U, p0):
        p = j_mg.solve_mg(flags, j_ops.velocity_divergence(U, flags),
                          n_vcycles=1, p0=p0)
        return p, j_ops.set_wall_bcs(j_ops.velocity_update(p, U, flags),
                                     flags)

    p_want, U_want = ref(flags, U, p0)
    p_got, U_got = k_mg.project_mg(T(flags), T(U), p0=T(p0), n_vcycles=1)
    _close(p_got, p_want, atol=5e-5)
    _close(U_got, U_want, atol=5e-5)


def test_mg_polish_is_punet_then_project_mg(rng):
    """polish_impl='mg': the PUNet's pressure, rescaled by the input std,
    warm-starts one V-cycle of H on the inlet-corrected U, and the inlet
    BCs are applied to its output."""
    mcfg = ModelConfig(model="PUNet", punet_patch=4, punet_widths=(8, 8),
                       punet_bottleneck_convs=1, polish_impl="mg")
    net = build_net(mcfg, 0)
    project = make_project_fn_fused_forward(mcfg, net)
    h = w = 32
    flags = T(random_flags(rng, 1, h, w, p_obstacle=0.05))
    U = T(rng.standard_normal((1, 2, h, w)).astype(np.float32))
    p = T(rng.standard_normal((1, h, w)).astype(np.float32))
    U_bc = T(rng.standard_normal((1, 2, h, w)).astype(np.float32))
    inv = T((rng.random((1, 2, h, w)) < 0.9).astype(np.float32))

    got_p, got_U = project(p, U, flags, None, U_bc=U_bc, U_bc_inv_mask=inv)
    with torch.no_grad():
        U_in = U * inv + U_bc
        s = scale_std(U_in, mcfg.normalize_input_threshold)
        x = torch.stack([velocity_divergence(U_in, flags) / s,
                         flags_to_occupancy(flags)], dim=-1)
        p_hat = net(x)[..., 0]
        want_p, want_U = k_mg.project_mg_plain(
            flags, U_in, p0=p_hat * s[:, None, None], n_vcycles=1)
    _close(got_p, want_p.numpy())
    _close(got_U, (want_U * inv + U_bc).numpy())


def test_mg_polish_matches_jax_fused_forward(rng, monkeypatch):
    """polish_impl='mg' == the JAX package's
    make_project_fn_fused_forward(polish_impl='mg') on the same weights,
    with the inlet BCs: its PUNet forward and project_mg_pallas run in
    interpret mode under one jax.jit, as tests/test_pallas.py runs them."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    widths = dict(model="PUNet", punet_patch=4, punet_widths=(8, 8),
                  punet_bottleneck_convs=1, polish_impl="mg")
    mcfg = ModelConfig(**widths)
    net = build_net(mcfg, 0)
    params = {"params": {"PUNet_0": random_flax_params(net.table, 0)}}
    h = w = 32
    j_project = j_fused_forward(
        FluidNet(JModelConfig(**widths)), params, h, w,
        compute_dtype=jnp.float32)
    flags = random_flags(rng, 1, h, w, p_obstacle=0.05)
    U = rng.standard_normal((1, 2, h, w)).astype(np.float32)
    p = rng.standard_normal((1, h, w)).astype(np.float32)
    U_bc = rng.standard_normal((1, 2, h, w)).astype(np.float32)
    inv = (rng.random((1, 2, h, w)) < 0.9).astype(np.float32)

    ref = jax.jit(lambda p, U, flags, U_bc, inv: j_project(
        p, U, flags, None, U_bc=U_bc, U_bc_inv_mask=inv))
    want_p, want_U = ref(p, U, flags, U_bc, inv)
    got_p, got_U = make_project_fn_fused_forward(mcfg, net)(
        T(p), T(U), T(flags), None, U_bc=T(U_bc), U_bc_inv_mask=T(inv))
    _close(got_p, want_p)
    _close(got_U, want_U)


def _run_steps(cfg, state, jcfg, jstate, steps):
    jax_step = jax.jit(lambda s: j_step(jcfg, s))
    with torch.no_grad():
        for _ in range(steps):
            assert jcfg.dt * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step(cfg, state)
            _close(state.U, jstate.U)
            _close(state.density, jstate.density)
            _close(state.p, jstate.p)
    assert torch.isfinite(state.U).all()
    return state


def test_rayleigh_taylor_multigrid_steps_match_jax():
    """Two steps of the 64-high, 32-wide Rayleigh-Taylor scene under
    multigrid: the periodic-y branch (G, then the velocity update and the
    periodic wall overrides). JAX runs max_disp 1 and the port the
    config's 4, equal while no back-trace exceeds one cell (asserted)."""
    cfg, state = rt_case(32, 64, device="cpu", sim_method="multigrid")
    assert cfg.periodic_y and cfg.max_disp == 4 and cfg.mg_vcycles == 2
    jcfg = j_rt_config(sim_method="multigrid", max_disp=1,
                       line_trace_impl="firsthit", use_pallas=False)
    state = _run_steps(cfg, state, jcfg, j_rt(32, 64), 2)
    assert float(state.U.abs().max()) > 0     # buoyancy set the box moving


def test_plume_multigrid_steps_match_jax():
    """Two steps of the 32^2 plume under mg-2v: the non-periodic branch
    (H), warm-started from the previous step's pressure."""
    res = 32
    cfg, state, _ = plume_case(res, device="cpu", sim_method="multigrid",
                               mg_vcycles=2)
    jcfg = j_plume_config(dt=0.1, line_trace=True,
                          line_trace_impl="firsthit", max_disp=1,
                          use_pallas=False, sim_method="multigrid",
                          mg_vcycles=2)
    jstate = j_plume(res, res, density_val=0.1, u_scale=2.0 * res / 128.0,
                     rad=0.145)
    _run_steps(cfg, state, jcfg, jstate, 2)
