"""The 3-D cylinder and the ops it brings, port against the JAX package on
the CPU from the same numpy inputs: ``create_cylinder_scene3``; the torch
ops ``set_wall_bcs_stick3``, ``add_viscosity3``, ``curl3`` and
``add_vorticity_confinement3``; kernel M's plain version with a viscous
``orig`` (``ops3d.advect_velocity3``) against JAX's XLA window engine; 8
steps of the JAX package's cylinder test scene
(``tests/test_ops3d.py::test_cylinder3_scene_runs``: 8x24x48, radius 4.5 at
x 12, dt 0.3, no density) under Jacobi and multigrid; and the entry point
``run_cylinder3d``.

The JAX steps run at max_disp 1 (the port's run at 2), which builds in a
fraction of the time and gives the same fields while no back-trace
exceeds one cell (asserted), as in tests/test_torch_step3d.py.

Tolerances: the scene exactly; the ops at 1e-6 of each output's largest
magnitude; the advection at 1e-6 (the same float32 operations; the
window's trilinear sums may round apart by an ulp); the steps at 1e-4 of
each field's largest value (the Jacobi sums add in kernel I's order, the
XLA solver in another).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.ops import ops3d as j_ops3d
from fluidnet_cxx_tpu.sim import plume_config as j_config
from fluidnet_cxx_tpu.sim.scenes3 import create_cylinder_scene3 as j_cyl3
from fluidnet_cxx_tpu.sim.step3d import simulate_step3 as j_step3
from fluidnet_cxx_tpu_torch.ops import ops3d
from fluidnet_cxx_tpu_torch.ops.kernels import advect3
from fluidnet_cxx_tpu_torch.run_cylinder3d import (cylinder3d_case,
                                                   run_cylinder3d)
from fluidnet_cxx_tpu_torch.sim.scenes3 import create_cylinder_scene3
from fluidnet_cxx_tpu_torch.sim.step3d import SimState3, simulate_step3
from test_torch_ops3d import random_flags3

torch.set_num_threads(1)

SCENE = dict(d=8, h=24, w=48, center_x=12.0, radius=4.5)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs without
    them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("kw", [{}, SCENE])
def test_scene_matches_jax_exactly(kw):
    """Every field of the state and the viscosity, at JAX's defaults
    (32x128x384, radius 12.5, Re 100) and at the test scene's size."""
    jstate, jvisc = j_cyl3(**kw)
    state, visc = create_cylinder_scene3(**kw)
    assert visc == jvisc
    for field in SimState3._fields:
        a, b = getattr(jstate, field), getattr(state, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert str(b.dtype) == f"torch.{np.asarray(a).dtype}", field
            assert np.array_equal(np.asarray(a), b.numpy()), field


def _fields(seed, shape=(2, 8, 12, 16)):
    """Flags with 10% obstacles and 5% empty cells, STICK flags on a third
    of the obstacles, U."""
    rng = np.random.default_rng(seed)
    flags = random_flags3(rng, shape, p_obstacle=0.10, p_empty=0.05)
    stick = flags.copy()
    stick[(flags == 2) & (rng.random(shape) < 0.33)] = 16
    U = rng.standard_normal((shape[0], 3) + shape[1:]).astype(np.float32)
    return flags, stick, U


def test_ops_match_jax():
    """set_wall_bcs_stick3 (on random STICK cells and on the cylinder's
    extruded disc), add_viscosity3, curl3 and add_vorticity_confinement3."""
    flags, stick, U = _fields(11)
    t = [torch.from_numpy(a) for a in (flags, stick, U)]
    _close(ops3d.set_wall_bcs_stick3(t[2], t[0], t[1]),
           jax.jit(j_ops3d.set_wall_bcs_stick3)(U, flags, stick), 1e-6)
    jstate, _ = j_cyl3(**SCENE)
    cU = np.random.default_rng(12).standard_normal(
        np.shape(jstate.U)).astype(np.float32)
    _close(ops3d.set_wall_bcs_stick3(torch.from_numpy(cU),
                                     torch.from_numpy(np.array(jstate.flags)),
                                     torch.from_numpy(np.array(
                                         jstate.flags_stick))),
           jax.jit(j_ops3d.set_wall_bcs_stick3)(cU, jstate.flags,
                                                jstate.flags_stick), 1e-6)
    _close(ops3d.add_viscosity3(0.3, t[2], t[0], 0.09),
           jax.jit(lambda u, f: j_ops3d.add_viscosity3(0.3, u, f, 0.09))(
               U, flags), 1e-6)
    _close(ops3d.curl3(t[2]), jax.jit(j_ops3d.curl3)(U), 1e-6)
    _close(ops3d.add_vorticity_confinement3(t[2], t[0], 0.1, 0.3),
           jax.jit(lambda u, f: j_ops3d.add_vorticity_confinement3(
               u, f, 0.1, 0.3))(U, flags), 1e-6)


def test_advect_velocity3_with_orig_matches_jax():
    """M's plain version advecting a viscous field orig (not U) along U's
    MAC vectors, against JAX's window engine at max_disp 1 (back-traces
    under a cell), on random obstacles and empties; orig's values reach
    the output through the samples, the correction and the clamp; the
    wrapper runs the same plain version on CPU tensors."""
    flags, _, U = _fields(13)
    U = 0.5 * U
    orig = np.asarray(jax.jit(lambda u, f: j_ops3d.add_viscosity3(
        0.3, u, f, 0.25))(U, flags))
    want = jax.jit(lambda u, f, o: j_ops3d.advect_velocity3(
        0.3, u, f, 0.6, impl="window", max_disp=1, orig=o))(U, flags, orig)
    t = [torch.from_numpy(np.array(a)) for a in (U, flags, orig)]
    got = ops3d.advect_velocity3(0.3, t[0], t[1], 0.6, max_disp=1,
                                 orig=t[2])
    _close(got, want, 1e-6)
    assert torch.equal(advect3.advect_velocity3(0.3, t[0], t[1], 0.6, 1,
                                                orig=t[2]), got)
    assert not torch.equal(got, ops3d.advect_velocity3(0.3, t[0], t[1], 0.6,
                                                       max_disp=1))


@pytest.mark.parametrize("method", ["jacobi", "multigrid"])
def test_cylinder_steps_match_jax(method):
    """8 steps of JAX's cylinder test scene: viscosity (kernel M with
    orig), stick walls, Jacobi-20 (kernel I) or the 3-D multigrid."""
    cfg, state = cylinder3d_case(device="cpu", sim_method=method,
                                 jacobi_iter=20, **SCENE)
    jstate, visc = j_cyl3(**SCENE)
    assert cfg.viscosity == visc and cfg.max_disp == 2
    jcfg = j_config(dt=0.3, jacobi_iter=20, viscosity=visc,
                    buoyancy_scale=0.0, advect_density=False, max_disp=1,
                    line_trace=False, sim_method=method)
    jax_step = jax.jit(lambda s: j_step3(jcfg, s))
    with torch.no_grad():
        for _ in range(8):
            assert cfg.dt * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step3(cfg, state)
            for field in ("U", "p"):
                _close(getattr(state, field), getattr(jstate, field), 1e-4)
    # No-slip: tangential velocity at faces next to the disc stays small.
    U, fl = state.U[0].numpy(), state.flags[0].numpy()
    west_ob = np.zeros(fl.shape, bool)
    west_ob[:, :, 1:] = fl[:, :, :-1] == 2
    assert np.abs(U[1][(fl == 1) & west_ob]).max() < 0.6


def test_run_cylinder3d_on_cpu():
    """The entry point on the CPU: finite fields, the quality stats, no
    kernel launched (the plain versions ran)."""
    out = run_cylinder3d(steps=2, device="cpu", sim_method="multigrid",
                         vorticity_confinement=0.1, d=16, h=32, w=64,
                         radius=4.5, center_x=12.0)
    st = out["state"]
    assert st.U.shape == (1, 3, 16, 32, 64) and st.flags_stick is not None
    assert all(bool(torch.isfinite(t).all()) for t in (st.U, st.p))
    assert out["launches_per_step"] == {}
    assert out["max_div"] >= out["mean_div"] >= 0.0
