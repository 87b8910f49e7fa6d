"""The cylinder slice against the JAX package, on the CPU: the source
terms and stencils it adds (viscosity, scalar correction, vorticity
confinement, curl, stick walls, the CFL guard's displacement), the
cylinder scene, five steps of the 64x256 cylinder under Jacobi-34 and
three each under multigrid and the trained PUNetD2_128, and the run loop
and entry point.

Tolerances: the ops are the same float32 operations in the same order as
the JAX code and are held to 1e-6 of the largest output (a few ulp); the
scene exactly; the steps to 1e-4 of each field's largest value, for the
Jacobi sums of 34 sweeps.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.celltype import OBSTACLE, STICK
from fluidnet_cxx_tpu.ops import grid as j_grid
from fluidnet_cxx_tpu.ops import source_terms as j_src
from fluidnet_cxx_tpu.ops import stencils as j_st
from fluidnet_cxx_tpu.ops import window as j_win
from fluidnet_cxx_tpu.sim import scenes as j_scenes
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu_torch import run_cylinder as rc
from fluidnet_cxx_tpu_torch.ops import grid as t_grid
from fluidnet_cxx_tpu_torch.ops import source_terms as t_src
from fluidnet_cxx_tpu_torch.ops import stencils as t_st
from fluidnet_cxx_tpu_torch.ops import window as t_win
from fluidnet_cxx_tpu_torch.run_plume import build_net, plume_case
from fluidnet_cxx_tpu_torch.sim import scenes as t_scenes
from fluidnet_cxx_tpu_torch.sim.driver import run_simulation
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
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * max(1.0, np.abs(want).max()),
                               rtol=0)


def _fields(rng, b=2, h=20, w=24):
    """Flags with obstacles and empty cells; stick flags marking about
    half of the obstacles, some of them in 2x2 clusters (the corner rule)
    and some against the grid border; U, a density and a divergence."""
    flags = random_flags(rng, b, h, w, p_obstacle=0.15, p_empty=0.05)
    flags[:, 5:7, 5:7] = OBSTACLE
    stick = np.where((flags == OBSTACLE) & (rng.random(flags.shape) < 0.5),
                     STICK, flags).astype(np.int32)
    stick[:, 5:7, 5:7] = STICK
    stick[:, 0, 3:6] = STICK
    U = rng.standard_normal((b, 2, h, w)).astype(np.float32)
    rho = rng.random((b, h, w)).astype(np.float32)
    div = rng.standard_normal((b, h, w)).astype(np.float32)
    return flags, stick, U, rho, div


OPS = {
    "add_viscosity": (
        lambda f, s, U, r, d: j_src.add_viscosity(0.1, U, f, 1.61),
        lambda f, s, U, r, d: t_src.add_viscosity(0.1, U, f, 1.61)),
    "correct_scalar": (
        lambda f, s, U, r, d: j_src.correct_scalar(0.1, r, d, f),
        lambda f, s, U, r, d: t_src.correct_scalar(0.1, r, d, f)),
    "add_vorticity_confinement": (
        lambda f, s, U, r, d: j_src.add_vorticity_confinement(U, f, 0.3, 0.1),
        lambda f, s, U, r, d: t_src.add_vorticity_confinement(U, f, 0.3,
                                                              0.1)),
    "curl2d": (lambda f, s, U, r, d: j_grid.curl2d(U),
               lambda f, s, U, r, d: t_grid.curl2d(U)),
    "set_wall_bcs_stick": (
        lambda f, s, U, r, d: j_st.set_wall_bcs_stick(U, f, s),
        lambda f, s, U, r, d: t_st.set_wall_bcs_stick(U, f, s)),
    "max_displacement": (
        lambda f, s, U, r, d: j_win.max_displacement(U, 0.1),
        lambda f, s, U, r, d: t_win.max_displacement(U, 0.1)),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax(rng, op):
    fields = _fields(rng)
    j_fn, t_fn = OPS[op]
    want = j_fn(*(jnp.asarray(a) for a in fields))
    got = t_fn(*(T(a) for a in fields))
    assert tuple(got.shape) == tuple(want.shape)
    close(got.numpy(), want, 1e-6)


def test_stick_walls_act(rng):
    """The stick rules (steps 3-4) change U in stick cells only: with no
    stick cell marked, the result differs elsewhere from nothing."""
    flags, stick, U, _, _ = _fields(rng)
    got = t_st.set_wall_bcs_stick(T(U), T(flags), T(stick))
    no_stick = t_st.set_wall_bcs_stick(T(U), T(flags), T(flags))
    differ = (got != no_stick).any(dim=1)
    assert differ.any()
    assert (T(stick)[differ] == STICK).all()


@pytest.mark.parametrize("size", [(256, 64, 40.0, 8.0), (800, 80, 50.0, 8.05)])
def test_cylinder_scene_matches_jax(size):
    """create_cylinder_scene field by field and in viscosity, at the
    small check's size and at a tenth of the reference's channel."""
    res_x, res_y, cx, r = size
    jstate, jnu = j_scenes.create_cylinder_scene(res_x, res_y, center_x=cx,
                                                 radius=r)
    tstate, tnu = t_scenes.create_cylinder_scene(res_x, res_y, center_x=cx,
                                                 radius=r)
    assert tnu == jnu
    for field in jstate._fields:
        want, got = getattr(jstate, field), getattr(tstate, field)
        assert (want is None) == (got is None), field
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=field)
    assert int((tstate.flags_stick == STICK).sum()) > 150


def test_cylinder_config_matches_jax():
    j = j_scenes.cylinder_config(1.61)
    t = t_scenes.cylinder_config(1.61)
    for name in ("dt", "maccormack_strength", "buoyancy_scale",
                 "gravity_scale", "viscosity", "p_tol", "jacobi_iter",
                 "advect_density", "sim_method", "max_disp"):
        assert getattr(t, name) == getattr(j, name), name


def test_add_box2d_and_cylinder_match_jax():
    flags = np.asarray(j_scenes.create_cylinder_scene(64, 32)[0].flags)
    want = j_scenes.add_box2d(j_scenes.add_cylinder(flags, 20.0, 10.0, 4.5),
                              40, 50, 3, 12)
    got = t_scenes.add_box2d(t_scenes.add_cylinder(T(flags), 20.0, 10.0, 4.5),
                             40, 50, 3, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cylinder_steps_match_jax():
    """Five steps of the 64x256 cylinder (radius 8 at x 40, Re 100),
    jacobi-34: viscosity, E with the viscous field, free-slip and stick
    walls, F. The port runs max_disp 4 and JAX 1: equal while no
    back-trace exceeds one cell (asserted)."""
    cfg, state, _ = rc.cylinder_case(256, 64, "cpu", radius=8.0,
                                     center_x=40.0)
    assert cfg.viscosity == pytest.approx(0.16) and cfg.max_disp == 4
    jstate, jnu = j_scenes.create_cylinder_scene(256, 64, center_x=40.0,
                                                 radius=8.0)
    jcfg = j_scenes.cylinder_config(jnu, max_disp=1)
    jax_step = jax.jit(lambda s: j_step(jcfg, s))
    with torch.no_grad():
        for _ in range(5):
            assert 0.1 * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step(cfg, state)
            for field in ("U", "p"):
                want = np.asarray(getattr(jstate, field))
                np.testing.assert_allclose(
                    getattr(state, field).numpy(), want, rtol=0,
                    atol=1e-4 * max(np.abs(want).max(), 1e-6))
    # The disc is no-slip: the tangential velocity flips sign across it.
    assert float(state.U.abs().max()) > 1.0


def test_run_cylinder_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rc.run_cylinder(256, 64, 1, radius=8.0, center_x=40.0)
    out = rc.run_cylinder(64, 32, 2, device="cpu", radius=4.0,
                          center_x=16.0)
    assert out["finite"] and 0.0 < out["max_disp"] < 1.0
    assert out["max_U"] >= 1.0 and out["max_div"] < 1.0


def _flax_punet(state_dict):
    """The port's PUNet state_dict as flax FluidNet params."""
    out = {}
    for key, t in state_dict.items():
        _, name, kind = key.split(".")
        out.setdefault(name, {})["kernel" if kind == "weight" else "bias"] = (
            t.permute(2, 3, 1, 0).numpy() if kind == "weight" else t.numpy())
    return {"params": {"PUNet_0": out}}


@pytest.mark.parametrize("method", ["multigrid", "convnet"])
def test_cylinder_other_projections_match_jax(method):
    """Three steps of the 64x256 cylinder (radius 8 at x 40) under
    multigrid (kernel H's plain version; JAX's XLA solve_mg) and under the
    trained PUNetD2_128 (JAX scripts/run_cylinder.py's flax
    make_project_fn; the stick walls send both steps through the unfused
    branch), max_disp 1 on the JAX side as above, to 1e-4 of each field's
    largest value."""
    from fluidnet_cxx_tpu.models import FluidNet, make_project_fn
    from fluidnet_cxx_tpu.train.checkpoint import load_model_config

    cfg, state, project = rc.cylinder_case(256, 64, "cpu", radius=8.0,
                                           center_x=40.0, sim_method=method)
    assert cfg.sim_method == method and (project is None) == (
        method == "multigrid")
    jstate, jnu = j_scenes.create_cylinder_scene(256, 64, center_x=40.0,
                                                 radius=8.0)
    jcfg = j_scenes.cylinder_config(jnu, max_disp=1, sim_method=method)
    j_project = None
    if method == "convnet":
        model = FluidNet(load_model_config(str(rc.MODEL_DIR)))
        net = build_net(model.cfg)
        j_project = make_project_fn(model, _flax_punet(net.state_dict()))
    jax_step = jax.jit(lambda s: j_step(jcfg, s, project_fn=j_project))
    with torch.no_grad():
        for _ in range(3):
            assert 0.1 * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step(cfg, state, project)
            for field in ("U", "p"):
                want = np.asarray(getattr(jstate, field))
                np.testing.assert_allclose(
                    getattr(state, field).numpy(), want, rtol=0,
                    atol=1e-4 * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("method", ["multigrid", "convnet"])
def test_cylinder_other_projections_raise(method):
    """Of the projections other than Jacobi, the cylinder builds multigrid
    and convnet, and raises for one it does not run (mg_learned)."""
    cfg, _, project = rc.cylinder_case(64, 32, "cpu", radius=4.0,
                                       center_x=16.0, sim_method=method)
    assert cfg.sim_method == method
    assert (project is None) == (method == "multigrid")
    with pytest.raises(ValueError, match="the cylinder runs"):
        rc.cylinder_case(64, 32, "cpu", sim_method="mg_learned")


def test_run_simulation_stats_and_cfl_guard():
    """on_stats runs every stat_iter steps and at the end; the CFL guard
    warns once when the displacement exceeds max_disp."""
    cfg, state, _ = plume_case(16, device="cpu", sim_method="jacobi",
                               jacobi_iter=2)
    seen = []
    fast = state._replace(U=state.U + 30.0)     # 3 cells a step at dt 0.1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_simulation(dataclasses.replace(cfg, max_disp=1), fast, 5,
                       stat_iter=2, verbose=False,
                       on_stats=lambda st, it: seen.append(it))
    assert seen == [2, 4, 5]
    assert sum("CFL violation" in str(w.message) for w in caught) == 1
