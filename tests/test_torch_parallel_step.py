"""The width-sharded steps (``fluidnet_cxx_tpu_torch/parallel/step.py``) on
four gloo ranks on the CPU (one spawn for the module,
``tests/torch_parallel_ranks.py::step_ranks``), gathered and held to the
port's single-device step on the whole state and to the JAX package's:

* the 64^2 plume (batch 2) at dp = 2 x sx = 2, JAX's
  ``test_sharded_sim_step_matches_single`` case (Jacobi-20, the march
  trace), one step against JAX (at max_disp 1, see the test) and three against the port; two steps
  with ``use_pallas`` (kernels A and E's plain versions); one with the
  early-exit Jacobi (p_tol 1e-3);
* the viscous stick-wall cylinder at ``dryrun_multichip``'s toy shape for
  four devices (64x32, the disc at x 16, radius 4.5, Jacobi-2) at sx = 4,
  one step against JAX, and three of Jacobi-34 against the port;
* the 3-D plume at sx = 4, JAX's ``test_sharded_3d_step_matches_single``
  case (16x24x32, window engine, max_disp 2, Jacobi-10), one step against
  JAX and the port;
* the halo's reach, bit for bit against the port at sx = 4: one step from
  a rough state whose displacements are exact in any coordinates (a random
  U of std 4-20 in multiples of 1/8, dt 1/4, no line trace, a random
  density): the plume with 8% random obstacles and vorticity confinement
  at max_disp 2 (also with ``use_pallas``) and 4 (two hops: the halo is
  wider than a slab), the viscous cylinder with its stick walls, the
  Rayleigh-Taylor config made periodic in x (the first interior column
  reads the last rank's last column) and the 3-D plume with vorticity
  confinement (8-column slabs, two hops);
* what the step refused under sx > 1 before ROADMAP A.8.1 (multigrid,
  the learned projection, the gather engine) against the single-device
  step; and the multigrid step under dp = 4 alone, equal to the
  single-device step of the whole batch to the bit.

Tolerances. Against JAX 1e-5, as ``tests/test_parallel.py``. Against the
port on the scenes, 1e-5 of each field's largest value: the advection
traces in each slab's own coordinates (``parallel/step.py``), so a
position may round at another magnitude; the differences seen are below
2e-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from fluidnet_cxx_tpu.sim import create_cylinder_scene as j_cylinder
from fluidnet_cxx_tpu.sim import create_plume_scene as j_plume
from fluidnet_cxx_tpu.sim import cylinder_config as j_cylinder_config
from fluidnet_cxx_tpu.sim import plume_config as j_plume_config
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu.sim.scenes3 import create_plume_scene3 as j_plume3
from fluidnet_cxx_tpu.sim.step3d import simulate_step3 as j_step3
from fluidnet_cxx_tpu_torch.parallel.launch import spawn
from fluidnet_cxx_tpu_torch.sim.step import simulate_step
from fluidnet_cxx_tpu_torch.sim.step3d import simulate_step3

torch.set_num_threads(1)
TOL = 1e-5
CASES = ranks.step_cases()


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding; this
    module runs without them and restores the setting after."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("step")
    spawn(ranks.step_ranks, ranks.WORLD, (str(d),), timeout_s=45,
          join_s=60)
    return [dict(np.load(d / f"step_r{r}.npz")) for r in range(ranks.WORLD)]


def _port(name):
    _, steps, three_d, cfg, state = CASES[name]
    step = simulate_step3 if three_d else simulate_step
    with torch.no_grad():
        for _ in range(steps):
            state = step(cfg, state)
    return state


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_is_the_single_device_step(run, name):
    want = _port(name)
    for out in run:
        for field in ("p", "U", "density"):
            w = getattr(want, field).numpy()
            if name in ranks.EXACT:
                np.testing.assert_array_equal(out[f"{name}_{field}"], w)
            else:
                _close(out[f"{name}_{field}"], w,
                       TOL * max(float(np.abs(w).max()), 1.0))
    assert np.isfinite(want.U.numpy()).all()
    assert float(want.U.abs().max()) > 0.5


def _jax_want(name):
    """JAX's step of the case's scene, at max_disp 1 (see the test)."""
    if name == "plume":
        return j_step(j_plume_config(jacobi_iter=20, max_disp=1),
                      j_plume(64, 64, batch=2))
    if name == "cylinder":
        state, visc = j_cylinder(res_x=64, res_y=32, center_x=16.0,
                                 radius=4.5)
        return j_step(j_cylinder_config(visc, jacobi_iter=2, max_disp=1),
                      state)
    cfg = j_plume_config(dt=0.25, jacobi_iter=10, buoyancy_scale=0.5,
                         gravity_vec=(0.0, -1.0, 0.0), line_trace=False,
                         advection_impl="window", max_disp=1)
    return j_step3(cfg, j_plume3(16, 24, 32))


@pytest.mark.parametrize("name", ["plume", "cylinder", "step3d"])
def test_sharded_step_matches_jax(run, name):
    """The port runs JAX's configs (max_disp 4, 4 and 2); JAX runs them at
    max_disp 1, a cheaper compile: every displacement of these scenes'
    first step is below one cell, so both windows sample the same cells
    (asserted)."""
    _, _, _, cfg, state = CASES[name]
    assert cfg.dt * float(state.U.abs().max()) < 1.0
    want = _jax_want(name)
    start = {"plume": j_plume(64, 64, batch=2),
             "cylinder": j_cylinder(res_x=64, res_y=32, center_x=16.0,
                                    radius=4.5)[0],
             "step3d": j_plume3(16, 24, 32)}[name]
    for field in ("U", "flags", "density"):
        np.testing.assert_array_equal(np.asarray(getattr(start, field)),
                                      getattr(state, field).numpy())
    for out in run:
        for field in ("U", "density"):
            _close(out[f"{name}_{field}"], np.asarray(getattr(want, field)),
                   1e-5)
    assert float(jnp.abs(want.U).max()) > 0.5


@pytest.mark.parametrize("name", ["multigrid", "convnet", "gather"])
def test_sharded_step_refuses_what_it_does_not_run(run, name):
    """What the step refused under sx > 1 before ROADMAP A.8.1 (multigrid,
    the learned projection, the gather engine) now runs: the plume case
    at dp = 2 x sx = 2, within 1e-5 of the single-device step's largest
    value."""
    _, _, _, cfg, state = CASES["plume"]
    kw, project = ranks.former_refusals()[name]
    with torch.no_grad():
        want = simulate_step(dataclasses.replace(cfg, **kw), state, project)
    for out in run:
        for field in ("U", "p"):
            w = getattr(want, field).numpy()
            _close(out[f"former_{name}_{field}"], w,
                   TOL * max(float(np.abs(w).max()), 1.0))


def test_dp_only_multigrid_step_is_the_single_device_step(run):
    _, _, _, cfg, state = CASES["plume"]
    state = state._replace(**{k: torch.cat([v, v]) for k, v in
                              state._asdict().items() if v is not None})
    with torch.no_grad():
        want = simulate_step(dataclasses.replace(cfg,
                                                 sim_method="multigrid"),
                             state)
    for out in run:
        np.testing.assert_array_equal(out["dp_multigrid_U"], want.U.numpy())
