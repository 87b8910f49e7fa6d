"""The slice as a whole: five steps of the 24^3 buoyant plume under
Jacobi-60, port against the JAX package's ``simulate_step3`` on the CPU,
merged advection with the first-hit trace and separate advection without
it; the entry point ``run_plume3d``; the branches the port took in its
last 3-D slice (the flax-path projection, multigrid, viscosity, stick
walls, vorticity confinement, output_div), each against the JAX step; and
the branches the port does not implement, which raise.

The port runs ``run_plume3d.plume3d_case`` (bench3d's configuration,
max_disp 2). JAX runs the same configuration on its XLA path
(``use_pallas=False``, ``line_trace_impl="firsthit"``) at max_disp 1,
which builds in a fraction of the time and gives the same fields while no
back-trace exceeds one cell (asserted): the window clamp does not bind and
no ray reaches a cell two away.

Tolerance: 1e-4 of each field's largest magnitude, for the Jacobi sums
(the port adds in the TPU kernel's order, the XLA solver in another).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.sim import plume_config as j_config
from fluidnet_cxx_tpu.sim.scenes3 import create_plume_scene3 as j_scene3
from fluidnet_cxx_tpu.sim.step3d import simulate_step3 as j_step3
from fluidnet_cxx_tpu_torch.config import ModelConfig
from fluidnet_cxx_tpu_torch.models.punet3d import make_project_fn3
from fluidnet_cxx_tpu_torch.run_plume3d import plume3d_case, run_plume3d
from fluidnet_cxx_tpu_torch.sim.step3d import SimState3, simulate_step3

torch.set_num_threads(1)

RES, STEPS = 24, 5


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs without
    them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def to_port_state3(jstate, device="cpu"):
    """The port's SimState3 holding the JAX SimState3's arrays."""
    return SimState3(*(None if a is None
                       else torch.from_numpy(np.array(a)).to(device)
                       for a in jstate))


@pytest.mark.parametrize("fused", [True, False])
def test_plume3d_steps_match_jax(fused):
    """Merged advection (L) with the trace, or K then M without it, then
    Jacobi-60 (I), five steps against the JAX step."""
    cfg, state = plume3d_case(RES, device="cpu", fuse_advection=fused,
                              line_trace=fused)
    assert cfg.max_disp == 2 and cfg.jacobi_iter == 60
    jcfg = j_config(dt=0.25, jacobi_iter=60, buoyancy_scale=0.5,
                    gravity_vec=(0.0, -1.0, 0.0), line_trace=fused,
                    line_trace_impl="firsthit", max_disp=1,
                    advection_impl="window", use_pallas=False,
                    fuse_advection=fused)
    jstate = j_scene3(RES, RES, RES, density_val=0.1,
                      u_scale=0.6 * RES / 64.0)
    start = to_port_state3(jstate)
    for field in SimState3._fields:
        a, b = getattr(start, field), getattr(state, field)
        assert (a is None and b is None) or torch.equal(a, b), field
    jax_step = jax.jit(lambda s: j_step3(jcfg, s))
    with torch.no_grad():
        for _ in range(STEPS):
            assert cfg.dt * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step3(cfg, state)
            for field in ("U", "density", "p"):
                want = np.asarray(getattr(jstate, field))
                np.testing.assert_allclose(
                    getattr(state, field).numpy(), want, rtol=0,
                    atol=1e-4 * max(np.abs(want).max(), 1e-6))
    assert float(state.density.max()) > 0.09   # the inlet keeps injecting


def test_run_plume3d_on_cpu():
    """The entry point on the CPU: finite fields, the quality stats, no
    kernel launched (the plain versions ran)."""
    out = run_plume3d(8, 3, device="cpu", jacobi_iter=4)
    st = out["state"]
    assert st.U.shape == (1, 3, 8, 8, 8)
    assert all(bool(torch.isfinite(t).all()) for t in st[:4])
    assert out["launches_per_step"] == {}
    assert out["max_div"] >= out["mean_div"] >= 0.0
    assert out["density_sum"] > 0 and out["ms_per_step"] > 0


@pytest.mark.parametrize("branch", ["gather", "euler", "march"])
def test_unported_branches_raise(branch):
    """The branches of the JAX step that the port does not implement (the
    gather and Euler advection and the march trace of the XLA path) raise
    NotImplementedError naming ROADMAP A.6; the march trace also where the
    JAX step leaves its Pallas path for viscosity."""
    cfg, state = plume3d_case(6, device="cpu", jacobi_iter=2)
    assert simulate_step3(cfg, state) is not None
    bad = {"gather": [dict(advection_impl="gather")],
           "euler": [dict(advection_method="eulerFluidNet")],
           "march": [dict(use_pallas=False, line_trace=True),
                     dict(viscosity=0.1, line_trace=True)]}[branch]
    for kw in bad:
        with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
            simulate_step3(dataclasses.replace(cfg, **kw), state)


# The branches that raised before the port took them: each a case of the
# parity test below, (port/JAX config changes, model config changes or
# None, stick walls, output_div, grid side).
PORTED = {
    "convnet": (dict(sim_method="convnet"), dict(polish_sweeps=0), False,
                False, 8),
    "project_fn": (dict(sim_method="convnet"),
                   dict(polish_sweeps=8, punet_refine_convs=1), False, False,
                   8),
    "multigrid": (dict(sim_method="multigrid", mg_vcycles=2), None, False,
                  False, 16),
    "viscosity": (dict(viscosity=0.1), None, False, False, 8),
    "flags_stick": ({}, None, True, False, 8),
    "vorticity": (dict(vorticity_confinement=0.1), None, False, False, 8),
    "output_div": ({}, None, False, True, 8),
}


def _stick_box(jstate):
    """The JAX state with a 2^3 obstacle box in its interior, STICK in
    flags_stick."""
    flags = np.array(jstate.flags)
    n = flags.shape[1]
    lo, hi = n // 2 - 1, n // 2 + 1
    flags[:, lo:hi, lo:hi, lo:hi] = 2
    stick = flags.copy()
    stick[:, lo:hi, lo:hi, lo:hi] = 16
    return jstate._replace(flags=jnp.asarray(flags),
                           flags_stick=jnp.asarray(stick))


@pytest.mark.parametrize("branch", list(PORTED))
def test_ported_branches_match_jax(branch):
    """Each branch that raised before this slice, two steps of the plume
    (the inlet's density held, not advected: test_plume3d_steps_match_jax
    holds the density's advection) against the JAX step on its XLA path at
    max_disp 1: the flax-path learned projection with no polish and with
    a refinement stack (ignored, as JAX ignores it; float32, seed weights,
    "xla" polish on kernel I's plain version), the 3-D multigrid (two
    levels at 16^3), viscosity (kernel M with orig), stick walls on an
    obstacle box, vorticity confinement and output_div."""
    from fluidnet_cxx_tpu.config import ModelConfig as JModelConfig
    from fluidnet_cxx_tpu.models.punet3d import FluidNet3 as JFluidNet3
    from fluidnet_cxx_tpu.models.punet3d import \
        make_project_fn3 as j_make_project_fn3
    from fluidnet_cxx_tpu_torch.models.convert import random_flax_params3
    from fluidnet_cxx_tpu_torch.models.punet3d import (FluidNet3,
                                                       init_params3)

    changes, model, stick, output_div, n = PORTED[branch]
    cfg, _ = plume3d_case(n, device="cpu", jacobi_iter=20)
    cfg = dataclasses.replace(cfg, advect_density=False, **changes)
    jcfg = j_config(dt=0.25, jacobi_iter=20, buoyancy_scale=0.5,
                    gravity_vec=(0.0, -1.0, 0.0), line_trace=False,
                    line_trace_impl="firsthit", max_disp=1,
                    advection_impl="window", use_pallas=False,
                    fuse_advection=False, advect_density=False, **changes)
    jstate = j_scene3(n, n, n, density_val=0.1, u_scale=0.6 * n / 64.0)
    if stick:
        jstate = _stick_box(jstate)
    project = jproject = None
    if model is not None:
        kw = dict(model="PUNet3", punet_patch=2, punet_widths=(16, 16),
                  compute_dtype="float32", polish_impl="xla", **model)
        mcfg = ModelConfig(**kw)
        port = init_params3(FluidNet3(mcfg), 5)
        project = make_project_fn3(mcfg, port.net)
        params = random_flax_params3(port.net.table, 5)
        jproject = j_make_project_fn3(JFluidNet3(JModelConfig(**kw)),
                                      {"params": {"PUNet3_0": params}})
    state = to_port_state3(jstate)
    jax_step = jax.jit(lambda s: j_step3(jcfg, s, project_fn=jproject,
                                         output_div=output_div))
    with torch.no_grad():
        for _ in range(2):
            assert cfg.dt * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step3(cfg, state, project,
                                   output_div=output_div)
            for field in ("U", "density", "p"):
                want = np.asarray(getattr(jstate, field))
                np.testing.assert_allclose(
                    getattr(state, field).numpy(), want, rtol=0,
                    atol=1e-4 * max(np.abs(want).max(), 1e-6))
