"""The slice as a whole: five steps of the 24^3 buoyant plume under
Jacobi-60, port against the JAX package's ``simulate_step3`` on the CPU,
merged advection with the first-hit trace and separate advection without
it; the entry point ``run_plume3d``; and the branches the port does not
implement, which raise.

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
from fluidnet_cxx_tpu_torch.models.punet3d import PUNet3, make_project_fn3
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


@pytest.mark.parametrize("branch", [
    "convnet", "project_fn", "multigrid", "viscosity", "flags_stick",
    "vorticity", "output_div", "gather", "euler", "march"])
def test_unported_branches_raise(branch):
    """Every branch of the JAX step that the port does not implement
    raises NotImplementedError naming its ROADMAP item. The learned
    projection runs (tests/test_torch_learned3d.py) except on the JAX
    package's flax path: with no polish sweeps ("convnet") or a refinement
    stack ("project_fn"), building the projection raises."""
    cfg, state = plume3d_case(6, device="cpu", jacobi_iter=2)
    assert simulate_step3(cfg, state) is not None
    kw, item = {
        "convnet": (dict(cfg=dict(sim_method="convnet"),
                         model=dict(polish_sweeps=0)), "A.4"),
        "project_fn": (dict(cfg=dict(sim_method="convnet"),
                            model=dict(polish_sweeps=8,
                                       punet_refine_convs=1)), "A.4"),
        "multigrid": (dict(cfg=dict(sim_method="multigrid")), "A.7"),
        "viscosity": (dict(cfg=dict(viscosity=0.1)), "A.7"),
        "flags_stick": (dict(stick=True), "A.7"),
        "vorticity": (dict(cfg=dict(vorticity_confinement=0.1)), "A.7"),
        "output_div": (dict(output_div=True), "A.7"),
        "gather": (dict(cfg=dict(advection_impl="gather")), "A.6"),
        "euler": (dict(cfg=dict(advection_method="eulerFluidNet")), "A.6"),
        "march": (dict(cfg=dict(use_pallas=False, line_trace=True)), "A.6"),
    }[branch]
    bad_cfg = dataclasses.replace(cfg, **kw.get("cfg", {}))
    bad_state = (state._replace(flags_stick=state.flags) if "stick" in kw
                 else state)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        project = None
        if "model" in kw:
            mcfg = ModelConfig(model="PUNet3", punet_patch=2,
                               punet_widths=(16, 16), **kw["model"])
            project = make_project_fn3(mcfg, PUNet3(2, 2, (16, 16)))
        simulate_step3(bad_cfg, bad_state, project,
                       output_div=kw.get("output_div", False))
