"""The learned 3-D projection's fused forward as a whole, port against the
JAX package on the CPU: the port's ``make_project_fn3_fused_forward``
against JAX's (its Pallas kernels N and J interpreted, as
``tests/test_pallas.py`` runs them), three 32^3 ``simulate_step3`` convnet
steps of bench3d's learned
plume case with PUNet3p8_64 (patch 8) and PUNet3_32 (patch 4) at full
widths, the convnet step's wall-BC rule, and the entry point.

The JAX step runs the port's configuration on its XLA advection path at
max_disp 1 (the port runs max_disp 2), which builds in a fraction of the
time and gives the same fields while no back-trace exceeds one cell
(asserted), as in ``tests/test_torch_step3d.py``.

Tolerances: float32, 1e-4 of each field's largest value (the convolutions
and the XLA sums add in other orders; measured here within 3.4e-7);
bfloat16, 1e-3 of each field's largest value (a sum in another order can
round an activation to the neighbouring bfloat16, and the forward then
differs by up to 2.7e-3 of its largest output, ``tests/
test_torch_punet3.py``; the polish sweeps and the velocity update damp
that here: measured within 9.6e-5 (p) and 6.4e-5 (U) for the projection
and 7.5e-5 (p) after three steps, all with patch 4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.config import ModelConfig as JaxModelConfig
from fluidnet_cxx_tpu.models.punet3d import (FluidNet3,
                                              make_project_fn3_fused_forward)
from fluidnet_cxx_tpu.sim import plume_config as j_config
from fluidnet_cxx_tpu.sim.scenes3 import create_plume_scene3 as j_scene3
from fluidnet_cxx_tpu.sim.step3d import SimState3 as JSimState3
from fluidnet_cxx_tpu.sim.step3d import simulate_step3 as j_step3
from fluidnet_cxx_tpu_torch.celltype import OBSTACLE
from fluidnet_cxx_tpu_torch.config import load_model_config
from fluidnet_cxx_tpu_torch.models.convert import random_flax_params3
from fluidnet_cxx_tpu_torch.models.punet3d import \
    make_project_fn3_fused_forward as port_fused_forward
from fluidnet_cxx_tpu_torch.ops.ops3d import empty_domain3, set_wall_bcs3
from fluidnet_cxx_tpu_torch.run_plume3d import (MODELS, build_punet3,
                                                plume3d_case, run_plume3d)
from fluidnet_cxx_tpu_torch.sim.step3d import SimState3, simulate_step3

torch.set_num_threads(1)

RES, STEPS = 32, 3
BF16_REL = 1e-3
MODEL_DIRS = {"p8": MODELS / "PUNet3p8_64", "p4": MODELS / "PUNet3_32"}


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Every pallas_call of the JAX package runs in interpret mode."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp_call)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs without
    them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _projections(model, dtype, res=RES, seed=0):
    """(port project_fn, JAX fused-forward project_fn) of one model dir at
    ``dtype``, the same weights (``random_flax_params3(seed)``) in both,
    ``polish_impl`` "fused" as bench3d sets it for the fused forward."""
    mcfg = dataclasses.replace(load_model_config(str(MODEL_DIRS[model])),
                               compute_dtype=dtype, polish_impl="fused")
    net = build_punet3(mcfg, seed)
    params = random_flax_params3(net.table, seed)
    jcfg = JaxModelConfig(**dataclasses.asdict(mcfg))
    jproj = make_project_fn3_fused_forward(
        FluidNet3(jcfg), {"params": {"PUNet3_0": params}}, res, res, res,
        compute_dtype=jnp.dtype(dtype))
    return port_fused_forward(mcfg, net), jproj


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["p8", "p4"])
def test_make_project_fn3_matches_fused_forward(model, dtype):
    """The port's make_project_fn3_fused_forward against JAX's: one
    projection of a divergent U over flags with 8% obstacles: divergence,
    UDiv scale, PUNet3 forward (N), tail (J)."""
    rng = np.random.default_rng(3)
    flags = empty_domain3(1, RES, RES, RES)
    flags[torch.from_numpy(rng.random(flags.shape) < 0.08)] = OBSTACLE
    U = (0.5 * rng.standard_normal((1, 3, RES, RES, RES))).astype(np.float32)
    p = np.zeros((1, RES, RES, RES), np.float32)
    project, jproj = _projections(model, dtype)
    want = jproj(jnp.asarray(p), jnp.asarray(U), jnp.asarray(flags.numpy()),
                 jnp.asarray(p))
    got = project(torch.from_numpy(p), torch.from_numpy(U), flags,
                  torch.from_numpy(p))
    rel = 1e-4 if dtype == "float32" else BF16_REL
    for g, w in zip(got, want):
        _close(g, w, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["p8", "p4"])
def test_learned3d_steps_match_jax(model, dtype):
    """Three steps of bench3d's learned plume case (K, M, then N and J in
    the projection) against the JAX step with the fused forward."""
    cfg, state = plume3d_case(RES, device="cpu", sim_method="convnet")
    assert cfg.max_disp == 2 and not cfg.line_trace
    project, jproj = _projections(model, dtype)
    jcfg = j_config(dt=0.25, sim_method="convnet", buoyancy_scale=0.5,
                    gravity_vec=(0.0, -1.0, 0.0), line_trace=False,
                    max_disp=1, advection_impl="window", use_pallas=False,
                    fuse_advection=False)
    jstate = j_scene3(RES, RES, RES, density_val=0.1,
                      u_scale=0.6 * RES / 64.0)
    jax_step = jax.jit(lambda s: j_step3(jcfg, s, project_fn=jproj))
    rel = 1e-4 if dtype == "float32" else BF16_REL
    with torch.no_grad():
        for _ in range(STEPS):
            assert cfg.dt * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step3(cfg, state, project)
            for field in ("U", "density", "p"):
                _close(getattr(state, field), getattr(jstate, field), rel)


def test_convnet_step_skips_the_step_wall_bcs():
    """Under convnet the step applies no wall BCs of its own before or
    after the projection (the projection's tail applies them), as the JAX
    step: with a projection that returns U unchanged, the U it receives
    still has flow through obstacle faces, and the step equals JAX's."""
    rng = np.random.default_rng(4)
    n = 12
    flags = empty_domain3(1, n, n, n)
    flags[torch.from_numpy(rng.random(flags.shape) < 0.05)] = OBSTACLE
    U = rng.uniform(-1.5, 1.5, (1, 3, n, n, n)).astype(np.float32)
    rho = rng.random((1, n, n, n)).astype(np.float32)
    p = np.zeros((1, n, n, n), np.float32)
    cfg, _ = plume3d_case(n, device="cpu", sim_method="convnet")
    cfg = dataclasses.replace(cfg, max_disp=1)
    jcfg = j_config(dt=0.25, sim_method="convnet", buoyancy_scale=0.5,
                    gravity_vec=(0.0, -1.0, 0.0), line_trace=False,
                    max_disp=1, advection_impl="window", use_pallas=False,
                    fuse_advection=False)
    seen = []

    def identity(p, U, flags, density):
        seen.append(U.clone())
        return p, U

    state = SimState3(torch.from_numpy(p), torch.from_numpy(U), flags,
                      torch.from_numpy(rho))
    with torch.no_grad():
        got = simulate_step3(cfg, state, identity)
    want = jax.jit(lambda s: j_step3(
        jcfg, s, project_fn=lambda p, U, flags, density: (p, U)))(
        JSimState3(p, U, flags.numpy(), rho))
    assert not torch.equal(set_wall_bcs3(seen[0], flags), seen[0])
    assert not torch.equal(set_wall_bcs3(got.U, flags), got.U)
    for field in ("U", "density", "p"):
        _close(getattr(got, field), getattr(want, field), 1e-5)
    with pytest.raises(ValueError, match="project_fn"):
        simulate_step3(cfg, state)


def test_run_plume3d_convnet_on_cpu():
    """The entry point's learned case on the CPU: finite fields, the
    quality stats, no kernel launched (the plain versions ran)."""
    out = run_plume3d(16, 2, device="cpu", sim_method="convnet",
                      polish_sweeps=2)
    st = out["state"]
    assert st.U.shape == (1, 3, 16, 16, 16)
    assert all(bool(torch.isfinite(t).all()) for t in st[:4])
    assert out["launches_per_step"] == {}
    assert out["max_div"] >= out["mean_div"] >= 0.0
