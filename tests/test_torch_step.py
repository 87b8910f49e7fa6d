"""The slice as a whole: five steps of the 64^2 buoyant plume with the
learned projection at PUNetD2_128's full widths, port against the JAX
package, on the CPU, from the same flax-initialised weights.

JAX runs ``simulate_step`` with ``use_pallas=False`` (the XLA window
engine with the first-hit trace) and ``make_project_fn`` (flax forward,
XLA polish on the normalised fields, un-normalise, wall and inlet BCs as
separate passes). The port runs its fused-semantics path: inlet BCs folded
into the projection, input normalisation inside the forward, polish on
un-normalised fields. The two differ only in float32 rounding.

The port runs the slice's max_disp 4. JAX runs max_disp 1, which needs a
tenth of the compile time here and gives the same fields while no
back-trace exceeds one cell (asserted): the window clamp does not bind and
no ray can reach a cell two away.

Tolerance: 1e-4 relative to each field's largest magnitude, for the
different summation order of the convolutions and the rescaled polish.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.models import FluidNet, make_project_fn
from fluidnet_cxx_tpu.sim import create_plume_scene as j_scene
from fluidnet_cxx_tpu.sim import plume_config as j_config
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu.train.checkpoint import load_model_config as j_mcfg
from fluidnet_cxx_tpu_torch.models.convert import random_flax_params
from fluidnet_cxx_tpu_torch.models.punet import layer_table
from fluidnet_cxx_tpu_torch.run_plume import MODEL_DIR, plume_case
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

RES, STEPS, SEED = 64, 5, 0


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def test_plume_steps_match_jax():
    cfg, state, project = plume_case(RES, device="cpu", weight_seed=SEED)
    assert cfg.max_disp == 4

    mcfg = j_mcfg(str(MODEL_DIR))
    table = layer_table(2, mcfg.punet_patch, mcfg.punet_widths,
                        mcfg.punet_level_convs, mcfg.punet_bottleneck_convs,
                        mcfg.punet_bottleneck_dilation)
    params = {"params": {"PUNet_0": random_flax_params(table, SEED)}}
    j_project = make_project_fn(FluidNet(mcfg), params)
    jcfg = j_config(dt=0.1, line_trace=True, line_trace_impl="firsthit",
                    max_disp=1, use_pallas=False, sim_method="convnet")
    jstate = j_scene(RES, RES, density_val=0.1, u_scale=2.0 * RES / 128.0,
                     rad=0.145)

    jax_step = jax.jit(lambda s: j_step(jcfg, s, project_fn=j_project))
    with torch.no_grad():
        for _ in range(STEPS):
            assert 0.1 * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step(cfg, state, project)
            _close(state.U, jstate.U)
            _close(state.density, jstate.density)
            _close(state.p, jstate.p)
    assert torch.isfinite(state.U).all()
    assert float(state.density.max()) > 0.09   # the inlet keeps injecting
