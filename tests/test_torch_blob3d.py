"""The 3-D buoyant blob (ROADMAP A.7.5), port against the JAX package on
the CPU: three steps of the blob's config (``plume_config`` with dt
0.25, Jacobi-60, buoyancy 0.5, gravity (0, -1, 0), max_disp 2: the
window engine with the march trace, use_pallas off) at 16^3 against
``simulate_step3``, and the twin ``scripts/run_blob3d.py`` at ``--res
16`` for 4 steps against JAX's script run the same way.

JAX runs the blob's config at max_disp 1 (its window engine then
compiles in a fraction of the time), which gives the same fields while
no back-trace reaches a cell away (asserted): the window's clamp and its
lookup's reach do not bind.

Tolerances: 1e-5 of each field's largest value on the steps (the Jacobi
sums run in another order); the twin's printed lines equal JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu import sim as j_sim
from fluidnet_cxx_tpu.sim.step3d import create_state3 as j_create_state3
from fluidnet_cxx_tpu.sim.step3d import simulate_step3 as j_step3
from fluidnet_cxx_tpu_torch.scripts import run_blob3d
from fluidnet_cxx_tpu_torch.sim.step3d import simulate_step3
from torch_jax_scripts import run_jax_script

torch.set_num_threads(1)

@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs
    without them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def test_blob_steps_match_jax():
    n = 16
    args = run_blob3d.parse_args(["--res", str(n), "--device", "cpu"])
    cfg = run_blob3d.blob_config(args)
    assert (not cfg.use_pallas and cfg.line_trace
            and cfg.line_trace_impl == "march" and cfg.max_disp == 2
            and cfg.advection_impl == "window")
    state = run_blob3d.blob_state(n, "cpu")
    jcfg = j_sim.plume_config(dt=0.25, jacobi_iter=60, buoyancy_scale=0.5,
                              gravity_vec=(0.0, -1.0, 0.0), max_disp=1)
    jstate = j_create_state3(1, n, n, n)._replace(
        density=jnp.asarray(state.density.numpy()))
    jax_step = jax.jit(lambda s: j_step3(jcfg, s))
    with torch.no_grad():
        for _ in range(3):
            jstate = jax_step(jstate)
            state = simulate_step3(cfg, state)
            assert cfg.dt * float(jnp.abs(jstate.U).max()) < 1.0
            for field in ("U", "density", "p"):
                want = np.asarray(getattr(jstate, field))
                np.testing.assert_allclose(
                    getattr(state, field).numpy(), want, rtol=0,
                    atol=1e-5 * max(np.abs(want).max(), 1e-6))
    assert float(jnp.abs(jstate.U).max()) > 0.05


def test_run_blob3d_matches_jax_script(tmp_path, capsys):
    argv = ["--res", "16", "--maxIter", "4", "--statIter", "2"]
    want = run_jax_script("run_blob3d", argv + [
        "--outputFolder", str(tmp_path / "jax")], max_disp=1)
    out = run_blob3d.main(argv + ["--outputFolder", str(tmp_path / "port"),
                                  "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [x for x in lines if x.startswith("it=")] == \
        [x for x in want.splitlines() if x.startswith("it=")]
    assert len(out["stats"]) == 2 and out["it"] == 4 and out["finite"]
    assert out["ms_per_step"] > 0 and out["max_div"] < 1e-2
