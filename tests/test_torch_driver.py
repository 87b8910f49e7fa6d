"""The run loop and the simulation restarts against the JAX package, on
the CPU.

``run_simulation``'s stats points: with each package's ``simulate_step``
replaced by a step that counts itself, ``on_stats`` must see the same
sequence of ``it`` and the same number of steps for any ``start_it``,
``stat_iter`` and ``max_iter`` (the alignment to the stats grid, the final
partial chunk, a start at or past the end). Then the real loop: a 32^2
plume from ``configs/plume.yaml`` with 20 Jacobi sweeps, ten steps in both
packages, held to 1e-4 of each field's largest value, the tolerance of the
step tests. The port runs ``max_disp`` 4 and JAX 1: equal while no
back-trace exceeds one cell (asserted at each stats point).

Restarts: a ``restart.npz`` written by either package loads into the other
with equal values and dtypes, and on the CPU a straight run equals a run
cut and restarted bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu import config as j_config
from fluidnet_cxx_tpu.sim import create_plume_scene as j_scene
from fluidnet_cxx_tpu.sim import driver as j_driver
from fluidnet_cxx_tpu.train import checkpoint as j_ckpt
from fluidnet_cxx_tpu_torch import config as t_config
from fluidnet_cxx_tpu_torch.sim import driver as t_driver
from fluidnet_cxx_tpu_torch.sim.scenes import (create_cylinder_scene,
                                               create_plume_scene)
from fluidnet_cxx_tpu_torch.train import checkpoint as t_ckpt

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """The JAX reference is compile-bound here; XLA's optimisation passes
    change no result beyond rounding, so this module runs without them and
    restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _plume_conf():
    conf = t_config.load_yaml("configs/plume.yaml")
    return dict(conf, resX=32, resY=32, jacobiIter=20)


def _plume_scenes(conf):
    kw = dict(density_val=float(conf["injectionDensity"]),
              u_scale=float(conf["injectionVelocity"]),
              rad=float(conf["sourceRadius"]))
    return (create_plume_scene(conf["resX"], conf["resY"], **kw),
            j_scene(conf["resX"], conf["resY"], **kw))


# (start_it, stat_iter, max_iter): from 0, restarts off and on the stats
# grid, a partial last chunk, a start at and past the end.
SCHEDULES = [(0, 4, 10), (3, 4, 10), (5, 4, 10), (4, 4, 10), (10, 4, 10),
             (12, 4, 10), (0, 5, 10), (7, 3, 7), (1, 1, 3), (9, 4, 11)]


@pytest.mark.parametrize("start_it,stat_iter,max_iter", SCHEDULES)
def test_on_stats_sequence_matches_jax(start_it, stat_iter, max_iter,
                                       monkeypatch):
    monkeypatch.setattr(j_driver, "simulate_step", lambda cfg, s, project_fn=
                        None: s._replace(p=s.p + 1.0))
    monkeypatch.setattr(t_driver, "simulate_step", lambda cfg, s, project_fn=
                        None: s._replace(p=s.p + 1.0))
    t_state, j_state = _plume_scenes(dict(_plume_conf(), resX=8, resY=8))
    seen = {"jax": [], "port": []}
    j_final = j_driver.run_simulation(
        j_config.SimConfig(), j_state, max_iter, stat_iter,
        on_stats=lambda s, it: seen["jax"].append((it, float(s.p[0, 0, 0]))),
        start_it=start_it, verbose=False)
    t_final = t_driver.run_simulation(
        t_config.SimConfig(), t_state, max_iter, stat_iter,
        on_stats=lambda s, it: seen["port"].append((it, float(s.p[0, 0, 0]))),
        start_it=start_it, verbose=False)
    assert seen["port"] == seen["jax"]
    assert float(t_final.p[0, 0, 0]) == float(j_final.p[0, 0, 0]) == max(
        max_iter - start_it, 0)


def test_plume_run_matches_jax():
    """Ten steps of the 32^2 plume.yaml plume, stats every 4, on both
    packages' run loops (the port's kernels' plain versions; JAX's XLA
    window engine with the first-hit trace)."""
    conf = _plume_conf()
    cfg = dataclasses.replace(t_config.sim_config_from_mconf(conf),
                              use_pallas=True)
    jcfg = j_config.sim_config_from_mconf(conf).replace(
        max_disp=1, line_trace_impl="firsthit")
    assert cfg.max_disp == 4 and cfg.jacobi_iter == jcfg.jacobi_iter == 20
    t_state, j_state = _plume_scenes(conf)
    seen = {"jax": [], "port": []}

    def on_stats(name):
        def f(s, it):
            assert 0.1 * float(jnp.abs(jnp.asarray(np.asarray(s.U))).max()) \
                < 1.0
            seen[name].append(it)
        return f

    j_final = j_driver.run_simulation(jcfg, j_state, 10, 4,
                                      on_stats=on_stats("jax"),
                                      verbose=False)
    with torch.no_grad():
        t_final = t_driver.run_simulation(cfg, t_state, 10, 4,
                                          on_stats=on_stats("port"),
                                          verbose=False)
    assert seen["port"] == seen["jax"] == [4, 8, 10]
    for field in ("U", "p", "density"):
        want = np.asarray(getattr(j_final, field))
        np.testing.assert_allclose(
            getattr(t_final, field).numpy(), want, rtol=0,
            atol=1e-4 * max(np.abs(want).max(), 1e-6))
    assert float(t_final.density.max()) > 0.09


def _assert_state_equal(got, want):
    """Each field of two SimStates (numpy-convertible) equal, with the
    same dtype and None in the same places."""
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_restart_written_by_jax_loads_into_the_port(tmp_path):
    _, j_state = _plume_scenes(_plume_conf())
    j_state = j_state._replace(p=j_state.p + 0.25)
    path = str(tmp_path / "restart.npz")
    j_ckpt.save_sim_restart(path, j_state, 17)
    state, it = t_ckpt.load_sim_restart(path, "cpu")
    assert it == 17 and state.flags.dtype == torch.int32
    _assert_state_equal(state, j_state)
    assert state.flags_stick is None


def test_restart_written_by_the_port_loads_into_jax(tmp_path):
    state, _ = create_cylinder_scene(64, 32, center_x=16.0, radius=4.0)
    state = state._replace(p=torch.linspace(0, 1, 64 * 32).reshape(1, 32,
                                                                   64))
    path = str(tmp_path / "sub" / "restart.npz")
    t_ckpt.save_sim_restart(path, state, 23)
    j_state, it = j_ckpt.load_sim_restart(path)
    assert it == 23 and j_state.flags_stick.dtype == jnp.int32
    _assert_state_equal(state, j_state)
    again, it = t_ckpt.load_sim_restart(path)
    assert it == 23
    _assert_state_equal(again, state)


def test_straight_run_equals_cut_and_restarted_bit_for_bit(tmp_path):
    """12 steps with stats every 4, against 7 steps with stats every 7,
    a restart from the file at 7 (stepped singly to 8), then stats every
    4 to 12."""
    conf = dict(_plume_conf(), jacobiIter=8)
    cfg = dataclasses.replace(t_config.sim_config_from_mconf(conf),
                              use_pallas=True)
    scene, _ = _plume_scenes(conf)
    path = str(tmp_path / "restart.npz")
    with torch.no_grad():
        straight = t_driver.run_simulation(cfg, scene, 12, 4, verbose=False)
        t_driver.run_simulation(
            cfg, scene, 7, 7, verbose=False,
            on_stats=lambda s, it: t_ckpt.save_sim_restart(path, s, it))
        state, it0 = t_ckpt.load_sim_restart(path)
        seen = []
        resumed = t_driver.run_simulation(
            cfg, state, 12, 4, start_it=it0, verbose=False,
            on_stats=lambda s, it: seen.append(it))
    assert it0 == 7 and seen == [12]
    for name in ("U", "p", "density"):
        assert torch.equal(getattr(resumed, name), getattr(straight, name))


def test_failed_restart_save_leaves_the_previous_one(tmp_path, monkeypatch):
    """A run stopped while it writes restart.npz leaves the previous
    snapshot whole and no temporary file behind."""
    state, _ = create_cylinder_scene(64, 32, center_x=16.0, radius=4.0)
    path = str(tmp_path / "restart.npz")
    t_ckpt.save_sim_restart(path, state, 5)

    def stopped(f, **arrays):
        f.write(b"PK\x03\x04 a truncated archive")
        raise KeyboardInterrupt

    monkeypatch.setattr(t_ckpt.np, "savez", stopped)
    with pytest.raises(KeyboardInterrupt):
        t_ckpt.save_sim_restart(path, state._replace(p=state.p + 1.0), 10)
    monkeypatch.undo()
    again, it = t_ckpt.load_sim_restart(path)
    assert it == 5
    _assert_state_equal(again, state)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["restart.npz"]
