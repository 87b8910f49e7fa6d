"""The 3-D ops of the classical step, port against the JAX package on the
CPU from the same numpy inputs: each ported ``ops3d`` function, the window
samplers of ``window3``, the first-hit trace of ``line_trace3``, the
gather and Euler engines and the march trace of ``advect_scalar3``, the wall
BCs of the step with each periodic override, and the plume scene.

Inputs: 8x16x12 grids, two samples, the border shell plus 8% random
obstacles (and 3% empty cells where the face rules read them).
Tolerance 1e-6 absolute: the port repeats the JAX package's float32
operations in its order; the JAX side runs through XLA's CPU compiler,
which may contract a multiply-add.
"""
import jax
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.config import SimConfig as JSimConfig
from fluidnet_cxx_tpu.ops import line_trace3 as j_trace3
from fluidnet_cxx_tpu.ops import ops3d as j_ops3d
from fluidnet_cxx_tpu.ops import window3 as j_window3
from fluidnet_cxx_tpu.sim import scenes3 as j_scenes3
from fluidnet_cxx_tpu.sim import step3d as j_step3d
from fluidnet_cxx_tpu_torch.config import SimConfig
from fluidnet_cxx_tpu_torch.ops import line_trace3, ops3d, window3
from fluidnet_cxx_tpu_torch.sim import scenes3, step3d

torch.set_num_threads(1)

SHAPE = (2, 8, 16, 12)


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


def close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def random_flags3(rng, shape, p_obstacle=0.08, p_empty=0.0):
    """Border shell of obstacles, random interior obstacles and empties."""
    flags = np.ones(shape, np.int32)
    flags[:, 0] = flags[:, -1] = 2
    flags[:, :, 0] = flags[:, :, -1] = 2
    flags[:, :, :, 0] = flags[:, :, :, -1] = 2
    interior = np.zeros(shape, bool)
    interior[:, 1:-1, 1:-1, 1:-1] = True
    r = rng.random(shape)
    flags[(r < p_obstacle) & interior] = 2
    flags[(r >= p_obstacle) & (r < p_obstacle + p_empty) & interior] = 4
    return flags


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    b, d, h, w = SHAPE
    return dict(
        flags=random_flags3(rng, SHAPE, p_empty=0.03),
        U=rng.standard_normal((b, 3, d, h, w)).astype(np.float32),
        p=rng.standard_normal(SHAPE).astype(np.float32),
        rho=rng.random(SHAPE).astype(np.float32))


GRAVITY = (0.0, 0.5, -0.25)


@pytest.mark.parametrize("op", [
    "velocity_divergence3", "velocity_update3", "set_wall_bcs3",
    "add_buoyancy3", "add_gravity3", "get_centered3", "correct_scalar3",
    "empty_domain3"])
def test_op_matches_jax(fields, op):
    """Each ported ops3d function == the JAX package's on the same data."""
    f, U, p, rho = fields["flags"], fields["U"], fields["p"], fields["rho"]
    tf, tU, tp, trho = T(f), T(U), T(p), T(rho)
    div = np.asarray(j_ops3d.velocity_divergence3(U, f))
    calls = {
        "velocity_divergence3": ((U, f), (tU, tf)),
        "velocity_update3": ((p, U, f), (tp, tU, tf)),
        "set_wall_bcs3": ((U, f), (tU, tf)),
        "add_buoyancy3": ((U, f, rho, np.float32(GRAVITY), 0.05, 0.3),
                          (tU, tf, trho, GRAVITY, 0.05, 0.3)),
        "add_gravity3": ((U, f, np.float32(GRAVITY), 0.3),
                         (tU, tf, GRAVITY, 0.3)),
        "get_centered3": ((U,), (tU,)),
        "correct_scalar3": ((0.3, rho, div, f), (0.3, trho, T(div), tf)),
        "empty_domain3": ((2, 5, 6, 7), (2, 5, 6, 7)),
    }
    j_args, t_args = calls[op]
    want = getattr(j_ops3d, op)(*j_args)
    got = getattr(ops3d, op)(*t_args)
    close(got, want)
    assert got.dtype == (torch.int32 if op == "empty_domain3"
                         else torch.float32)


@pytest.mark.parametrize("periodic", ["none", "x", "y", "z"])
def test_wall_bcs3_matches_jax(fields, periodic):
    """The step's wall BCs with each periodic override: the first interior
    layer's tangential components take the last layer's values."""
    f, U = fields["flags"], fields["U"]
    kw = {} if periodic == "none" else {f"periodic_{periodic}": True}
    j_state = j_step3d.SimState3(p=None, U=U, flags=f, density=None)
    want = j_step3d._wall_bcs3(JSimConfig(**kw), j_state, U)
    t_state = step3d.SimState3(p=None, U=T(U), flags=T(f), density=None)
    got = step3d._wall_bcs3(SimConfig(**kw), t_state, T(U))
    close(got, want, 0.0)


def test_plume_scene3_matches_jax():
    """create_plume_scene3: every field equal to the JAX scene's."""
    want = j_scenes3.create_plume_scene3(8, 16, 12, density_val=0.1,
                                         u_scale=0.15)
    got = scenes3.create_plume_scene3(8, 16, 12, density_val=0.1,
                                      u_scale=0.15)
    for field in ("p", "U", "flags", "density", "U_bc", "U_bc_inv_mask",
                  "density_bc", "density_bc_inv_mask"):
        close(getattr(got, field), getattr(want, field), 0.0)
    assert got.U.data_ptr() != got.U_bc.data_ptr()
    assert got.flags_stick is None and want.flags_stick is None


def test_create_state3_matches_jax():
    """create_state3: zero fields over the empty domain, as in JAX."""
    want = j_step3d.create_state3(2, 5, 6, 7)
    got = step3d.create_state3(2, 5, 6, 7)
    for field in ("p", "U", "flags", "density"):
        close(getattr(got, field), getattr(want, field), 0.0)
        assert getattr(got, field).shape == getattr(want, field).shape
    assert got.U_bc is None and got.flags.dtype == torch.int32


@pytest.fixture(scope="module")
def positions(fields):
    """Back-traced positions within ~1.6 cells of each centre (past the
    D=1 window) and their displacements."""
    rng = np.random.default_rng(1)
    b, d, h, w = SHAPE
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    centres = np.stack([xx, yy, zz]).astype(np.float32)[None] + 0.5
    disp = rng.uniform(-1.6, 1.6, (b, 3, d, h, w)).astype(np.float32)
    return centres.repeat(b, 0), disp


@pytest.mark.parametrize("fn", ["interpol_window3", "clamp_bounds",
                                "clamp_mac", "blocked_lookup"])
def test_window3_matches_jax(fields, positions, fn):
    """The window samplers at D=1 (the clamp binds for displacements past
    one cell): direct corner gathers give the JAX masked sums' values."""
    f, rho, U = fields["flags"], fields["rho"], fields["U"]
    centres, disp = positions
    pos = centres + disp
    if fn == "interpol_window3":
        want = j_window3.interpol_window3(rho, pos, 1)
        got = window3.interpol_window3(T(rho), T(pos), 1)
        close(got, want)
    elif fn == "clamp_bounds":
        want = j_window3.clamp_bounds_scalar_window3(rho, pos, f, 1)
        got = window3.clamp_bounds_scalar_window3(T(rho), T(pos), T(f), 1)
        assert torch.equal(got[0], T(want[0]))
        ok = got[0].numpy()
        for g, w_ in zip(got[1:], want[1:]):
            close(g.numpy()[ok], np.asarray(w_)[ok], 0.0)
    elif fn == "clamp_mac":
        dst = 3.0 * rho - 1.0
        want = j_window3.clamp_component_mac_window3(dst, U[:, 0], disp, 1)
        got = window3.clamp_component_mac_window3(T(dst), T(U[:, 0]),
                                                  T(disp), 1)
        close(got, want, 0.0)
    else:
        want = j_window3.make_blocked_lookup_window3(f, 1)(pos)
        got = window3.make_blocked_lookup_window3(T(f), 1)(T(pos))
        assert torch.equal(got, T(want))


def test_line_trace_firsthit3_matches_jax(fields, positions):
    """The first-hit trace at D=1 from every cell centre."""
    f = fields["flags"]
    centres, disp = positions
    disp = np.clip(disp, -1, 1)
    want = j_trace3.line_trace_firsthit3(centres, disp, f, 1)
    got = line_trace3.line_trace_firsthit3(T(centres), T(disp), T(f), 1)
    close(got, want)
    moved = (got - T(centres)).abs().sum(1) > 0
    assert bool(moved.any()) and not bool(moved[T(f) != 1].any())


def test_unported_advection_raises(fields):
    """The engines that raised before the port took them (ROADMAP A.6):
    gather, Euler and the march trace (with the window lookup at D=1),
    against the JAX package's advect_scalar3 and advect_velocity3."""
    f, U, rho = fields["flags"], fields["U"], fields["rho"]
    tf, tU, trho = T(f), T(U), T(rho)
    for kw in (dict(impl="gather"), dict(method="eulerFluidNet"),
               dict(line_trace=True, line_trace_impl="march")):
        kw = dict(kw, max_disp=1)
        want = jax.jit(lambda r, u, fl: j_ops3d.advect_scalar3(
            0.1, r, u, fl, **kw))(rho, U, f)
        close(ops3d.advect_scalar3(0.1, trho, tU, tf, **kw), want)
    for kw in (dict(impl="gather"), dict(method="eulerFluidNet")):
        want = jax.jit(lambda u, fl: j_ops3d.advect_velocity3(
            0.1, u, fl, max_disp=1, **kw))(U, f)
        close(ops3d.advect_velocity3(0.1, tU, tf, max_disp=1, **kw), want)
