"""The 2-D advection engines of the JAX step's XLA path, port against the
JAX package on the CPU from the same numpy inputs: ``gather2d`` and the
gather engine's samplers (ops/grid.py), the window engine's blocked-cell
lookup, the iterative march ``calc_line_trace`` with both lookups,
``advect_scalar`` and ``advect_velocity`` over method (Euler,
MacCormack) x engine (gather, window) x trace (march, first-hit) x
``sample_outside_fluid``, the step's dispatch between the torch engines
and kernels A, D and E, and five steps of ``simulate_step`` under
``plume_config()`` (the march on the window engine, max_disp 4) on a
32^2 plume with a disc in its way.

Inputs: 24x20 grids, two samples, the border ring and random discs;
back-trace displacements up to 6 cells (the window cases at max_disp 2).

Tolerances: 1e-6 absolute on single ops, whose float32 operations the
port repeats in JAX's order (XLA's CPU compiler is run without its
optimisation passes here, which would contract multiply-adds); 1e-5 of
the largest value where the first-hit trace runs (its slab divisions,
as held in tests/test_torch_advect.py); 1e-5 of each field's largest
value on the steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.ops import advection as j_adv
from fluidnet_cxx_tpu.ops import common as j_common
from fluidnet_cxx_tpu.ops import grid as j_grid
from fluidnet_cxx_tpu.ops import line_trace as j_trace
from fluidnet_cxx_tpu.ops import window as j_window
from fluidnet_cxx_tpu.sim import add_cylinder as j_add_cylinder
from fluidnet_cxx_tpu.sim import create_plume_scene as j_scene
from fluidnet_cxx_tpu.sim import plume_config as j_config
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu_torch.ops import advection, common, grid, line_trace
from fluidnet_cxx_tpu_torch.ops import window
from fluidnet_cxx_tpu_torch.sim.scenes import plume_config
from fluidnet_cxx_tpu_torch.sim.step import simulate_step, torch_advection
from fluidnet_cxx_tpu_torch.state import SimState

torch.set_num_threads(1)

SHAPE = (2, 24, 20)
DT = 0.1


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs
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


def disc_flags(rng, shape, n_discs=3):
    """The border ring of obstacles and ``n_discs`` random obstacle discs
    (radius 1.5-3.5 cells) in each sample."""
    b, h, w = shape
    flags = np.ones(shape, np.int32)
    flags[:, 0] = flags[:, -1] = 2
    flags[:, :, 0] = flags[:, :, -1] = 2
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(b):
        for _ in range(n_discs):
            cx, cy = rng.uniform(2, w - 2), rng.uniform(2, h - 2)
            r = rng.uniform(1.5, 3.5)
            flags[i][(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = 2
    return flags


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    b, h, w = SHAPE
    yy, xx = np.mgrid[0:h, 0:w]
    centres = np.broadcast_to(
        np.stack([xx + 0.5, yy + 0.5]).astype(np.float32), (b, 2, h, w))
    return dict(
        flags=disc_flags(rng, SHAPE),
        src=rng.standard_normal(SHAPE).astype(np.float32),
        # dt * |U| up to ~3 cells a component.
        U=(rng.standard_normal((b, 2, h, w)) * 12).astype(np.float32),
        centres=np.ascontiguousarray(centres),
        disp=rng.uniform(-6, 6, (b, 2, h, w)).astype(np.float32))


def test_gather2d_matches_jax(fields):
    rng = np.random.default_rng(1)
    b, h, w = SHAPE
    yi = rng.integers(0, h, (b, h, w)).astype(np.int32)
    xi = rng.integers(0, w, (b, h, w)).astype(np.int32)
    for src in (fields["src"], fields["flags"]):
        want = j_common.gather2d(src, yi, xi)
        got = common.gather2d(T(src), T(yi), T(xi))
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(common.interior_mask(h, w, 2),
                       T(j_common.interior_mask(h, w, 2)))


def test_interpolators_match_jax(fields):
    """The gather engine's bilinear samplers at positions up to 6 cells
    from each centre, the domain's outside included."""
    src, flags = fields["src"], fields["flags"]
    pos = fields["centres"] + fields["disp"]
    close(grid.interpol(T(src), T(pos)), j_grid.interpol(src, pos))
    close(grid.interpol_with_fluid(T(src), T(flags), T(pos)),
          j_grid.interpol_with_fluid(src, flags, pos))
    U = fields["U"]
    for c in (0, 1):
        close(grid.interpol_component(T(U), T(pos), c),
              j_grid.interpol_component(U, pos, c))


@pytest.mark.parametrize("D", [1, 2])
def test_blocked_lookup_window_matches_jax(fields, D):
    """The window lookup (one gather) against JAX's sum of masked
    shifted copies, at positions out to D + 2 cells from the querying
    cell (outside its window) and outside the domain."""
    rng = np.random.default_rng(2)
    flags = fields["flags"]
    pos = fields["centres"] + rng.uniform(
        -D - 2, D + 2, fields["centres"].shape).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda f, q: j_window.make_blocked_lookup_window(f, D)(q))(
            flags, pos))
    got = window.make_blocked_lookup_window(T(flags), D)(T(pos))
    assert np.array_equal(got.numpy(), want)
    far = (np.abs(np.trunc(pos) - np.floor(fields["centres"])) > D).any(1)
    assert want.any() and far.any() and not want[far].any()


@pytest.mark.parametrize("engine", ["gather", "window"])
def test_calc_line_trace_matches_jax(fields, engine):
    """The march from every cell centre, displacements up to 6 cells
    (gather lookup) or clipped to 2 (window lookup, D 2), through the
    random discs."""
    flags, start, disp = fields["flags"], fields["centres"], fields["disp"]
    if engine == "window":
        disp = np.clip(disp, -2, 2)

        def j_fn(p, d, f):
            return j_trace.calc_line_trace(
                p, d, f, blocked_lookup=j_window.make_blocked_lookup_window(
                    f, 2))

        lookup = window.make_blocked_lookup_window(T(flags), 2)
    else:
        def j_fn(p, d, f):
            return j_trace.calc_line_trace(p, d, f)

        lookup = None
    want = np.asarray(jax.jit(j_fn)(start, disp, flags))
    got = line_trace.calc_line_trace(T(start), T(disp), T(flags),
                                     blocked_lookup=lookup)
    close(got, want)
    # Some rays stop short of their full length at a disc or a wall.
    short = np.abs(want - (start + disp)).sum(1) > 1e-3
    fluid = flags == 1
    assert short[fluid].any() and (~short[fluid]).any()
    assert torch.equal(line_trace.calc_line_trace(T(start), T(disp),
                                                  T(flags), False),
                       T(start + disp))


TRACES = [("gather", "march"), ("window", "march"), ("window", "firsthit")]


@pytest.mark.parametrize("outside", [False, True])
@pytest.mark.parametrize("impl,trace", TRACES)
@pytest.mark.parametrize("method", [j_adv.EULER, j_adv.MACCORMACK])
def test_advect_scalar_matches_jax(fields, method, impl, trace, outside):
    src, U, flags = fields["src"], fields["U"], fields["flags"]
    kw = dict(method=method, impl=impl, line_trace_impl=trace)
    want = np.asarray(jax.jit(lambda s, u, f: j_adv.advect_scalar(
        DT, s, u, f, sample_outside_fluid=outside, max_disp=2, **kw))(
            src, U, flags))
    got = advection.advect_scalar(DT, T(src), T(U), T(flags), outside,
                                  0.75, True, 2, **kw)
    tol = 1e-5 * np.abs(want).max() if trace == "firsthit" else 1e-6
    close(got, want, tol)


@pytest.mark.parametrize("impl", ["gather", "window"])
@pytest.mark.parametrize("method", [j_adv.EULER, j_adv.MACCORMACK])
def test_advect_velocity_matches_jax(fields, method, impl):
    U, flags = fields["U"], fields["flags"]
    orig = 0.5 * U[:, ::-1]
    want = np.asarray(jax.jit(lambda o, u, f: j_adv.advect_velocity(
        DT, o, u, f, method=method, impl=impl, max_disp=2))(orig, U, flags))
    got = advection.advect_velocity(DT, T(orig), T(U), T(flags), 0.75, 2,
                                    method=method, impl=impl)
    close(got, want)
    assert np.abs(want).max() > 1.0


def test_step_dispatch():
    """Which field each config advects on the torch engines (True) and
    which on kernels A, D and E (False): JAX's dispatch."""
    cases = {
        (): (True, False),                                  # XLA march
        (("use_pallas", True),): (False, False),            # the kernels
        (("line_trace_impl", "firsthit"),): (False, False),
        (("line_trace", False),): (False, False),
        (("advection_impl", "gather"),): (True, True),
        (("advection_impl", "gather"), ("use_pallas", True)): (False, False),
        (("advection_method", "eulerFluidNet"),): (True, True),
        (("advection_method", "eulerFluidNet"), ("use_pallas", True)):
            (True, True),
    }
    for kw, want in cases.items():
        assert torch_advection(plume_config(**dict(kw))) == want, kw
    # Under the rollout's DynParams the JAX step takes its XLA path.
    assert torch_advection(plume_config(use_pallas=True), dyn=object()) == \
        (True, False)


def test_plume_steps_match_jax():
    """Five steps of ``plume_config()`` (use_pallas off: the march with
    the window lookup at max_disp 4 for the density, kernel E's plain
    version for the velocity, Jacobi-200 on kernel F's) on a 32^2 plume
    whose inlet blows at 1.2 cells a step into a disc."""
    res = 32
    jstate = j_scene(res, res, density_val=0.5, u_scale=12.0, rad=0.15)
    jstate = jstate._replace(flags=j_add_cylinder(jstate.flags, 16.0, 14.0,
                                                  4.0))
    state = SimState(*(None if a is None else T(a) for a in jstate))
    cfg, jcfg = plume_config(), j_config()
    assert (not cfg.use_pallas and cfg.line_trace_impl == "march"
            and cfg.max_disp == 4)
    jax_step = jax.jit(lambda s: j_step(jcfg, s))
    with torch.no_grad():
        for _ in range(5):
            jstate = jax_step(jstate)
            state = simulate_step(cfg, state)
            for field in ("U", "density", "p"):
                want = np.asarray(getattr(jstate, field))
                close(getattr(state, field), want,
                      1e-5 * max(np.abs(want).max(), 1e-6))
    assert float(jnp.abs(jstate.U).max()) * cfg.dt > 1.0
