"""The 3-D advection engines of the JAX step's XLA path, port against the
JAX package on the CPU from the same numpy inputs: ``gather3`` and the
gather engine's ``interpol3``, the march ``calc_line_trace3`` with the
gather lookup and the window lookup, ``advect_scalar3`` and
``advect_velocity3`` over method (Euler, MacCormack) x engine (gather,
window) x trace (march, first-hit, none), the 3-D step's dispatch
between the torch engines and kernels K, L and M, and bench3d's "window
(XLA)" and "gather" rows on the CPU.

Inputs: 8x12x10 grids, two samples, the border shell and 10% random
obstacles; displacements up to 4 cells (the window cases at max_disp 1,
which JAX's window engine compiles in a fraction of max_disp 2's time).

Tolerances: 1e-6 absolute (the port repeats JAX's float32 operations in
its order; XLA's CPU compiler runs without its optimisation passes
here); 1e-5 of the largest value where the first-hit trace runs.
"""
import jax
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.ops import line_trace3 as j_trace3
from fluidnet_cxx_tpu.ops import ops3d as j_ops3d
from fluidnet_cxx_tpu.ops import window3 as j_window3
from fluidnet_cxx_tpu_torch import bench3d
from fluidnet_cxx_tpu_torch.ops import line_trace3, ops3d, window3
from fluidnet_cxx_tpu_torch.sim.scenes import plume_config
from fluidnet_cxx_tpu_torch.sim.step3d import torch_advection3

torch.set_num_threads(1)

SHAPE = (2, 8, 12, 10)
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


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    b, d, h, w = SHAPE
    flags = np.ones(SHAPE, np.int32)
    flags[:, 0] = flags[:, -1] = 2
    flags[:, :, 0] = flags[:, :, -1] = 2
    flags[:, :, :, 0] = flags[:, :, :, -1] = 2
    interior = np.zeros(SHAPE, bool)
    interior[:, 1:-1, 1:-1, 1:-1] = True
    flags[(rng.random(SHAPE) < 0.1) & interior] = 2
    zz, yy, xx = np.mgrid[0:d, 0:h, 0:w]
    centres = np.broadcast_to(
        np.stack([xx + 0.5, yy + 0.5, zz + 0.5]).astype(np.float32),
        (b, 3, d, h, w))
    return dict(
        flags=flags,
        src=rng.standard_normal(SHAPE).astype(np.float32),
        U=(rng.standard_normal((b, 3, d, h, w)) * 10).astype(np.float32),
        centres=np.ascontiguousarray(centres),
        disp=rng.uniform(-4, 4, (b, 3, d, h, w)).astype(np.float32))


def test_gather_and_interpol3_match_jax(fields):
    rng = np.random.default_rng(1)
    b, d, h, w = SHAPE
    idx = [rng.integers(0, n, SHAPE).astype(np.int32) for n in (d, h, w)]
    want = j_ops3d._gather3(fields["src"], *idx)
    assert np.array_equal(ops3d.gather3(T(fields["src"]),
                                        *map(T, idx)).numpy(),
                          np.asarray(want))
    pos = fields["centres"] + fields["disp"]
    close(ops3d.interpol3(T(fields["src"]), T(pos)),
          j_ops3d.interpol3(fields["src"], pos))


@pytest.mark.parametrize("engine", ["gather", "window"])
def test_calc_line_trace3_matches_jax(fields, engine):
    """The march from every cell centre along displacements up to 4 cells
    a component (unclamped, as the 3-D march runs them), with the gather
    lookup or the window lookup (D 1: cells farther away read as fluid)."""
    flags, start, disp = fields["flags"], fields["centres"], fields["disp"]
    if engine == "window":
        def j_fn(p, dd, f):
            return j_trace3.calc_line_trace3(
                p, dd, f,
                blocked_lookup=j_window3.make_blocked_lookup_window3(f, 1))

        lookup = window3.make_blocked_lookup_window3(T(flags), 1)
    else:
        def j_fn(p, dd, f):
            return j_trace3.calc_line_trace3(p, dd, f)

        lookup = None
    want = np.asarray(jax.jit(j_fn)(start, disp, flags))
    got = line_trace3.calc_line_trace3(T(start), T(disp), T(flags),
                                       blocked_lookup=lookup)
    close(got, want)
    short = np.abs(want - (start + disp)).sum(1) > 1e-3
    fluid = flags == 1
    assert short[fluid].any() and (~short[fluid]).any()


TRACES = [("gather", True, "march"), ("gather", False, "march"),
          ("window", True, "march"), ("window", True, "firsthit")]


@pytest.mark.parametrize("impl,trace,trace_impl", TRACES)
@pytest.mark.parametrize("method", ["eulerFluidNet", "maccormackFluidNet"])
def test_advect_scalar3_matches_jax(fields, method, impl, trace,
                                    trace_impl):
    src, U, flags = fields["src"], fields["U"], fields["flags"]
    kw = dict(method=method, impl=impl, line_trace=trace,
              line_trace_impl=trace_impl, max_disp=1)
    want = np.asarray(jax.jit(lambda s, u, f: j_ops3d.advect_scalar3(
        DT, s, u, f, **kw))(src, U, flags))
    got = ops3d.advect_scalar3(DT, T(src), T(U), T(flags), **kw)
    tol = 1e-5 * np.abs(want).max() if trace_impl == "firsthit" else 1e-6
    close(got, want, tol)


@pytest.mark.parametrize("orig", [False, True])
@pytest.mark.parametrize("impl", ["gather", "window"])
@pytest.mark.parametrize("method", ["eulerFluidNet", "maccormackFluidNet"])
def test_advect_velocity3_matches_jax(fields, method, impl, orig):
    U, flags = fields["U"], fields["flags"]
    o = 0.5 * U[:, ::-1] if orig else None
    kw = dict(method=method, impl=impl, max_disp=1)
    want = np.asarray(jax.jit(lambda u, f, o: j_ops3d.advect_velocity3(
        DT, u, f, orig=o, **kw))(U, flags, o))
    got = ops3d.advect_velocity3(DT, T(U), T(flags),
                                 orig=None if o is None else T(o), **kw)
    close(got, want)


def test_step3_dispatch():
    """Which field each 3-D config advects on the torch engines (True)
    and which on kernels K, L and M (False): JAX's dispatch, viscosity's
    XLA path included."""
    cases = {
        (): (True, False),                                  # XLA march
        (("use_pallas", True),): (False, False),
        (("use_pallas", True), ("viscosity", 0.1)): (True, False),
        (("line_trace_impl", "firsthit"),): (False, False),
        (("line_trace", False),): (False, False),
        (("advection_impl", "gather"), ("use_pallas", True)): (True, True),
        (("advection_method", "eulerFluidNet"), ("use_pallas", True)):
            (True, True),
    }
    for kw, want in cases.items():
        assert torch_advection3(plume_config(**dict(kw))) == want, kw


def test_bench3d_xla_rows_on_cpu():
    """bench3d's "window (XLA)" and "gather" rows (``--xla``): the window
    row computes what kernels K and M compute, so its quality equals the
    classical row's; the gather row runs the torch engines and stays
    finite beside it."""
    args = bench3d.parse(["--res", "16", "--steps", "1", "--reps", "1",
                          "--xla", "--device", "cpu"])
    out, full, failures = bench3d.run_bench3d(args)
    rows = full["table"]
    assert list(rows) == ["jacobi60", "window_xla", "gather"]
    assert failures is None
    for col in ("max_div", "mean_div", "density_sum", "max_U"):
        assert rows["window_xla"][col] == rows["jacobi60"][col], col
        assert abs(rows["gather"][col] - rows["jacobi60"][col]) <= \
            0.05 * abs(rows["jacobi60"][col]), col
    assert all(r["launches_per_step"] == {} for r in rows.values())
    assert set(out["rows"]) == set(rows)
