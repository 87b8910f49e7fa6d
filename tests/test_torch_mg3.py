"""The 3-D multigrid (``ops/multigrid.py::solve_mg3`` and its pieces), port
against the JAX package's ``ops/multigrid.py`` on the CPU from the same
numpy inputs, and its smoother's route: on a CPU tensor ``solve_mg3``'s
sweeps run kernel I's plain version (``ops3d.solve_jacobi_fixed3``), on a
CUDA tensor kernel I (``ops/kernels/jacobi3.py::solve_jacobi3``), which
chip_smoke.py holds to the plain version bit for bit on the card.

Tolerances: the operator, the restriction, the prolongation, the Neumann
extension and the coarse flags at 1e-6 of each output's largest magnitude
(the coarse flags exactly); ``solve_mg3`` at 1e-5 of its largest value
(the smoother adds in kernel I's order, JAX's XLA sweep in another, and
the compatibility projection and the gauge sum in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.ops import multigrid as j_mg
from fluidnet_cxx_tpu_torch.ops import multigrid as t_mg
from fluidnet_cxx_tpu_torch.ops.kernels import jacobi3
from test_torch_ops3d import random_flags3

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs without
    them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _inputs(seed, shape, p_obstacle=0.08):
    rng = np.random.default_rng(seed)
    flags = random_flags3(rng, shape, p_obstacle=p_obstacle, p_empty=0.03)
    a = rng.standard_normal(shape).astype(np.float32)
    return flags, a


@pytest.mark.parametrize("shape", [(1, 8, 12, 16), (2, 6, 10, 8)])
def test_pieces_match_jax(shape):
    """apply_A3, the residual, the coarse flags, the border fold and
    child-sum restriction, the trilinear prolongation and the Neumann
    extension of a coarse correction."""
    flags, a = _inputs(sum(shape), shape)
    rhs = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    tf, ta, tr = (torch.from_numpy(x) for x in (flags, a, rhs))
    flags, a, rhs = (jnp.asarray(x) for x in (flags, a, rhs))
    jit = jax.jit
    _close(t_mg.apply_A3(tf, ta), jit(j_mg.apply_A3)(flags, a), 1e-6)
    _close(t_mg._residual3(tf, tr, ta),
           jit(j_mg._residual3)(flags, rhs, a), 1e-6)
    cflags = np.array(jit(j_mg._coarsen_flags3)(flags))
    assert np.array_equal(t_mg._coarsen_flags3(tf).numpy(), cflags)
    _close(t_mg._restrict_sum3(ta), jit(j_mg._restrict_sum3)(a), 1e-6)
    b, d, h, w = shape
    coarse = np.array(a[:, :d // 2, :h // 2, :w // 2])
    _close(t_mg._prolong3(torch.from_numpy(coarse)),
           jit(j_mg._prolong3)(coarse), 1e-6)
    _close(t_mg._neumann_extend3(torch.from_numpy(cflags),
                                 torch.from_numpy(coarse)),
           jit(j_mg._neumann_extend3)(cflags, coarse), 1e-6)


@pytest.mark.parametrize("warm", [False, True])
def test_solve_mg3_matches_jax(warm):
    """Two V-cycles at 32^3 with 8% obstacles, three levels (32, 16, 8;
    max_levels 3), post 8 as the step runs it, cold and warm."""
    shape = (1, 32, 32, 32)
    flags, div = _inputs(7, shape)
    p0 = (np.random.default_rng(8).standard_normal(shape).astype(np.float32)
          if warm else None)
    kw = dict(n_vcycles=2, pre=4, post=8, coarse_iters=32, max_levels=3)
    assert len(t_mg._levels3(torch.from_numpy(flags), 8, 3)) == 3
    want = jax.jit(lambda f, r, p: j_mg.solve_mg3(f, r, p0=p, **kw))(
        flags, div, p0)
    got = t_mg.solve_mg3(torch.from_numpy(flags), torch.from_numpy(div),
                         p0=None if p0 is None else torch.from_numpy(p0),
                         **kw)
    _close(got, want, 1e-5)


def test_level_shapes_at_the_cylinders_size_fit_kernel_i():
    """The depth-capped hierarchy of the 32x128x384 cylinder is 16x64x192
    and 8x32x96 below the finest, and of the 128^3 plume 64^3 and 32^3;
    every level passes kernel I's gate (each side at least 3), and the
    levels match JAX's."""
    for shape, want in (((32, 128, 384), [(32, 128, 384), (16, 64, 192),
                                         (8, 32, 96)]),
                        ((128, 128, 128), [(128,) * 3, (64,) * 3,
                                           (32,) * 3])):
        got = t_mg.level_shapes3(*shape, 8, 3)
        assert got == want
        assert all(min(s) >= 3 for s in got)
        jlevels = jax.eval_shape(lambda f: j_mg._levels3(f, 8, 3),
                                 jax.ShapeDtypeStruct((1,) + shape,
                                                      jnp.int32))
        assert [tuple(f.shape[1:]) for f in jlevels] == want
    assert len(t_mg.level_shapes3(128, 128, 128, 8)) == 5   # no cap


def test_smoother_is_kernel_i_on_cpu_tensors():
    """solve_mg3's sweeps go through kernel I's wrapper, which on CPU
    tensors runs the plain version and launches nothing."""
    flags, div = _inputs(3, (1, 16, 16, 16))
    before = jacobi3.solve_jacobi3.launches
    calls = []
    assert t_mg.solve_jacobi3 is jacobi3.solve_jacobi3

    def spy(*a, **k):
        calls.append(a[2])
        return jacobi3.solve_jacobi3(*a, **k)

    t_mg.solve_jacobi3 = spy
    try:
        t_mg.solve_mg3(torch.from_numpy(flags), torch.from_numpy(div),
                       n_vcycles=1, post=8, max_levels=3)
    finally:
        t_mg.solve_jacobi3 = jacobi3.solve_jacobi3
    # 16^3 has two levels: pre 4, coarse 32, post 8.
    assert calls == [4, 32, 8]
    assert jacobi3.solve_jacobi3.launches == before
