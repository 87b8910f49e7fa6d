"""Kernel I's plain version, port against the JAX package on the CPU from
the same numpy inputs.

On a CPU tensor ``ops/kernels/jacobi3.py::solve_jacobi3`` runs its plain
version (``ops/ops3d.py::solve_jacobi_fixed3``); the CUDA kernel is held
to it bit for bit on the card by chip_smoke.py. Here the plain version is
held to the JAX package's XLA solver (``ops3d.solve_jacobi_fixed3``) and
to the TPU kernel ``solve_jacobi3_pallas`` in interpret mode (as
tests/test_pallas.py runs it): cold, warm from a ``p0`` that is not zero
on obstacles, and damped by 6/7.

Tolerance 1e-6 of max|p|: the plain version adds in the TPU kernel's
order (``cnt * p_c`` first, then the six neighbours), the XLA solver in
another.
"""
import jax
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.ops import ops3d as j_ops3d
from fluidnet_cxx_tpu_torch.ops.kernels.jacobi3 import solve_jacobi3
from fluidnet_cxx_tpu_torch.ops.ops3d import solve_jacobi_fixed3
from test_torch_ops3d import random_flags3

torch.set_num_threads(1)

CASES = {"cold": (40, None, 1.0), "warm": (25, "p0", 1.0),
         "damped": (25, "p0", 6.0 / 7.0)}


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def system():
    """Two samples of 8x16x12 with the border shell and 8% obstacles, a
    divergence RHS and a warm start that is non-zero everywhere."""
    rng = np.random.default_rng(3)
    flags = random_flags3(rng, (2, 8, 16, 12))
    U = rng.standard_normal((2, 3, 8, 16, 12)).astype(np.float32)
    div = np.asarray(j_ops3d.velocity_divergence3(U, flags))
    p0 = rng.standard_normal(div.shape).astype(np.float32)
    assert (p0[flags == 2] != 0).all()
    return flags, div, p0


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla(system, case):
    """The plain I == the JAX package's XLA solver."""
    flags, div, p0 = system
    iters, warm, damping = CASES[case]
    p0 = p0 if warm else None
    want = j_ops3d.solve_jacobi_fixed3(flags, div, iters, p0=p0,
                                       damping=damping)
    got = solve_jacobi_fixed3(T(flags), T(div), iters,
                              p0=None if p0 is None else T(p0),
                              damping=damping)
    _close(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(system, monkeypatch, case):
    """The plain I == solve_jacobi3_pallas (interpret mode), the kernel it
    replaces, and the wrapper on CPU tensors is the plain version."""
    from jax.experimental import pallas as pl

    from fluidnet_cxx_tpu.ops.pallas import jacobi3_pallas as jp3

    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    flags, div, p0 = system
    iters, warm, damping = CASES[case]
    p0 = p0 if warm else None
    want = jp3.solve_jacobi3_pallas(flags, div, iters, p0=p0,
                                    damping=damping)
    t_p0 = None if p0 is None else T(p0)
    got = solve_jacobi3(T(flags), T(div), iters, p0=t_p0, damping=damping)
    _close(got, want)
    assert torch.equal(got, solve_jacobi_fixed3(T(flags), T(div), iters,
                                                p0=t_p0, damping=damping))


def test_wrapper_refuses_other_devices():
    """I's wrapper runs its plain version only for CPU tensors and
    launches its kernel only for CUDA tensors; any other device raises."""
    flags = torch.ones((1, 4, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        solve_jacobi3(flags, torch.zeros((1, 4, 4, 4), device="meta"), 2)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs without
    them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)
