"""Kernel J's plain version, ``project_tail3_plain``, against the JAX
package on the CPU: the interpreted Pallas kernel
(``project_tail3_pallas(..., interpret=True)``) and the XLA chain its
docstring names (divergence, warm damped Jacobi, velocity update, wall
BCs), with 10% obstacles and some empty cells, damping 2/3 and 6/7; and
the wrapper's CPU path.

Tolerance: 1e-6 of each output's largest value. The port's sweep adds in
the TPU kernel's float32 order, the XLA solver in another.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.ops import ops3d as jops3d
from fluidnet_cxx_tpu.ops.pallas.proj_tail3_pallas import \
    project_tail3_pallas
from fluidnet_cxx_tpu_torch.celltype import EMPTY, OBSTACLE
from fluidnet_cxx_tpu_torch.ops.kernels import proj_tail3
from fluidnet_cxx_tpu_torch.ops.ops3d import empty_domain3

torch.set_num_threads(1)


def _inputs(seed, b, d, h, w):
    """Flags with 10% obstacles and 5% empty cells inside the border
    shell, U and a warm start p0, from a numpy seed."""
    rng = np.random.default_rng(seed)
    flags = empty_domain3(b, d, h, w).numpy()
    r = rng.random(flags.shape)
    inner = flags != OBSTACLE
    flags[inner & (r < 0.10)] = OBSTACLE
    flags[inner & (r >= 0.10) & (r < 0.15)] = EMPTY
    U = np.clip(rng.standard_normal((b, 3, d, h, w)), -2, 2).astype(
        np.float32)
    p0 = rng.standard_normal((b, d, h, w)).astype(np.float32)
    return flags, U, p0


def _close(got, want):
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=0,
                                   atol=1e-6 * np.abs(w_).max())


@pytest.mark.parametrize("damping", [2.0 / 3.0, 6.0 / 7.0])
@pytest.mark.parametrize("iters", [16, 7])
def test_project_tail3_plain_matches_jax(damping, iters):
    """Against the interpreted TPU kernel and the unfused XLA chain."""
    flags, U, p0 = _inputs(0, 2, 8, 16, 12)
    got = proj_tail3.project_tail3_plain(
        torch.from_numpy(flags), torch.from_numpy(U), torch.from_numpy(p0),
        iters, damping)
    want = project_tail3_pallas(flags, U, p0, iters, damping=damping,
                                interpret=True)
    _close(got, want)
    div = jops3d.velocity_divergence3(U, flags)
    p = jops3d.solve_jacobi_fixed3(flags, div, iters, p0=p0,
                                   damping=damping)
    chain = (p, jops3d.set_wall_bcs3(jops3d.velocity_update3(p, U, flags),
                                     flags))
    _close(got, chain)


def test_project_tail3_zero_sweeps_keeps_the_warm_start():
    """No sweep: p is p0 zeroed on obstacles and border-shell cells keep
    it, as in the JAX chain; U' still gets the update and the walls."""
    flags, U, p0 = _inputs(1, 1, 6, 6, 6)
    p, U_new = proj_tail3.project_tail3_plain(
        torch.from_numpy(flags), torch.from_numpy(U), torch.from_numpy(p0),
        0, 2.0 / 3.0)
    np.testing.assert_array_equal(
        p.numpy(), np.where(flags == OBSTACLE, 0.0, p0))
    want = jops3d.set_wall_bcs3(jops3d.velocity_update3(
        jnp.where(flags == OBSTACLE, 0.0, p0), U, flags), flags)
    _close([U_new], [want])


def test_project_tail3_wrapper_on_cpu_runs_the_plain_version():
    """On CPU tensors the wrapper returns the plain chain and launches
    nothing."""
    flags, U, p0 = (torch.from_numpy(a) for a in _inputs(2, 1, 8, 8, 8))
    before = proj_tail3.project_tail3.launches
    got = proj_tail3.project_tail3(flags, U, p0, 5, 2.0 / 3.0)
    want = proj_tail3.project_tail3_plain(flags, U, p0, 5, 2.0 / 3.0)
    assert proj_tail3.project_tail3.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrapper_refuses_other_devices():
    """J's wrapper runs its plain version only for CPU tensors and
    launches its kernels only for CUDA tensors; any other device
    raises."""
    flags = torch.ones((1, 4, 4, 4), dtype=torch.int32, device="meta")
    U = torch.zeros((1, 3, 4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        proj_tail3.project_tail3(flags, U, torch.zeros((1, 4, 4, 4),
                                                       device="meta"), 2)
