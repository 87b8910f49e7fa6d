"""The port's tensor ops (fluidnet_cxx_tpu_torch.ops) against the JAX
package's, on the CPU, from the same numpy inputs.

Tolerances: the stencils, source terms and Jacobi sweeps are the same
float32 operations in the same order, so they agree to 1e-6 absolute
(a few ulp at these magnitudes). The window samplers, the first-hit trace
and advection also follow the JAX operation order; they are held to 1e-5.
The windowed ops run at max_disp 1 here (the slice's max_disp 4 is covered
by tests/test_torch_kernels_ref.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.ops import advection as j_adv
from fluidnet_cxx_tpu.ops import jacobi as j_jac
from fluidnet_cxx_tpu.ops import line_trace as j_lt
from fluidnet_cxx_tpu.ops import source_terms as j_src
from fluidnet_cxx_tpu.ops import stencils as j_st
from fluidnet_cxx_tpu.ops import window as j_win
from fluidnet_cxx_tpu_torch.ops import advection as t_adv
from fluidnet_cxx_tpu_torch.ops import jacobi as t_jac
from fluidnet_cxx_tpu_torch.ops import line_trace as t_lt
from fluidnet_cxx_tpu_torch.ops import source_terms as t_src
from fluidnet_cxx_tpu_torch.ops import stencils as t_st
from fluidnet_cxx_tpu_torch.ops import window as t_win

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

B, H, W = 2, 20, 24
D = 1


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.fixture
def fields(rng):
    flags = random_flags(rng, B, H, W, p_obstacle=0.12, p_empty=0.05)
    U = (1.5 * rng.standard_normal((B, 2, H, W))).astype(np.float32)
    rho = rng.random((B, H, W)).astype(np.float32)
    p = rng.standard_normal((B, H, W)).astype(np.float32)
    return flags, U, rho, p


@pytest.mark.parametrize("name", ["velocity_divergence", "velocity_update",
                                  "set_wall_bcs", "flags_to_occupancy"])
def test_stencils_match_jax(fields, name):
    flags, U, _, p = fields
    args = {"velocity_divergence": (U, flags),
            "velocity_update": (p, U, flags),
            "set_wall_bcs": (U, flags),
            "flags_to_occupancy": (flags,)}[name]
    want = getattr(j_st, name)(*[jnp.asarray(a) for a in args])
    got = getattr(t_st, name)(*[T(a) for a in args])
    close(got, want, 1e-6)


def test_source_terms_match_jax(fields):
    flags, U, rho, _ = fields
    g = np.asarray([0.3, -0.7, 0.0], np.float32)
    want = j_src.add_buoyancy(jnp.asarray(U), jnp.asarray(flags),
                              jnp.asarray(rho), jnp.asarray(g), 0.1, 0.25)
    got = t_src.add_buoyancy(T(U), T(flags), T(rho), g, 0.1, 0.25)
    close(got, want, 1e-6)
    want = j_src.add_gravity(jnp.asarray(U), jnp.asarray(flags),
                             jnp.asarray(g), 0.25)
    got = t_src.add_gravity(T(U), T(flags), g, 0.25)
    close(got, want, 1e-6)


def _positions(rng, spread):
    xx = np.arange(W, dtype=np.float32)[None, None, :] + 0.5
    yy = np.arange(H, dtype=np.float32)[None, :, None] + 0.5
    centre = np.stack([np.broadcast_to(xx, (B, 1, H, W))[:, 0],
                       np.broadcast_to(yy, (B, 1, H, W))[:, 0]], axis=1)
    off = rng.uniform(-spread, spread, (B, 2, H, W)).astype(np.float32)
    return (centre + off).astype(np.float32)


def test_window_samplers_match_jax(rng, fields):
    flags, _, rho, _ = fields
    pos = _positions(rng, D + 1.5)   # some positions beyond the window
    want = j_win.interpol_window(jnp.asarray(rho), jnp.asarray(pos), D)
    got = t_win.interpol_window(T(rho), T(pos), D)
    close(got, want, 1e-5)
    want = j_win.interpol_with_fluid_window(
        jnp.asarray(rho), jnp.asarray(flags), jnp.asarray(pos), D)
    got = t_win.interpol_with_fluid_window(T(rho), T(flags), T(pos), D)
    close(got, want, 1e-5)


def test_line_trace_firsthit_matches_jax(rng, fields):
    flags, _, _, _ = fields
    start = _positions(rng, 0.0)
    delta = rng.uniform(-D, D, (B, 2, H, W)).astype(np.float32)
    want = j_lt.line_trace_firsthit(jnp.asarray(start), jnp.asarray(delta),
                                    jnp.asarray(flags), D)
    got = t_lt.line_trace_firsthit(T(start), T(delta), T(flags), D)
    close(got, want, 1e-5)


@pytest.mark.parametrize("line_trace", [False, True])
def test_advection_matches_jax(fields, line_trace):
    flags, U, rho, _ = fields
    kw = dict(maccormack_strength=0.6, max_disp=D)
    want = j_adv.advect_scalar(0.4, jnp.asarray(rho), jnp.asarray(U),
                               jnp.asarray(flags), line_trace=line_trace,
                               impl="window", line_trace_impl="firsthit",
                               **kw)
    got = t_adv.advect_scalar(0.4, T(rho), T(U), T(flags),
                              line_trace=line_trace, **kw)
    close(got, want, 1e-5)
    want = j_adv.advect_velocity(0.4, jnp.asarray(U), jnp.asarray(U),
                                 jnp.asarray(flags), impl="window", **kw)
    got = t_adv.advect_velocity(0.4, T(U), T(U), T(flags), **kw)
    close(got, want, 1e-5)


def test_jacobi_fixed_matches_jax(fields):
    flags, U, _, p = fields
    div = np.asarray(j_st.velocity_divergence(jnp.asarray(U),
                                              jnp.asarray(flags)))
    want = j_jac.solve_jacobi_fixed(jnp.asarray(flags), jnp.asarray(div), 12,
                                    p0=jnp.asarray(p), damping=2.0 / 3.0)
    got = t_jac.solve_jacobi_fixed(T(flags), T(div), 12, p0=T(p),
                                   damping=2.0 / 3.0)
    close(got, want, 1e-6)
