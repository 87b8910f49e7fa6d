"""Kernels K, L and M's plain versions, port against the JAX package on the
CPU from the same numpy inputs.

On CPU tensors the wrappers of ``ops/kernels/advect3.py`` run their plain
versions (the window engine of ``ops/ops3d.py``); the CUDA kernels are
held to them bit for bit on the card by chip_smoke.py. Here they are held
to the JAX package's XLA window path (``ops3d.advect_scalar3`` and
``advect_velocity3`` with ``impl="window"``), which tests/test_pallas.py
pins to the TPU kernels K, L and M in interpret mode: at D=2 without the
trace (displacements reach 2.4 cells, so the window clamp binds) and at
D=1 with the first-hit trace (the JAX trace graph at D=2 builds for
minutes here). Each JAX reference is computed once per module.

Tolerance 1e-5 absolute (the fields are of order 1): the plain versions
repeat the XLA path's float32 operations in its order; XLA's CPU compiler
may contract a multiply-add in a trilinear weight.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.ops import ops3d as j_ops3d
from fluidnet_cxx_tpu_torch.ops.kernels import advect3
from fluidnet_cxx_tpu_torch.run_plume3d import plume3d_case
from fluidnet_cxx_tpu_torch.sim import step3d
from test_torch_ops3d import random_flags3

torch.set_num_threads(1)

DT, STRENGTH = 0.8, 0.6


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs without
    them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module")
def inputs():
    """8x16x12 with the border shell and 8% obstacles; U up to 3 (2.4
    cells at dt 0.8); density in [0, 1)."""
    rng = np.random.default_rng(7)
    flags = random_flags3(rng, (1, 8, 16, 12))
    U = np.clip(1.5 * rng.standard_normal((1, 3, 8, 16, 12)), -3, 3
                ).astype(np.float32)
    rho = rng.random((1, 8, 16, 12)).astype(np.float32)
    return flags, U, rho


@pytest.fixture(scope="module")
def jax_refs(inputs):
    """The JAX window path's outputs, keyed (field, max_disp, trace)."""
    flags, U, rho = inputs

    def scalar(D, trace):
        return np.asarray(jax.jit(lambda r, u, f: j_ops3d.advect_scalar3(
            DT, r, u, f, STRENGTH, impl="window", max_disp=D,
            line_trace=trace, line_trace_impl="firsthit"))(rho, U, flags))

    def velocity(D):
        return np.asarray(jax.jit(lambda u, f: j_ops3d.advect_velocity3(
            DT, u, f, STRENGTH, impl="window", max_disp=D))(U, flags))

    return {("rho", 2, False): scalar(2, False),
            ("rho", 1, True): scalar(1, True),
            ("U", 2, False): velocity(2),
            ("U", 1, False): velocity(1)}


def close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("D,trace", [(2, False), (1, True)])
def test_scalar_matches_jax(inputs, jax_refs, D, trace):
    """K's plain version == the JAX window path."""
    flags, U, rho = inputs
    got = advect3.advect_scalar3(DT, T(rho), T(U), T(flags), STRENGTH,
                                 max_disp=D, line_trace=trace)
    close(got, jax_refs[("rho", D, trace)])
    if trace:   # the trace stops rays at obstacles: it changes the result
        plain = advect3.advect_scalar3(DT, T(rho), T(U), T(flags), STRENGTH,
                                       max_disp=D, line_trace=False)
        assert float((plain - got).abs().max()) > 1e-3


@pytest.mark.parametrize("D", [2, 1])
def test_velocity_matches_jax(inputs, jax_refs, D):
    """M's plain version == the JAX window path."""
    flags, U, _ = inputs
    got = advect3.advect_velocity3(DT, T(U), T(flags), STRENGTH, max_disp=D)
    close(got, jax_refs[("U", D, False)])


@pytest.mark.parametrize("D,trace", [(2, False), (1, True)])
def test_merged_equals_separate(inputs, jax_refs, D, trace):
    """L's plain version == (K, M) exactly, and so == the JAX path."""
    flags, U, rho = inputs
    args = (DT, T(rho), T(U), T(flags), STRENGTH)
    rho_l, U_l = advect3.advect_all3(*args, max_disp=D, line_trace=trace)
    assert torch.equal(rho_l, advect3.advect_scalar3(*args, max_disp=D,
                                                     line_trace=trace))
    assert torch.equal(U_l, advect3.advect_velocity3(
        DT, T(U), T(flags), STRENGTH, max_disp=D))
    close(rho_l, jax_refs[("rho", D, trace)])
    close(U_l, jax_refs[("U", D, False)])


def test_max_disp_past_two_warns_once(monkeypatch):
    """A config asking for max_disp > 2 warns once per process (the 3-D
    window clamps at 2) and runs with the bound 2."""
    monkeypatch.setattr(step3d, "_warned_max_disp", False)
    cfg, state = plume3d_case(6, device="cpu", jacobi_iter=2)
    with pytest.warns(UserWarning, match="max_disp=4") as seen:
        cfg4 = dataclasses.replace(cfg, max_disp=4)
        s4 = step3d.simulate_step3(cfg4, step3d.simulate_step3(cfg4, state))
    assert len([w for w in seen if "max_disp" in str(w.message)]) == 1
    s2 = step3d.simulate_step3(cfg, step3d.simulate_step3(cfg, state))
    assert torch.equal(s4.U, s2.U) and torch.equal(s4.density, s2.density)


@pytest.mark.parametrize("kernel", ["advect_scalar3", "advect_all3",
                                    "advect_velocity3"])
def test_wrappers_refuse_other_devices(kernel):
    """K's, L's and M's wrappers run their plain versions only for CPU
    tensors and launch their kernels only for CUDA tensors; any other
    device raises."""
    meta = dict(device="meta")
    flags = torch.ones((1, 4, 4, 4), dtype=torch.int32, **meta)
    U = torch.zeros((1, 3, 4, 4, 4), **meta)
    rho = torch.zeros((1, 4, 4, 4), **meta)
    with pytest.raises(ValueError, match="device"):
        if kernel == "advect_velocity3":
            advect3.advect_velocity3(0.1, U, flags)
        else:
            getattr(advect3, kernel)(0.1, rho, U, flags)
