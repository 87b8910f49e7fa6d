"""The halo exchange and the width-sharded Jacobi solves
(``fluidnet_cxx_tpu_torch/parallel/halo.py``) on four gloo ranks on the
CPU (one spawn for the module, ``tests/torch_parallel_ranks.py::
halo_ranks``), on the 1x4 mesh (sx = 4) and the 2x2 mesh (sx = 2, each dp
row its batch entry):

* ``pad_columns`` at reaches 1, 3, 9 and 20 (20 is wider than a 16-column
  slab: two hops) equal to the global array's columns around each slab,
  clipped at the domain's edges, for int32 flags and a float32 velocity;
* ``solve_jacobi_sharded`` at 0, 5, 8, 17 and 34 sweeps on 2x24x64 flags
  with 10% random obstacles and obstacles on both sides of every slab cut,
  bit-equal (torch.equal) to the single-device ``solve_jacobi`` on the
  whole grid, within 1e-5 of JAX's ``ops.solve_jacobi_fixed`` (the
  tolerance of ``tests/test_parallel.py``), with one exchange of flags and
  div, one of p before every F call but the first and ceil(iters / 8) F
  calls;
* ``solve_jacobi3_sharded`` at 4, 9 and 20 sweeps on 2x8x10x32 flags,
  bit-equal to ``solve_jacobi3`` and within 1e-5 of JAX's
  ``ops3d.solve_jacobi_fixed3``;
* the early exit at p_tol 1.078 (41 sweeps): the same sweep count, so
  the same p to the bit, as ``ops/jacobi.py::solve_jacobi``, and its
  residual within 1e-5 relative (the sums run in another order).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from conftest import random_flags
from fluidnet_cxx_tpu import ops as j_ops
from fluidnet_cxx_tpu.ops import ops3d as j_ops3d
from fluidnet_cxx_tpu_torch.ops.jacobi import solve_jacobi as solve_tol
from fluidnet_cxx_tpu_torch.ops.kernels.jacobi import solve_jacobi
from fluidnet_cxx_tpu_torch.ops.kernels.jacobi3 import solve_jacobi3
from fluidnet_cxx_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)
MESHES = ranks.MESHES[:2]
ITERS = (0, 5, 8, 17, 34)
ITERS3 = (4, 9, 20)
# Crossed at the 41st sweep, half a percent from the residuals on each side
# of it.
P_TOL = 1.078


def _inputs(rng):
    flags = random_flags(rng, 2, 24, 64, p_obstacle=0.1)
    for cut in (16, 32, 48):
        flags[:, 3:20:4, cut - 1] = 2
        flags[:, 5:20:4, cut] = 2
    U = rng.standard_normal((2, 2, 24, 64)).astype(np.float32)
    div = np.asarray(j_ops.velocity_divergence(U, flags))
    flags3 = np.full((2, 8, 10, 32), 1, np.int32)
    flags3[:, [0, -1]] = 2
    flags3[:, :, [0, -1]] = 2
    flags3[..., [0, -1]] = 2
    inner = flags3[:, 1:-1, 1:-1, 1:-1]
    inner[rng.random(inner.shape) < 0.1] = 2
    flags3[:, 3, 4, 15:17] = 2
    div3 = rng.standard_normal((2, 8, 10, 32)).astype(np.float32)
    return dict(flags=flags, U=U, div=div, flags3=flags3, div3=div3)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("halo")
    x = _inputs(np.random.default_rng(0))
    np.savez(d / "inputs.npz", **x)
    spawn(ranks.halo_ranks, ranks.WORLD, (str(d),), timeout_s=45, join_s=60)
    return x, [dict(np.load(d / f"halo_r{r}.npz"))
               for r in range(ranks.WORLD)]


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("g", (1, 3, 9, 20))
@pytest.mark.parametrize("dp,sx", MESHES)
def test_pad_columns_holds_the_neighbours(run, dp, sx, g):
    x, outs = run
    w = x["flags"].shape[-1]
    wl = w // sx
    for r, out in enumerate(outs):
        i, j = divmod(r, sx)
        b = slice(i * (2 // dp), (i + 1) * (2 // dp))
        lo, hi = max(0, j * wl - g), min(w, (j + 1) * wl + g)
        assert tuple(out[f"{dp}x{sx}_pad{g}"]) == (j * wl - lo,
                                                   hi - (j + 1) * wl)
        np.testing.assert_array_equal(out[f"{dp}x{sx}_pad{g}_flags"],
                                      x["flags"][b, :, lo:hi])
        np.testing.assert_array_equal(out[f"{dp}x{sx}_pad{g}_U"],
                                      x["U"][b, ..., lo:hi])


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("dp,sx", MESHES)
def test_sharded_jacobi_is_the_single_device_solve(run, dp, sx, iters):
    x, outs = run
    want = solve_jacobi(T(x["flags"]), T(x["div"]), iters)
    jax_want = np.asarray(j_ops.solve_jacobi_fixed(
        jnp.asarray(x["flags"]), jnp.asarray(x["div"]), iters))
    launches = math.ceil(iters / 8)
    for out in outs:
        got = T(out[f"{dp}x{sx}_jac{iters}"])
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), jax_want, rtol=0, atol=1e-5)
        assert tuple(out[f"{dp}x{sx}_jac{iters}_counts"]) == (
            1 + max(launches - 1, 0), launches)
    assert iters == 0 or float(want.abs().max()) > 0.1


@pytest.mark.parametrize("iters", ITERS3)
@pytest.mark.parametrize("dp,sx", MESHES)
def test_sharded_jacobi3_is_the_single_device_solve(run, dp, sx, iters):
    x, outs = run
    want = solve_jacobi3(T(x["flags3"]), T(x["div3"]), iters)
    jax_want = np.asarray(j_ops3d.solve_jacobi_fixed3(
        jnp.asarray(x["flags3"]), jnp.asarray(x["div3"]), iters))
    for out in outs:
        got = T(out[f"{dp}x{sx}_jac3_{iters}"])
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), jax_want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dp,sx", MESHES)
def test_sharded_early_exit_is_the_single_device_solve(run, dp, sx):
    x, outs = run
    want, res = solve_tol(T(x["flags"]), T(x["div"]), P_TOL, 300)
    for out in outs:
        assert torch.equal(T(out[f"{dp}x{sx}_tol"]), want)
        assert float(out[f"{dp}x{sx}_tol_res"]) == pytest.approx(
            float(res), rel=1e-5)
    assert float(res) < P_TOL
