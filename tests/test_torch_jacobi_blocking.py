"""The temporal blocking of kernels F (2-D) and I (3-D), held bit for bit to
the plain Jacobi solvers on the CPU.

``csrc/jacobi.cu`` runs up to kMaxSweeps sweeps a launch on a square tile
of cells: the output tile plus a kMaxSweeps-cell halo of p, the RHS and
the mask (zeros outside the grid), and writes back the output tile.
``csrc/jacobi3.cu`` marches each block along z over its segment of kSegZ
output planes plus k planes at each end, computing sweep s of plane t - s
at the step that loads plane t from sweep s-1's planes t-s-1, t-s, t-s+1,
and skips a sweep in the rows outside its shrinking band. The kernels run
only on the card, so here plain-torch twins of both schedules, with their
constants read from the CUDA sources, are held with ``torch.equal`` to
``ops/jacobi.py::solve_jacobi_fixed`` and ``ops/ops3d.py::
solve_jacobi_fixed3``. A twin reads NaN wherever the kernel reads memory
that holds no exact value (past the tile's edge, the shared planes before
their first write): a NaN that reached a written cell would fail the
comparison. The F twin also checks that the band that shrinks by one cell
a sweep holds no NaN. Cases: shapes that are
not multiples of the tile, b = 2, cold, warm and damped (2/3 in 2-D, 6/7
in 3-D) starts, sweep counts 1, k-1, k+1, 34 and 60, two multigrid levels
for F, several z segments for I. One case each holds a twin to the JAX
package's solver (1e-6 of max|p|: XLA adds in another order).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.ops import jacobi as j_jac
from fluidnet_cxx_tpu.ops import ops3d as j_ops3d
from fluidnet_cxx_tpu_torch.ops.jacobi import solve_jacobi_fixed
from fluidnet_cxx_tpu_torch.ops.multigrid import level_shapes
from fluidnet_cxx_tpu_torch.ops.ops3d import solve_jacobi_fixed3
from test_torch_ops3d import random_flags3

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "fluidnet_cxx_tpu_torch" / "csrc"
NAN = float("nan")


def _constant(text, pattern):
    return int(re.search(pattern, text).group(1))


def f_constants():
    """kMaxSweeps and the tile's side of csrc/jacobi.cu."""
    src = (CSRC / "jacobi.cu").read_text()
    return (_constant(src, r"constexpr int kMaxSweeps = (\d+);"),
            _constant(src, r"constexpr int kTile = (\d+);"))


def i_constants():
    """kTX, kTY, kMaxSweeps3 and kSegZ of csrc/jacobi3.cu."""
    src = (CSRC / "jacobi3.cu").read_text()
    return (_constant(src, r"constexpr int kTX = (\d+);"),
            _constant(src, r"constexpr int kTY = (\d+);"),
            _constant(src, r"constexpr int kMaxSweeps3 = (\d+);"),
            _constant(src, r"constexpr int kSegZ = (\d+);"))


def _axis(n_out, halo, side, n):
    """Cell index of every tile position along one axis, (tiles, side),
    and whether it lies on the grid."""
    tiles = -(-n // n_out)
    idx = (torch.arange(tiles)[:, None] * n_out - halo
           + torch.arange(side)[None, :])
    return idx, (idx >= 0) & (idx < n)


def _tiles(f, ys, in_y, xs, in_x, fill):
    """f (..., h, w) -> (..., ny, nx, TY, TX) with ``fill`` off the grid."""
    h, w = f.shape[-2:]
    g = f[..., ys.clamp(0, h - 1)[:, None, :, None],
          xs.clamp(0, w - 1)[None, :, None, :]]
    inside = in_y[:, None, :, None] & in_x[None, :, None, :]
    return torch.where(inside, g, torch.full((), fill, dtype=f.dtype))


def _inner(t, halo, h, w):
    """The output tiles of (..., ny, nx, TY, TX) laid out as (..., h, w)."""
    t = t[..., halo:t.shape[-2] - halo, halo:t.shape[-1] - halo]
    ny, nx, oy, ox = t.shape[-4:]
    t = t.transpose(-3, -2).reshape(t.shape[:-4] + (ny * oy, nx * ox))
    return t[..., :h, :w]


def _shift(t, dy, dx):
    """t[..., y + dy, x + dx] within each tile, NaN past its edge."""
    out = torch.full_like(t, NAN)
    ty, tx = t.shape[-2:]
    out[..., max(0, -dy):ty - max(0, dy), max(0, -dx):tx - max(0, dx)] = (
        t[..., max(0, dy):ty - max(0, -dy), max(0, dx):tx - max(0, -dx)])
    return out


def twin_f(flags, div, iters, p0=None, damping=1.0):
    """Plain-torch twin of the mask and tile launches of fn_jacobi_solve as
    ops/kernels/jacobi.py::solve_jacobi issues them."""
    k_max, lx = f_constants()
    ly = lx
    b, h, w = flags.shape
    ys, in_y = _axis(ly - 2 * k_max, k_max, ly, h)
    xs, in_x = _axis(lx - 2 * k_max, k_max, lx, w)
    ob = flags == 2
    inner = torch.zeros_like(ob)
    inner[:, 1:-1, 1:-1] = True
    cont = _tiles(inner & ~ob, ys, in_y, xs, in_x, False)
    # Obstacle neighbours of the cell: the mask byte's bits.
    nbr = {d: _tiles(torch.roll(ob, (-d[0], -d[1]), (1, 2)), ys, in_y, xs,
                     in_x, False) for d in ((0, -1), (0, 1), (-1, 0), (1, 0))}
    rhs = _tiles(div, ys, in_y, xs, in_x, 0.0)
    p = torch.zeros_like(div) if p0 is None else p0
    w_ = float(damping)
    done = 0
    while done < iters:
        k = min(k_max, iters - done)
        t = _tiles(p, ys, in_y, xs, in_x, 0.0)
        for s in range(1, k + 1):
            p1 = torch.where(nbr[0, -1], t, _shift(t, 0, -1))
            p2 = torch.where(nbr[0, 1], t, _shift(t, 0, 1))
            p3 = torch.where(nbr[-1, 0], t, _shift(t, -1, 0))
            p4 = torch.where(nbr[1, 0], t, _shift(t, 1, 0))
            upd = (p1 + p2 + p3 + p4 + rhs) * 0.25
            if w_ != 1.0:
                upd = (1.0 - w_) * t + w_ * upd
            t = torch.where(cont, upd, torch.zeros(()))
            # The exact band: [s, side - s) in each axis holds no NaN.
            assert not torch.isnan(t)[..., s:ly - s, s:lx - s].any()
        p = _inner(t, k_max, h, w)
        done += k
    return p


def twin_i(flags, div, iters, p0=None, damping=1.0, seg_z=None):
    """Plain-torch twin of fn_jacobi3_solve's z-marches (``seg_z``
    replaces kSegZ)."""
    tx_, ty_, k_max, seg = i_constants()
    seg = seg_z or seg
    b, d, h, w = flags.shape
    ys, in_y = _axis(ty_ - 2 * k_max, k_max, ty_, h)
    xs, in_x = _axis(tx_ - 2 * k_max, k_max, tx_, w)
    ob = flags == 2
    cnt = torch.zeros(flags.shape, dtype=torch.float32)
    for dz, dy, dx in ((0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0),
                       (-1, 0, 0), (1, 0, 0)):
        cnt = cnt + torch.roll(ob, (-dz, -dy, -dx), (1, 2, 3)).float()
    inner = torch.zeros_like(ob)
    inner[:, 1:-1, 1:-1, 1:-1] = True
    cm = _tiles(torch.where(inner & ~ob, cnt, torch.full((), -1.0)), ys,
                in_y, xs, in_x, -1.0)
    rhs = _tiles(div, ys, in_y, xs, in_x, 0.0)
    rows = torch.arange(ty_)[:, None]
    p = (torch.zeros_like(div) if p0 is None
         else torch.where(ob, torch.zeros(()), p0))
    w_ = float(damping)
    done = 0
    while done < iters:
        k = min(k_max, iters - done)
        src = _tiles(p, ys, in_y, xs, in_x, 0.0)
        out = torch.empty_like(div)
        zero = torch.zeros_like(src[:, 0])

        def plane(a, t, fill):
            return a[:, t] if 0 <= t < d else torch.full_like(zero, fill)

        for z0 in range(0, d, seg):
            z1, t0 = min(z0 + seg, d), z0 - k
            zm, zc, rr = [zero] * k, [zero] * k, [zero] * k
            cms = [torch.full_like(zero, -1.0)] * k
            shared = [torch.full_like(zero, NAN)] * k
            for t in range(t0, z1 + k):
                nv = [plane(src, t, 0.0)]
                for s in range(1, k + 1):
                    j = s - 1
                    band = ((rows >= k_max - k + s)
                            & (rows < ty_ - k_max + k - s))
                    c = shared[j]
                    acc = rr[j] + cms[j] * zc[j]
                    for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):
                        acc = acc + _shift(c, dy, dx)
                    acc = acc + zm[j]
                    acc = acc + nv[j]
                    upd = acc * (1.0 / 6.0)
                    if w_ != 1.0:
                        upd = (1.0 - w_) * zc[j] + w_ * upd
                    v = torch.where(cms[j] >= 0, upd, torch.zeros(()))
                    nv.append(torch.where(band, v, torch.zeros(())))
                if z0 <= t - k < z1:
                    out[:, t - k] = _inner(nv[k], k_max, h, w)
                shared = nv[:k]
                zm, zc = zc, nv[:k]
                rr = [plane(rhs, t, 0.0)] + rr[:-1]
                cms = [plane(cm, t, -1.0)] + cms[:-1]
        p = out
        done += k
    return p


@pytest.fixture(scope="module")
def system2():
    """Two samples of 37x70 with walls and 10% obstacles, a divergence RHS
    and a warm start."""
    rng = np.random.default_rng(11)
    flags = torch.from_numpy(random_flags(rng, 2, 37, 70, p_obstacle=0.1))
    div = torch.from_numpy(rng.standard_normal((2, 37, 70))
                           .astype(np.float32))
    p0 = torch.from_numpy(rng.standard_normal((2, 37, 70))
                          .astype(np.float32))
    return flags, div, p0


@pytest.fixture(scope="module")
def system3():
    """19x23x41 and two samples of 37x11x13 with the border shell and 8%
    obstacles, divergence RHS and warm starts."""
    rng = np.random.default_rng(12)
    out = {}
    for shape in ((1, 19, 23, 41), (2, 37, 11, 13)):
        flags = torch.from_numpy(random_flags3(rng, shape))
        div = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        p0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        out[shape] = (flags, div, p0)
    return out


K_F = f_constants()[0]
K_I = i_constants()[2]


def test_constants_follow_the_sources():
    """The regexes find the kernels' constants, and the wrappers' launch
    counts follow them."""
    k_max, side = f_constants()
    assert k_max >= 2 and side > 2 * k_max and side % 32 == 0
    tx_, ty_, k3, seg = i_constants()
    assert tx_ == 32 and ty_ > 2 * k3 and seg >= 1
    wrapper = (CSRC.parent / "ops" / "kernels" / "jacobi3.py").read_text()
    assert "fn_jacobi3_max_sweeps" in wrapper


@pytest.mark.parametrize("iters", [1, K_F - 1, K_F + 1, 34])
@pytest.mark.parametrize("start", ["cold", "warm", "damped"])
def test_f_twin_equals_plain(system2, start, iters):
    flags, div, p0 = system2
    kw = {"cold": {}, "warm": {"p0": p0},
          "damped": {"p0": p0, "damping": 2.0 / 3.0}}[start]
    assert torch.equal(twin_f(flags, div, iters, **kw),
                       solve_jacobi_fixed(flags, div, iters, **kw))


@pytest.mark.parametrize("shape", [(1, 3, 3), (2, 64, 32), (1, 130, 97)])
def test_f_twin_other_shapes(shape):
    """The smallest grid, chip_smoke's 64x32 step check at b = 2, and a
    grid of three tiles a side that are not multiples of the tile."""
    rng = np.random.default_rng(30 + shape[1])
    flags = torch.from_numpy(random_flags(rng, *shape, p_obstacle=0.1))
    div = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    p0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kw = dict(p0=p0, damping=2.0 / 3.0)
    assert torch.equal(twin_f(flags, div, K_F + 3, **kw),
                       solve_jacobi_fixed(flags, div, K_F + 3, **kw))


@pytest.mark.parametrize("level", [1, 2])
def test_f_twin_multigrid_level(level):
    """Levels of the 512x128 Rayleigh-Taylor box's hierarchy, smoothed as
    the V-cycle does (4 warm damped sweeps, 32 on the coarsest)."""
    h, w = level_shapes(512, 128)[level]
    rng = np.random.default_rng(20 + level)
    flags = torch.from_numpy(random_flags(rng, 1, h, w, p_obstacle=0.05))
    div = torch.from_numpy(rng.standard_normal((1, h, w)).astype(np.float32))
    p0 = torch.from_numpy(rng.standard_normal((1, h, w)).astype(np.float32))
    for iters in (4, 32):
        kw = dict(p0=p0, damping=2.0 / 3.0)
        assert torch.equal(twin_f(flags, div, iters, **kw),
                           solve_jacobi_fixed(flags, div, iters, **kw))


@pytest.mark.parametrize("iters", [1, K_I - 1, K_I + 1, 60])
@pytest.mark.parametrize("start", ["cold", "warm", "damped"])
def test_i_twin_equals_plain(system3, start, iters):
    flags, div, p0 = system3[(1, 19, 23, 41)]
    kw = {"cold": {}, "warm": {"p0": p0},
          "damped": {"p0": p0, "damping": 6.0 / 7.0}}[start]
    assert torch.equal(twin_i(flags, div, iters, **kw),
                       solve_jacobi_fixed3(flags, div, iters, **kw))


@pytest.mark.parametrize("seg_z", [None, 5, 1])
def test_i_twin_segments(system3, seg_z):
    """Two samples whose depth spans several z segments: the source's and
    shorter ones (5, and one plane a segment)."""
    flags, div, p0 = system3[(2, 37, 11, 13)]
    kw = dict(p0=p0, damping=6.0 / 7.0)
    assert torch.equal(twin_i(flags, div, 2 * K_I + 1, seg_z=seg_z, **kw),
                       solve_jacobi_fixed3(flags, div, 2 * K_I + 1, **kw))


def test_twins_match_jax(system2, system3):
    """Each twin against the JAX package's solver, damped and warm."""
    flags, div, p0 = system2
    want = np.asarray(j_jac.solve_jacobi_fixed(
        flags.numpy(), div.numpy(), 12, p0=p0.numpy(), damping=2.0 / 3.0))
    got = twin_f(flags, div, 12, p0=p0, damping=2.0 / 3.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    flags, div, p0 = system3[(1, 19, 23, 41)]
    want = np.asarray(j_ops3d.solve_jacobi_fixed3(
        flags.numpy(), div.numpy(), 7, p0=p0.numpy(), damping=6.0 / 7.0))
    got = twin_i(flags, div, 7, p0=p0, damping=6.0 / 7.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
