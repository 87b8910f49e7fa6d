"""The launches of kernel C (the 2-D projection tail) on kernel F's tiles,
held bit for bit to its plain version on the CPU.

``csrc/jacobi.cu::fn_tail`` issues a whole tail from one C call: the
prologue (inlet BC on U, the RHS, p0 * scale, the mask byte, one thread a
cell), then ceil(iters / kMaxSweeps) launches of F's tile kernel, each
running up to kMaxSweeps damped sweeps on a kTile x kTile tile whose halo
is kMaxSweeps cells (on kTailRows-row strips, which change no value), and
the epilogue (velocity update, free-slip walls, inlet BC, one thread a
cell) from the last launch's p. The kernels run only on the card, so here
a plain-torch twin of that schedule, with the constants read from the
CUDA source, is held with ``torch.equal`` to
``ops/kernels/proj_tail.py::project_tail_plain``. The twin reads NaN
wherever the kernel reads a value that is not exact: past the tile's
edge, and after sweep s outside the band [s, kTile - s) in which the
tile's p is exact; the epilogue reads p at the cell, x - 1 and y - 1, and
a NaN there poisons U'. A NaN that reached an output fails the
comparison. Cases: 0, 1, 7, 8, 9 and 32 sweeps (each parity of the
ping-pong, a launch's last sweep and one past it), two samples, no scale,
no inlet, undamped, grids that are not multiples of the output tile and
one smaller than a tile, flags with obstacles and empty cells. One case
holds the twin to the JAX package's interpreted ``project_tail_pallas``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.ops.pallas.proj_tail_pallas import project_tail_pallas
from fluidnet_cxx_tpu_torch.celltype import EMPTY, FLUID, OBSTACLE
from fluidnet_cxx_tpu_torch.ops.common import border_mask, nb, where0
from fluidnet_cxx_tpu_torch.ops.kernels.proj_tail import project_tail_plain
from fluidnet_cxx_tpu_torch.ops.stencils import (set_wall_bcs,
                                                 velocity_divergence)
from test_torch_jacobi_blocking import _axis, _inner, _shift, _tiles

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "fluidnet_cxx_tpu_torch" / "csrc"
NAN = float("nan")


def constants():
    """kMaxSweeps, kTile and kTailRows of csrc/jacobi.cu."""
    src = (CSRC / "jacobi.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
                 for name in ("kMaxSweeps", "kTile", "kTailRows"))


K, SIDE, ROWS = constants()


def prologue(flags, U, p0, scale, U_bc, inv):
    """The prologue of every cell: U with the inlet BC, its RHS, p0 *
    scale."""
    if U_bc is not None:
        U = U * inv + U_bc
    if scale is not None:
        p0 = p0 * scale[:, None, None]
    return U, velocity_divergence(U, flags), p0


class Tiling:
    """The tiles of a launch (a K-cell halo): the mask's bits and the RHS
    laid out as (b, ny, nx, SIDE, SIDE), zero off the grid."""

    def __init__(self, flags, rhs):
        b, h, w = flags.shape
        self.h, self.w = h, w
        self.ys, self.in_y = _axis(SIDE - 2 * K, K, SIDE, h)
        self.xs, self.in_x = _axis(SIDE - 2 * K, K, SIDE, w)
        ob = flags == OBSTACLE
        inner = ~border_mask(h, w, 1)[None] & ~ob
        self.cont = self.tiles(inner, False)
        self.nbr = {d: self.tiles(torch.roll(ob, (-d[0], -d[1]), (1, 2)),
                                  False)
                    for d in ((0, -1), (0, 1), (-1, 0), (1, 0))}
        self.rhs = self.tiles(rhs, 0.0)

    def tiles(self, f, fill):
        return _tiles(f, self.ys, self.in_y, self.xs, self.in_x, fill)

    def sweeps(self, p, k, damping):
        """k sweeps of F's tile kernel from the global p (None: zeros):
        the tile, NaN outside the exact band after each sweep."""
        t = self.tiles(p, 0.0)
        for s in range(1, k + 1):
            p1 = torch.where(self.nbr[0, -1], t, _shift(t, 0, -1))
            p2 = torch.where(self.nbr[0, 1], t, _shift(t, 0, 1))
            p3 = torch.where(self.nbr[-1, 0], t, _shift(t, -1, 0))
            p4 = torch.where(self.nbr[1, 0], t, _shift(t, 1, 0))
            upd = (p1 + p2 + p3 + p4 + self.rhs) * 0.25
            if damping != 1.0:
                upd = (1.0 - damping) * t + damping * upd
            t = torch.where(self.cont, upd, torch.zeros(()))
            band = torch.full_like(t, NAN)
            band[..., s:SIDE - s, s:SIDE - s] = t[..., s:SIDE - s,
                                                  s:SIDE - s]
            t = band
        return t

    def inner(self, t):
        return _inner(t, K, self.h, self.w)


def velocity_out(flags, U, pc, pxm, pym, U_bc, inv):
    """The epilogue of every cell from the p each reads at the cell, x - 1
    and y - 1 (common.cuh::update_and_walls, then the inlet BC): an interior
    cell reads all three, so a NaN in any poisons its U'."""
    _, h, w = flags.shape
    u, v = U[:, 0], U[:, 1]
    fl, em = flags == FLUID, flags == EMPTY
    fl_xm, em_xm = nb(fl, 0, -1), nb(em, 0, -1)
    fl_ym, em_ym = nb(fl, -1, 0), nb(em, -1, 0)
    u_new = torch.where(fl & fl_xm, u - (pc - pxm), torch.where(
        fl & em_xm, u - pc, where0(em & fl_xm, u + pxm)))
    v_new = torch.where(fl & fl_ym, v - (pc - pym), torch.where(
        fl & em_ym, v - pc, where0(em & fl_ym, v + pym)))
    bad = torch.isnan(pc + pxm + pym)
    interior = ~border_mask(h, w, 1)
    out = [torch.where(interior, torch.where(bad, NAN, n), o)
           for n, o in ((u_new, u), (v_new, v))]
    U_out = set_wall_bcs(torch.stack(out, dim=1), flags)
    return U_out if U_bc is None else U_out * inv + U_bc


def twin_tail(flags, U, p0, iters, damping=2.0 / 3.0, scale=None,
              U_bc=None, inv=None):
    """Plain-torch twin of fn_tail's launches. Returns (p, U')."""
    U_in, rhs, p = prologue(flags, U, p0, scale, U_bc, inv)
    tiling = Tiling(flags, rhs)
    for done in range(0, iters, K):
        p = tiling.inner(tiling.sweeps(p, min(K, iters - done), damping))
        assert not torch.isnan(p).any()
    return p, velocity_out(flags, U_in, p, nb(p, 0, -1), nb(p, -1, 0), U_bc,
                           inv)


def inputs(seed, shape):
    """Flags with walls, 10% obstacles and 5% empty cells; U, p0, a scale
    and inlet fields (20% of the faces) from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    flags = random_flags(rng, b, h, w, p_obstacle=0.1, p_empty=0.05)
    U = rng.standard_normal((b, 2, h, w)).astype(np.float32)
    p0 = rng.standard_normal((b, h, w)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (b,)).astype(np.float32)
    bc = (rng.standard_normal((b, 2, h, w))
          * (rng.random((b, 2, h, w)) < 0.2)).astype(np.float32)
    inv = (bc == 0).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (flags, U, p0, scale, bc, inv))


def held(shape, iters, seed=0, damping=2.0 / 3.0, with_scale=True,
         with_inlet=True):
    flags, U, p0, scale, bc, inv = inputs(seed + sum(shape), shape)
    kw = dict(damping=damping, scale=scale if with_scale else None,
              U_bc=bc if with_inlet else None,
              U_bc_inv_mask=inv if with_inlet else None)
    want = project_tail_plain(flags, U, p0, iters, **kw)
    kw["inv"] = kw.pop("U_bc_inv_mask")
    got = twin_tail(flags, U, p0, iters, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("iters", [0, 1, K - 1, K, K + 1, 32])
def test_twin_equals_plain(iters):
    """Scale and inlet, on 70 x 100 (output tiles of 48 do not divide
    it)."""
    held((1, 70, 100), iters)


@pytest.mark.parametrize("case", ["b2", "bare", "undamped", "small"])
def test_twin_other_inputs(case):
    """Two samples (9 sweeps), neither scale nor inlet (3 sweeps), damping
    1 (17 sweeps), and a grid smaller than one tile (5 x 3, 32 sweeps)."""
    if case == "b2":
        held((2, 37, 53), K + 1)
    elif case == "bare":
        held((1, 50, 61), 3, with_scale=False, with_inlet=False)
    elif case == "undamped":
        held((1, 49, 47), 2 * K + 1, damping=1.0)
    else:
        held((1, 5, 3), 32)


def test_constants_follow_the_source():
    """The tile, the sweeps a launch and C's strips are the source's;
    fn_tail_launches counts the twin's launches (a prologue, the tile
    launches, an epilogue); the wrapper issues one C call and counts
    launches by that query."""
    assert SIDE % 32 == 0 and SIDE > 2 * K and SIDE % ROWS == 0
    assert SIDE * (SIDE // ROWS) <= 1024
    src = (CSRC / "jacobi.cu").read_text()
    assert "return (sweeps + kMaxSweeps - 1) / kMaxSweeps;" in src
    assert ("extern \"C\" int fn_tail_launches(int iters) { return 2 + "
            "launches_of(iters); }") in src
    assert "sweeps_of<kTailRows>(damped, init, rhs, mask" in src
    wrapper = (CSRC.parent / "ops" / "kernels" / "proj_tail.py").read_text()
    assert wrapper.count('_build.call("fn_tail"') == 1
    assert 'return _build.query("fn_tail_launches", iters)' in wrapper


def test_twin_matches_jax():
    """The twin against the interpreted TPU kernel, 12 sweeps with scale
    and inlet, within 1e-5 of each output's largest value (XLA adds in
    another order)."""
    flags, U, p0, scale, bc, inv = inputs(5, (1, 24, 56))
    want = project_tail_pallas(
        jnp.asarray(flags.numpy()), jnp.asarray(U.numpy()),
        jnp.asarray(p0.numpy()), 12, damping=2.0 / 3.0, interpret=True,
        scale=jnp.asarray(scale.numpy()), U_bc=jnp.asarray(bc.numpy()),
        U_bc_inv_mask=jnp.asarray(inv.numpy()))
    got = twin_tail(flags, U, p0, 12, scale=scale, U_bc=bc, inv=inv)
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w_).max()))
