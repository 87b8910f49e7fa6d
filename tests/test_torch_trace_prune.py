"""The pruned walk of kernels A and D's first-hit trace, held bit for bit
to the full window walk on the CPU.

``csrc/advect_all.cu::trace`` traces a ray from a cell centre over the
box of ``ops/line_trace.py::firsthit_box2`` only (per axis [0, floor(0.5
+ disp + slack)] or [floor(0.5 + disp - slack), 0]), reads one flag a
cell of that box and runs the slab tests for its blocked cells alone; a
ray whose box holds no blocked cell keeps t = min(border t, len). The
kernel runs only on the card, so here a plain-torch twin of that walk
(the box, the skip of rays with nothing blocked in reach, the border
planes only for a box that reaches past the grid, the reciprocals taken
once a ray, the slab's upper face (lo + 1) + 2e-5) is held with
``torch.equal`` to ``line_trace_firsthit``, the full (2D+1)^2 walk that
is the kernel's plain version: D = 1-4; flags with the border shell
only, with 8% and with 30% obstacles, and with 8% obstacles and no shell
(rays reach the margin planes); random displacements (a third of the
components clipped to exactly +-D), axis-aligned rays, zero and
near-zero lengths, and rays whose end lands within 1e-5 (and within the
box's margin) of a blocked cell's expanded face; and a grid 8000 cells
wide, the cylinder's, where the slack is tried at large coordinates. One
case holds the twin to the JAX package's ``line_trace_firsthit`` at D =
1: bit for bit does not hold there (XLA's CPU compiler contracts
multiply-adds, and torch's float32 sqrt on the CPU may differ from a
correctly rounded one in the last bit), so each position within 1e-6 of
its value (a few float32 ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.ops import line_trace as j_line_trace
from fluidnet_cxx_tpu_torch.celltype import FLUID
from fluidnet_cxx_tpu_torch.ops.common import F32, cell_index_grid
from fluidnet_cxx_tpu_torch.ops.line_trace import (EPSILON, HIT_MARGIN,
                                                   firsthit_box2,
                                                   firsthit_slack2,
                                                   line_trace_firsthit)

torch.set_num_threads(1)

SHAPE = (2, 14, 19)
BIG = 3e38


def _slab(p0, ok, inv, cell):
    """The kernel's ``slabs``: entry and exit of the ray against the
    expanded slab of integer coordinate ``cell``, with inv = 1 / (ok ? dir
    : 1) taken once a ray and the upper face (lo + 1) + 2e-5."""
    lo = cell.to(F32) - HIT_MARGIN
    hi = (lo + 1.0) + 2.0 * HIT_MARGIN
    t1 = (lo - p0) * inv
    t2 = (hi - p0) * inv
    inside = (p0 >= lo) & (p0 <= hi)
    big = torch.full((), BIG, dtype=F32)
    t_lo = torch.where(ok, torch.minimum(t1, t2),
                       torch.where(inside, -big, big))
    t_hi = torch.where(ok, torch.maximum(t1, t2),
                       torch.where(inside, big, -big))
    return t_lo, t_hi


def _border_t(p0, ok, inv, dim):
    big = torch.full((), BIG, dtype=F32)
    t1 = (HIT_MARGIN - p0) * inv
    t2 = (dim - HIT_MARGIN - p0) * inv
    t1 = torch.where(ok & (t1 >= 0), t1, big)
    t2 = torch.where(ok & (t2 >= 0), t2, big)
    return torch.minimum(t1, t2)


def pruned_walk(xx, yy, dx, dy, h, w, D, fluid_at):
    """Plain-torch twin of the kernel's ``trace`` for rays from the
    centres of cells (xx, yy) (int32 tensors of any shape) along (dx, dy),
    already clipped to +-D, on an h x w grid. ``fluid_at(X, Y)`` returns
    the fluid test of cells (X, Y) and a poison tensor (NaN where the
    kernel would read a flag it does not hold, else 0), added to t where
    the walk reads that flag. Returns the traced (x, y), which rays walked
    (a blocked cell in their box) and the box offsets each ray visited
    (its own cell left out)."""
    cx, cy = xx.to(F32) + 0.5, yy.to(F32) + 0.5
    length = torch.sqrt(dx * dx + dy * dy)
    can = length > EPSILON
    inv_len = 1.0 / torch.clamp(length, min=EPSILON)
    dirx, diry = dx * inv_len, dy * inv_len
    okx, oky = dirx.abs() > EPSILON, diry.abs() > EPSILON
    invx = 1.0 / torch.where(okx, dirx, torch.ones_like(dirx))
    invy = 1.0 / torch.where(oky, diry, torch.ones_like(diry))
    delta = torch.stack([dx, dy], dim=1)
    (xl, xh), (yl, yh) = firsthit_box2(delta, D, firsthit_slack2((h, w), D))
    # A box inside the grid cannot reach the border planes: t_stop = len.
    edge = ((xx + xl < 0) | (xx + xh >= w) | (yy + yl < 0)
            | (yy + yh >= h))
    t_border = torch.minimum(_border_t(cx, okx, invx, w),
                             _border_t(cy, oky, invy, h))
    t_stop = torch.where(edge, torch.minimum(t_border, length), length)
    walked = torch.zeros_like(can)
    t_walk = t_stop.clone()
    poison = torch.zeros_like(t_stop)
    for oy in range(-D, D + 1):
        for ox in range(-D, D + 1):
            X, Y = xx + ox, yy + oy
            # The box, clipped to the grid.
            in_box = ((xl <= ox) & (ox <= xh) & (yl <= oy) & (oy <= yh)
                      & (X >= 0) & (X < w) & (Y >= 0) & (Y < h) & can)
            fl, bad = fluid_at(X.clamp(0, w - 1), Y.clamp(0, h - 1))
            poison = poison + torch.where(in_box, bad, 0.0)
            test = in_box & ~fl
            walked |= test
            txl, txh = _slab(cx, okx, invx, X)
            tyl, tyh = _slab(cy, oky, invy, Y)
            t_in = torch.maximum(txl, tyl)
            t_out = torch.minimum(txh, tyh)
            hit = test & (t_in <= t_out) & (t_in >= 0)
            t_walk = torch.where(hit, torch.minimum(t_walk, t_in), t_walk)
    # The skip: a ray with nothing blocked in its box keeps t_stop.
    t = torch.clamp(torch.where(walked, t_walk, t_stop), min=0.0) + poison
    bx = torch.where(can, cx + t * dirx, cx)
    by = torch.where(can, cy + t * diry, cy)
    visited = (xh - xl + 1) * (yh - yl + 1) - 1
    return bx, by, walked & can, visited


def pruned_firsthit2(delta, flags, D):
    """The walk from every fluid cell centre of ``flags`` (b, h, w) along
    ``delta`` (b, 2, h, w); other cells keep their centre. Returns the
    traced positions (b, 2, h, w), which rays walked and the mean box
    offsets a ray visited."""
    b, h, w = flags.shape
    xx, yy = cell_index_grid(b, h, w)
    fluid = flags == FLUID
    bi = torch.arange(b).view(-1, 1, 1)

    def fluid_at(X, Y):
        return fluid[bi, Y, X], torch.zeros(X.shape, dtype=F32)

    bx, by, walked, visited = pruned_walk(xx, yy, delta[:, 0], delta[:, 1],
                                          h, w, D, fluid_at)
    pos = torch.stack([xx.to(F32) + 0.5, yy.to(F32) + 0.5], dim=1)
    traced = torch.stack([bx, by], dim=1)
    ray = fluid & (delta.square().sum(1).sqrt() > EPSILON)
    mean_visited = float(visited[ray].float().mean()) if ray.any() else 0.0
    return (torch.where(fluid[:, None], traced, pos), walked & fluid,
            mean_visited)


def _flags(rng, obstacles, shape):
    """Border shell and random obstacles; ``open``: 8% obstacles and no
    shell, so that rays reach the domain's margin planes."""
    if obstacles == "open":
        return np.where(rng.random(shape) < 0.08, 2, 1).astype(np.int32)
    return random_flags(rng, *shape, p_obstacle=OBSTACLES[obstacles])


def _random_rays(rng, shape, flags, D):
    """Uniform in [-1.6D, 1.6D] per component: about a third clipped to
    exactly +-D."""
    return 1.6 * D * (2.0 * rng.random((shape[0], 2) + shape[1:]) - 1.0)


def _axis_rays(rng, shape, flags, D):
    """One non-zero component from {+-0.25, +-0.5, +-1, +-1.5, +-D} or
    uniform, the other exactly 0."""
    mags = np.array([0.25, 0.5, 1.0, 1.5, D, 0.0], np.float64)
    pick = rng.integers(0, len(mags), shape)
    mag = np.where(pick == len(mags) - 1, rng.random(shape) * D, mags[pick])
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    axis = rng.integers(0, 2, shape)
    out = np.zeros((shape[0], 2) + shape[1:])
    for c in range(2):
        out[:, c] = np.where(axis == c, sign * mag, 0.0)
    return out


def _zero_rays(rng, shape, flags, D):
    """Zero displacements and lengths around the 1e-12 cut-off."""
    scales = np.array([0.0, 0.0, 1e-13, 5e-13, 1e-12, 2e-12, 1e-9, 1e-6])
    s = scales[rng.integers(0, len(scales), (shape[0], 1) + shape[1:])]
    return s * (2.0 * rng.random((shape[0], 2) + shape[1:]) - 1.0)


def _face_rays(rng, shape, flags, D):
    """Rays from each cell centre to a random point of a blocked cell's
    expanded box in the window (any cell where none is blocked), with one
    axis's end snapped to the near face (x - 1e-5 or x + 1 + 1e-5) plus an
    offset of 0, +-1e-6 .. +-2e-5, or +-1e-4, +-3e-4 (about the box's
    margin)."""
    b, h, w = shape
    f = torch.from_numpy(flags)
    blocked = torch.nn.functional.pad((f != FLUID).double(), (D,) * 4)
    best = torch.full(shape, -1.0, dtype=torch.float64)
    target = torch.zeros((2,) + shape, dtype=torch.float64)
    noise = torch.from_numpy(rng.random((2 * D + 1,) * 2 + shape))
    for iy, oy in enumerate(range(-D, D + 1)):
        for ix, ox in enumerate(range(-D, D + 1)):
            if ox == oy == 0:
                continue
            nb = blocked[:, D + oy:D + oy + h, D + ox:D + ox + w]
            score = noise[iy, ix] + nb
            take = score > best
            best = torch.where(take, score, best)
            for c, o in enumerate((ox, oy)):
                target[c] = torch.where(take, float(o), target[c])
    target = target.numpy().transpose(1, 0, 2, 3)
    eps = np.array([0.0, 1e-6, -1e-6, 5e-6, -5e-6, 1e-5, -1e-5, 2e-5, -2e-5,
                    1e-4, -1e-4, 3e-4, -3e-4])
    # Offset of the end from the ray's cell origin: inside the target cell,
    # then one axis onto the expanded face that faces the ray.
    end = target + rng.random(target.shape)
    axis = rng.integers(0, 2, shape)
    face = np.where(target > 0, -HIT_MARGIN,
                    np.where(target < 0, 1.0 + HIT_MARGIN,
                             np.where(rng.random(target.shape) < 0.5,
                                      -HIT_MARGIN, 1.0 + HIT_MARGIN)))
    snapped = target + face + eps[rng.integers(0, len(eps), target.shape)]
    for c in range(2):
        end[:, c] = np.where(axis == c, snapped[:, c], end[:, c])
    return end - 0.5


RAYS = {"random": _random_rays, "axis": _axis_rays, "zero": _zero_rays,
        "faces": _face_rays}
OBSTACLES = {"border": 0.0, "8pct": 0.08, "30pct": 0.3, "open": None}


def _case(D, obstacles, rays, seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    flags = _flags(rng, obstacles, shape)
    raw = RAYS[rays](rng, shape, flags, D).astype(np.float32)
    delta = torch.clamp(torch.from_numpy(raw), -D, D)
    return torch.from_numpy(flags), delta


def _check(flags, delta, D, rays):
    b, h, w = flags.shape
    xx, yy = cell_index_grid(b, h, w)
    pos = torch.stack([xx.to(F32) + 0.5, yy.to(F32) + 0.5], dim=1)
    want = line_trace_firsthit(pos, delta, flags, D)
    got, walked, visited = pruned_firsthit2(delta, flags, D)
    assert torch.equal(got, want)
    if rays != "zero":
        assert visited < (2 * D + 1) ** 2 - 1
        # Rays that moved to a stop short of their full length walked.
        moved = (flags == FLUID) & (got != pos + delta).any(1)
        assert bool(walked.any()) or not bool(moved.any())


@pytest.mark.parametrize("rays", list(RAYS))
@pytest.mark.parametrize("obstacles", list(OBSTACLES))
@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_pruned_walk_is_the_full_walk(D, obstacles, rays):
    """The twin of the kernel's pruned walk gives the full walk's
    positions bit for bit, and visits fewer offsets than the window."""
    seed = 100 * D + 10 * list(OBSTACLES).index(obstacles) \
        + list(RAYS).index(rays)
    flags, delta = _case(D, obstacles, rays, seed)
    _check(flags, delta, D, rays)


@pytest.mark.parametrize("rays", ["random", "faces"])
def test_pruned_walk_8000_wide(rays):
    """A band of rows 8000 cells wide (the cylinder's width), 8%
    obstacles, D = 4: the slack holds where x - 1e-5 rounds to x."""
    flags, delta = _case(4, "8pct", rays, 31 + len(rays), (1, 6, 8000))
    _check(flags, delta, 4, rays)


def test_pruned_walk_matches_jax():
    """The twin against the JAX package's first-hit trace at D = 1, from
    the same numpy inputs."""
    D = 1
    flags, delta = _case(D, "30pct", "random", 7)
    b, h, w = flags.shape
    xx, yy = cell_index_grid(b, h, w)
    pos = torch.stack([xx.to(F32) + 0.5, yy.to(F32) + 0.5], dim=1)
    got, _, _ = pruned_firsthit2(delta, flags, D)
    want = np.asarray(jax.jit(
        lambda p, dl, f: j_line_trace.line_trace_firsthit(p, dl, f, D))(
            jnp.asarray(pos.numpy()), jnp.asarray(delta.numpy()),
            jnp.asarray(flags.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
