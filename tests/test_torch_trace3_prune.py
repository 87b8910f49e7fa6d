"""The pruned walk of kernels K and L's first-hit trace, held bit for bit
to the full window walk on the CPU.

``csrc/advect3.cu::trace3`` traces a ray from a cell centre over the box
of ``ops/line_trace3.py::firsthit_box3`` only (per axis [0, floor(0.5 +
disp + slack)] or [floor(0.5 + disp - slack), 0]), reads one flag a cell
of that box and runs the slab tests for its blocked cells alone; a ray
whose box holds no blocked cell keeps t = min(border t, len). The
kernel runs only on the card, so here a plain-torch twin of that walk
(the box, the skip of rays with nothing blocked in reach, the border
planes only for a box that reaches past the grid, the reciprocals taken
once a ray) is held with ``torch.equal`` to ``line_trace_firsthit3``, the
full (2D+1)^3 walk that is the kernel's plain version: D = 1, 2, 3; flags
with the border shell only, with 8% and with 30% obstacles, and with 8%
obstacles and no shell (rays reach the margin planes); random
displacements (a third of the components
clipped to exactly +-D), axis-aligned rays, zero and near-zero lengths,
and rays whose end lands within 1e-5 (and within the box's margin) of a
blocked cell's expanded face. One case holds the twin to the JAX
package's ``line_trace_firsthit3`` at D = 1 (its trace graph at D = 2
builds for minutes here), each position to within 1e-6 of its value (a
few float32 ulps): XLA's CPU compiler contracts multiply-adds, and
torch's float32 sqrt on the CPU may differ from a correctly rounded one
in the last bit (the kernel's sqrtf is correctly rounded, as torch's is
on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.ops import line_trace3 as j_line_trace3
from fluidnet_cxx_tpu_torch.celltype import FLUID
from fluidnet_cxx_tpu_torch.ops.common import F32
from fluidnet_cxx_tpu_torch.ops.line_trace import EPSILON, HIT_MARGIN
from fluidnet_cxx_tpu_torch.ops.line_trace3 import (EXTENT, firsthit_box3,
                                                    firsthit_slack3,
                                                    line_trace_firsthit3)
from fluidnet_cxx_tpu_torch.ops.ops3d import centers3, index_grids3
from test_torch_ops3d import random_flags3

torch.set_num_threads(1)

SHAPE = (2, 9, 12, 16)
BIG = 3e38


def _slab(p0, ok, inv, cell):
    """The kernel's ``slabs``: entry and exit of the ray against the
    expanded slab of integer coordinate ``cell``, with inv = 1 / (ok ? dir
    : 1) taken once a ray."""
    lo = cell.to(F32) - HIT_MARGIN
    hi = lo + EXTENT
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


def pruned_firsthit3(delta, flags, D):
    """Plain-torch twin of the kernel's trace from every cell centre
    along ``delta`` (b, 3, d, h, w), already clipped to +-D. Returns the
    traced positions, which rays walked (a blocked cell in their box) and
    the mean box offsets a ray visited (its own cell left out)."""
    b, d, h, w = flags.shape
    pos = centers3(b, d, h, w, flags.device)
    zz, yy, xx = index_grids3(b, d, h, w, flags.device)
    p = [pos[:, c] for c in range(3)]
    dx, dy, dz = delta[:, 0], delta[:, 1], delta[:, 2]
    length = torch.sqrt(dx * dx + dy * dy + dz * dz)
    can = (length > EPSILON) & (flags == FLUID)
    inv_len = 1.0 / torch.clamp(length, min=EPSILON)
    dirs = [dx * inv_len, dy * inv_len, dz * inv_len]
    oks = [dc.abs() > EPSILON for dc in dirs]
    invs = [1.0 / torch.where(ok, dc, torch.ones_like(dc))
            for ok, dc in zip(oks, dirs)]
    box = firsthit_box3(delta, D, firsthit_slack3((d, h, w), D))
    # A box inside the grid cannot reach the border planes: t_stop = len.
    edge = torch.zeros_like(can)
    for (lo, hi), ii, dim in zip(box, (xx, yy, zz), (w, h, d)):
        edge |= (ii + lo < 0) | (ii + hi >= dim)
    t_border = torch.minimum(
        torch.minimum(_border_t(p[0], oks[0], invs[0], w),
                      _border_t(p[1], oks[1], invs[1], h)),
        _border_t(p[2], oks[2], invs[2], d))
    t_stop = torch.where(edge, torch.minimum(t_border, length), length)

    # Blocked cells; cells outside the grid are not blocked (the kernel
    # clips the box to the grid).
    blocked = torch.nn.functional.pad((flags != FLUID).to(F32),
                                      (D,) * 6) > 0.5
    walked = torch.zeros_like(can)
    t_walk = t_stop.clone()
    for oz in range(-D, D + 1):
        for oy in range(-D, D + 1):
            for ox in range(-D, D + 1):
                in_box = torch.ones_like(can)
                for (lo, hi), o in zip(box, (ox, oy, oz)):
                    in_box &= (lo <= o) & (o <= hi)
                nb = blocked[:, D + oz:D + oz + d, D + oy:D + oy + h,
                             D + ox:D + ox + w]
                test = in_box & nb
                walked |= test
                t_in = t_out = None
                for pc, ok, inv, ii, o in zip(p, oks, invs, (xx, yy, zz),
                                              (ox, oy, oz)):
                    t_lo, t_hi = _slab(pc, ok, inv, ii + o)
                    t_in = t_lo if t_in is None else torch.maximum(t_in, t_lo)
                    t_out = (t_hi if t_out is None
                             else torch.minimum(t_out, t_hi))
                hit = test & (t_in <= t_out) & (t_in >= 0)
                t_walk = torch.where(hit, torch.minimum(t_walk, t_in),
                                     t_walk)
    # The skip: a ray with nothing blocked in its box keeps t_stop.
    t = torch.clamp(torch.where(walked, t_walk, t_stop), min=0.0)
    traced = torch.stack([pc + t * dc for pc, dc in zip(p, dirs)], dim=1)
    volume = torch.ones_like(length, dtype=torch.int32)
    for lo, hi in box:
        volume = volume * (hi - lo + 1)
    visited = float((volume - 1)[can].float().mean())
    return torch.where(can[:, None], traced, pos), walked & can, visited


def _flags(rng, obstacles):
    """Border shell and random obstacles; ``open``: 8% obstacles and no
    shell, so that rays reach the domain's margin planes."""
    if obstacles == "open":
        return np.where(rng.random(SHAPE) < 0.08, 2, 1).astype(np.int32)
    return random_flags3(rng, SHAPE, p_obstacle=OBSTACLES[obstacles])


def _random_rays(rng, flags, D):
    """Uniform in [-1.6D, 1.6D] per component: about a third clipped to
    exactly +-D."""
    return 1.6 * D * (2.0 * rng.random((SHAPE[0], 3) + SHAPE[1:]) - 1.0)


def _axis_rays(rng, flags, D):
    """One non-zero component from {+-0.25, +-0.5, +-1, +-1.5, +-D} or
    uniform, the others exactly 0."""
    b, d, h, w = SHAPE
    mags = np.array([0.25, 0.5, 1.0, 1.5, D, 0.0], np.float64)
    pick = rng.integers(0, len(mags), (b, d, h, w))
    mag = np.where(pick == len(mags) - 1, rng.random((b, d, h, w)) * D,
                   mags[pick])
    sign = np.where(rng.random((b, d, h, w)) < 0.5, -1.0, 1.0)
    axis = rng.integers(0, 3, (b, d, h, w))
    out = np.zeros((b, 3, d, h, w))
    for c in range(3):
        out[:, c] = np.where(axis == c, sign * mag, 0.0)
    return out


def _zero_rays(rng, flags, D):
    """Zero displacements and lengths around the 1e-12 cut-off."""
    b, d, h, w = SHAPE
    scales = np.array([0.0, 0.0, 1e-13, 5e-13, 1e-12, 2e-12, 1e-9, 1e-6])
    s = scales[rng.integers(0, len(scales), (b, 1, d, h, w))]
    return s * (2.0 * rng.random((b, 3, d, h, w)) - 1.0)


def _face_rays(rng, flags, D):
    """Rays from each cell centre to a random point of a blocked cell's
    expanded box in the window (any cell where none is blocked), with one
    axis's end snapped to the near face (x - 1e-5 or x + 1 + 1e-5) plus an
    offset of 0, +-1e-6 .. +-2e-5, or +-1e-4, +-3e-4 (about the box's
    margin)."""
    b, d, h, w = SHAPE
    f = torch.from_numpy(flags)
    blocked = torch.nn.functional.pad((f != FLUID).double(), (D,) * 6)
    best = torch.full((b, d, h, w), -1.0, dtype=torch.float64)
    target = torch.zeros((3, b, d, h, w), dtype=torch.float64)
    noise = torch.from_numpy(rng.random((2 * D + 1,) * 3 + (b, d, h, w)))
    for iz, oz in enumerate(range(-D, D + 1)):
        for iy, oy in enumerate(range(-D, D + 1)):
            for ix, ox in enumerate(range(-D, D + 1)):
                if ox == oy == oz == 0:
                    continue
                nb = blocked[:, D + oz:D + oz + d, D + oy:D + oy + h,
                             D + ox:D + ox + w]
                score = noise[iz, iy, ix] + nb
                take = score > best
                best = torch.where(take, score, best)
                for c, o in enumerate((ox, oy, oz)):
                    target[c] = torch.where(take, float(o), target[c])
    target = target.numpy().transpose(1, 0, 2, 3, 4)
    eps = np.array([0.0, 1e-6, -1e-6, 5e-6, -5e-6, 1e-5, -1e-5, 2e-5, -2e-5,
                    1e-4, -1e-4, 3e-4, -3e-4])
    # Offset of the end from the ray's cell origin: inside the target cell,
    # then one axis onto the expanded face that faces the ray.
    end = target + rng.random(target.shape)
    axis = rng.integers(0, 3, (b, d, h, w))
    face = np.where(target > 0, -HIT_MARGIN,
                    np.where(target < 0, 1.0 + HIT_MARGIN,
                             np.where(rng.random(target.shape) < 0.5,
                                      -HIT_MARGIN, 1.0 + HIT_MARGIN)))
    snapped = target + face + eps[rng.integers(0, len(eps), target.shape)]
    for c in range(3):
        end[:, c] = np.where(axis == c, snapped[:, c], end[:, c])
    return end - 0.5


RAYS = {"random": _random_rays, "axis": _axis_rays, "zero": _zero_rays,
        "faces": _face_rays}
OBSTACLES = {"border": 0.0, "8pct": 0.08, "30pct": 0.3, "open": None}


def _case(D, obstacles, rays, seed):
    rng = np.random.default_rng(seed)
    flags = _flags(rng, obstacles)
    raw = RAYS[rays](rng, flags, D).astype(np.float32)
    delta = torch.clamp(torch.from_numpy(raw), -D, D)
    return torch.from_numpy(flags), delta


@pytest.mark.parametrize("rays", list(RAYS))
@pytest.mark.parametrize("obstacles", list(OBSTACLES))
@pytest.mark.parametrize("D", [1, 2, 3])
def test_pruned_walk_is_the_full_walk(D, obstacles, rays):
    """The twin of the kernel's pruned walk gives the full walk's
    positions bit for bit, and visits fewer offsets than the window."""
    seed = 100 * D + 10 * list(OBSTACLES).index(obstacles) \
        + list(RAYS).index(rays)
    flags, delta = _case(D, obstacles, rays, seed)
    b, d, h, w = flags.shape
    pos = centers3(b, d, h, w)
    want = line_trace_firsthit3(pos, delta, flags, D)
    got, walked, visited = pruned_firsthit3(delta, flags, D)
    assert torch.equal(got, want)
    if rays != "zero":
        assert visited < (2 * D + 1) ** 3 - 1
        # Rays that moved to a stop short of their full length walked.
        full = pos + delta
        moved = (flags == FLUID) & (got != full).any(1)
        assert bool(walked.any()) or not bool(moved.any())


def test_pruned_walk_matches_jax():
    """The twin against the JAX package's first-hit trace at D = 1, from
    the same numpy inputs."""
    D = 1
    flags, delta = _case(D, "30pct", "random", 7)
    b, d, h, w = flags.shape
    pos = centers3(b, d, h, w)
    got, _, _ = pruned_firsthit3(delta, flags, D)
    want = np.asarray(jax.jit(
        lambda p, dl, f: j_line_trace3.line_trace_firsthit3(p, dl, f, D))(
            jnp.asarray(pos.numpy()), jnp.asarray(delta.numpy()),
            jnp.asarray(flags.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
