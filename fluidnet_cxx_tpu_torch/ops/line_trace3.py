"""Obstacle-aware back-traces in 3-D (twin of the JAX package's
``ops/line_trace3.py``): the iterative march ``calc_line_trace3`` (the 2-D
march of ops/line_trace.py on three axes) and the continuous first-hit
trace ``line_trace_firsthit3``.

The first-hit stopping point of a ray from a cell centre is the first
intersection of the segment [pos, pos+delta] with a blocked (non-fluid)
cell's HIT_MARGIN-expanded box inside the (2D+1)^3 window, or with the
domain's margin planes. Positions in non-fluid cells, and zero-length
rays, return ``pos`` unchanged.

Kernels K and L (``csrc/advect3.cu``) trace from cell centres and walk
only the pruned box of ``firsthit_box3`` instead of the whole window; the
cells they leave out cannot lower the stopping point, so the result is
the same to the bit (the proof is in the kernel's note).
"""
import torch

from ..celltype import FLUID
from .common import F32, I32
from .line_trace import (EPSILON, HIT_MARGIN, firsthit_axis_slabs,
                         firsthit_border_t, firsthit_box, firsthit_slack2,
                         march)
from .ops3d import gather3, index_grids3, nb3

# The slab's extent: float32(1 + 2 * HIT_MARGIN), added to its lower face.
EXTENT = 1.0 + 2.0 * HIT_MARGIN


def firsthit_slack3(dims, D: int) -> float:
    """The pruned box's margin for a grid of ``dims`` (d, h, w) and window
    D: ``line_trace.firsthit_slack2``'s 2^-12 + (max(dims) + D) * 2^-21,
    by the same argument (the third axis adds one more slab of the same
    kind). The wrapper of kernels K and L passes it to the kernel as a
    float32."""
    return firsthit_slack2(dims, D)


def firsthit_box3(delta, D: int, slack: float):
    """``line_trace.firsthit_box`` of 3-D rays ``delta`` (b, 3, d, h, w):
    the x, y and z offset ranges that kernels K and L walk."""
    return firsthit_box(delta, D, slack)


def _is_out_of_domain3(pos, d, h, w):
    """True where ``pos`` (b, 3, d, h, w) lies on or beyond a wall."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    return (x <= 0) | (x >= w) | (y <= 0) | (y >= h) | (z <= 0) | (z >= d)


def _is_blocked_cell3(pos, flags):
    """True where ``pos`` falls in a non-fluid cell; False outside the
    domain."""
    _, d, h, w = flags.shape
    out = _is_out_of_domain3(pos, d, h, w)
    zero = torch.zeros((), dtype=I32, device=pos.device)
    zi, yi, xi = (torch.where(out, zero, torch.trunc(pos)[:, c].to(I32))
                  for c in (2, 1, 0))
    return (gather3(flags, zi, yi, xi) != FLUID) & (~out)


def calc_line_trace3(pos, delta, flags, do_line_trace: bool = True,
                     blocked_lookup=None):
    """March from ``pos`` (b, 3, d, h, w) along ``delta`` in 3-D, stopping
    at walls and obstacles (the contract of ``line_trace.
    calc_line_trace``); ``pos + delta`` when ``do_line_trace`` is off."""
    if not do_line_trace:
        return pos + delta
    if blocked_lookup is None:
        def blocked_lookup(q):
            return _is_blocked_cell3(q, flags)
    _, d, h, w = flags.shape
    return march(pos, delta, (w, h, d), blocked_lookup,
                 lambda q: _is_out_of_domain3(q, d, h, w))


def line_trace_firsthit3(pos, delta, flags, D: int = 2):
    """Trace ``pos`` (b, 3, d, h, w) along ``delta`` (b, 3, d, h, w),
    stopping at the first blocked cell box or domain margin within the
    window. The 124 window offsets run one after another, so the memory
    stays a few fields whatever D is."""
    b, d, h, w = flags.shape
    zz, yy, xx = index_grids3(b, d, h, w, pos.device)
    p = [pos[:, c] for c in range(3)]
    dx, dy, dz = delta[:, 0], delta[:, 1], delta[:, 2]
    length = torch.sqrt(dx * dx + dy * dy + dz * dz)
    can = (length > EPSILON) & (flags == FLUID)
    inv_len = 1.0 / torch.clamp(length, min=EPSILON)
    dirs = [dx * inv_len, dy * inv_len, dz * inv_len]

    t_stop = torch.minimum(
        torch.minimum(firsthit_border_t(p[0], dirs[0], w),
                      firsthit_border_t(p[1], dirs[1], h)),
        firsthit_border_t(p[2], dirs[2], d))
    t_stop = torch.minimum(t_stop, length)

    blocked = flags != FLUID
    for oz in range(-D, D + 1):
        for oy in range(-D, D + 1):
            for ox in range(-D, D + 1):
                if ox == 0 and oy == 0 and oz == 0:
                    continue
                valid = ((xx + ox >= 0) & (xx + ox < w) & (yy + oy >= 0)
                         & (yy + oy < h) & (zz + oz >= 0) & (zz + oz < d))
                t_in = t_out = None
                for pc, dc, ii, o in zip(p, dirs, (xx, yy, zz),
                                         (ox, oy, oz)):
                    lo = (ii + o).to(F32) - HIT_MARGIN
                    t_lo, t_hi = firsthit_axis_slabs(pc, dc, lo, lo + EXTENT)
                    t_in = t_lo if t_in is None else torch.maximum(t_in, t_lo)
                    t_out = (t_hi if t_out is None
                             else torch.minimum(t_out, t_hi))
                hit = (nb3(blocked, oz, oy, ox) & valid & (t_in <= t_out)
                       & (t_in >= 0))
                t_stop = torch.where(hit, torch.minimum(t_stop, t_in),
                                     t_stop)

    t_stop = torch.clamp(t_stop, min=0.0)
    traced = torch.stack([pc + t_stop * dc for pc, dc in zip(p, dirs)],
                         dim=1)
    return torch.where(can[:, None], traced, pos)
