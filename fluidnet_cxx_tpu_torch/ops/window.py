"""Bounded-window sampling (twin of the JAX package's ``ops/window.py``).

A back-traced position is clamped to its own cell centre +- D
(``max_disp``) before it is sampled — that clamp is part of the
semantics (PARITY item 7) and every function here keeps it. The JAX
package writes each sample as a masked sum over the (2D+2)^2 statically
shifted copies (a TPU device to avoid gathers); here each corner is read
with one gather at the same clamped index, as ops/window3.py does in
3-D. The values are the same: the masked sum adds only zero terms
besides the corners', in the order kept here, and the extrema are taken
over the same cells. So the fluid-aware sample and the clamps are the
gather engine's (ops/grid.py, ``neighbourhood_bounds``, ``corner_clamp``)
at the clamped position or displacement; the plain sample lerps along x
first, where the gather engine's lerps along y first. On the card the
advection kernels (ops/kernels/advect.py) compute these values with
direct loads.
"""
import torch

from ..celltype import FLUID
from .common import F32, I32, cell_index_grid, gather2d
from .grid import _corner_setup, get_centered, interpol_with_fluid


def _clip(a, lo, hi):
    return torch.minimum(torch.maximum(a, lo), hi)


def clamp_pos_to_window(pos, D: int):
    """Clamp absolute positions to each cell's own centre +- D."""
    b, _, h, w = pos.shape
    xx, yy = cell_index_grid(b, h, w, pos.device)
    cx = xx.to(F32) + 0.5
    cy = yy.to(F32) + 0.5
    return torch.stack([_clip(pos[:, 0], cx - D, cx + D),
                        _clip(pos[:, 1], cy - D, cy + D)], dim=1)


def interpol_window(src, pos, D: int = 4):
    """Plain bilinear sample of ``src`` (b, h, w) at ``pos`` (b, 2, h, w),
    window form: a lerp along x, then along y."""
    x0, y0, s0, s1, t0, t1 = _corner_setup(src.shape[1:],
                                           clamp_pos_to_window(pos, D))
    row0 = s0 * gather2d(src, y0, x0) + s1 * gather2d(src, y0, x0 + 1)
    row1 = (s0 * gather2d(src, y0 + 1, x0)
            + s1 * gather2d(src, y0 + 1, x0 + 1))
    return t0 * row0 + t1 * row1


def interpol_with_fluid_window(src, flags, pos, D: int = 4):
    """Fluid-aware bilinear sample, window form: ``grid.
    interpol_with_fluid`` of the position clamped to the window."""
    return interpol_with_fluid(src, flags, clamp_pos_to_window(pos, D))


def neighbourhood_bounds(src, pos, flags, sample_outside):
    """Min/max of ``src`` over the fluid cells (every cell with
    ``sample_outside``) of the 3x3 neighbourhood of the cell holding
    ``pos``, its index clamped to the grid. Returns (found, minv, maxv):
    the gather engine's clamp bounds, and the window engine's after the
    window clamp."""
    _, h, w = src.shape
    cell = torch.trunc(pos).to(I32)
    i0 = torch.clamp(cell[:, 0], 0, w - 1)
    j0 = torch.clamp(cell[:, 1], 0, h - 1)
    zero = torch.zeros((), dtype=I32, device=src.device)
    minv = torch.full_like(src, float("inf"))
    maxv = torch.full_like(src, float("-inf"))
    found = torch.zeros(src.shape, dtype=torch.bool, device=src.device)
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            ii, jj = i0 + di, j0 + dj
            ok = (ii >= 0) & (ii < w) & (jj >= 0) & (jj < h)
            ii = torch.where(ok, ii, zero)
            jj = torch.where(ok, jj, zero)
            if not sample_outside:
                ok = ok & (gather2d(flags, jj, ii) == FLUID)
            s = gather2d(src, jj, ii)
            minv = torch.where(ok, torch.minimum(minv, s), minv)
            maxv = torch.where(ok, torch.maximum(maxv, s), maxv)
            found = found | ok
    return found, minv, maxv


def clamp_bounds_scalar_window(src, pos, flags, sample_outside, D: int = 4):
    """``neighbourhood_bounds`` of the position clamped to the window.
    Returns (do_clamp, minv, maxv)."""
    return neighbourhood_bounds(src, clamp_pos_to_window(pos, D), flags,
                                sample_outside)


def corner_clamp(dst_c, orig_c, vel_mac_dt):
    """Selle clamp: ``dst_c`` clamped to the min/max of ``orig_c`` over the
    bilinear corners of the integer positions idx -/+ vel_mac*dt
    (truncated toward zero, lower corner clamped to [0, dim-2])."""
    b, h, w = orig_c.shape
    xx, yy = cell_index_grid(b, h, w, orig_c.device)
    pos = torch.stack([xx.to(F32), yy.to(F32)], dim=1)
    minv = torch.full_like(orig_c, float("inf"))
    maxv = torch.full_like(orig_c, float("-inf"))
    for sign in (-1.0, 1.0):
        cp = (pos + sign * vel_mac_dt).to(I32)
        i0 = torch.clamp(cp[:, 0], 0, w - 2)
        j0 = torch.clamp(cp[:, 1], 0, h - 2)
        for dj in (0, 1):
            for di in (0, 1):
                s = gather2d(orig_c, j0 + dj, i0 + di)
                minv = torch.minimum(minv, s)
                maxv = torch.maximum(maxv, s)
    return torch.maximum(torch.minimum(dst_c, maxv), minv)


def clamp_component_mac_window(dst_c, orig_c, vel_mac_dt, D: int = 4):
    """``corner_clamp`` with vel_mac*dt clamped to +-D a component."""
    return corner_clamp(dst_c, orig_c, torch.clamp(vel_mac_dt, -D, D))


def make_blocked_lookup_window(flags, D: int = 4):
    """The march's point lookup on the window engine: is the cell holding
    ``pos`` (b, 2, h, w) non-fluid? False outside the domain and for a
    cell more than D from the querying cell on an axis. The JAX package
    sums 81 (at D 4) masked shifted copies, of which one offset can match;
    here that cell is read with one gather, the same function."""
    b, h, w = flags.shape
    xx, yy = cell_index_grid(b, h, w, flags.device)
    blocked = flags != FLUID

    def lookup(pos):
        ix = torch.trunc(pos)[:, 0].to(I32)
        iy = torch.trunc(pos)[:, 1].to(I32)
        out = ((pos[:, 0] <= 0) | (pos[:, 0] >= w) | (pos[:, 1] <= 0)
               | (pos[:, 1] >= h))
        ok = ((ix - xx).abs() <= D) & ((iy - yy).abs() <= D) & ~out
        zero = torch.zeros((), dtype=I32, device=pos.device)
        return ok & gather2d(blocked, torch.where(ok, iy, zero),
                             torch.where(ok, ix, zero))

    return lookup


def max_displacement(U, dt):
    """Largest per-axis back-trace displacement, in cells, that advection
    will attempt this step: dt * max|centred velocity| (a 0-d tensor). The
    run loop's CFL guard compares it with ``max_disp``."""
    return dt * get_centered(U).abs().max()
