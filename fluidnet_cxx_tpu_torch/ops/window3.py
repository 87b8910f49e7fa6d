"""Bounded-window sampling in 3-D (twin of the JAX package's
``ops/window3.py``).

A back-traced position is clamped to its own cell centre +- D per axis
before it is sampled; that clamp is part of the semantics. The JAX
package writes each sample as a masked sum over the (2D+2)^3 statically
shifted copies (a TPU device to avoid gathers); here each corner is read
with a direct gather at the same clamped index. The values are the same:
the masked sum adds only zero terms besides the corners', and its
per-axis order (x, then y, then z) is kept. The advection kernels
(ops/kernels/advect3.py) run this arithmetic with direct loads.
"""
import torch

from ..celltype import FLUID
from .common import F32, I32
from .ops3d import corner_clamp3, gather3, index_grids3, neighbourhood_bounds3


def _clip(a, lo, hi):
    return torch.minimum(torch.maximum(a, lo), hi)


def clamp_pos_to_window3(pos, D: int):
    """Clamp absolute positions (channels x, y, z) to each cell's own
    centre +- D per axis."""
    b, _, d, h, w = pos.shape
    zz, yy, xx = index_grids3(b, d, h, w, pos.device)
    out = []
    for c, ii in enumerate((xx, yy, zz)):
        ctr = ii.to(F32) + 0.5
        out.append(_clip(pos[:, c], ctr - D, ctr + D))
    return torch.stack(out, dim=1)


def interpol_window3(src, pos, D: int = 2):
    """Plain trilinear sample of ``src`` (b, d, h, w) at ``pos``
    (b, 3, d, h, w), window form: pos-0.5, trunc, weights clamped to
    [0, 1], lower corner clamped to [0, dim-2]; lerp along x, then y,
    then z."""
    _, d, h, w = src.shape
    p = clamp_pos_to_window3(pos, D) - 0.5
    p0 = torch.trunc(p).to(I32)
    frac = [torch.clamp(p[:, c] - p0[:, c].to(F32), 0.0, 1.0)
            for c in range(3)]
    s1, t1, f1 = frac
    s0, t0, f0 = 1.0 - s1, 1.0 - t1, 1.0 - f1
    x0 = torch.clamp(p0[:, 0], 0, w - 2)
    y0 = torch.clamp(p0[:, 1], 0, h - 2)
    z0 = torch.clamp(p0[:, 2], 0, d - 2)

    def plane(z):
        r0 = s0 * gather3(src, z, y0, x0) + s1 * gather3(src, z, y0, x0 + 1)
        r1 = (s0 * gather3(src, z, y0 + 1, x0)
              + s1 * gather3(src, z, y0 + 1, x0 + 1))
        return t0 * r0 + t1 * r1

    return f0 * plane(z0) + f1 * plane(z0 + 1)


def clamp_bounds_scalar_window3(src, pos, flags, D: int = 2):
    """``ops3d.neighbourhood_bounds3`` of the position clamped to the
    window. Returns (has_fluid, minv, maxv)."""
    return neighbourhood_bounds3(src, clamp_pos_to_window3(pos, D), flags)


def clamp_component_mac_window3(dst_c, orig_c, vel_mac_dt, D: int = 2):
    """``ops3d.corner_clamp3`` with vel_mac*dt clamped to +-D a
    component."""
    return corner_clamp3(dst_c, orig_c, torch.clamp(vel_mac_dt, -D, D))


def make_blocked_lookup_window3(flags, D: int = 2):
    """Point lookup for a march trace: is the cell containing ``pos``
    (b, 3, d, h, w) non-fluid? Positions outside the domain, or whose cell
    lies beyond +-D of the querying cell, return False."""
    b, d, h, w = flags.shape
    zz, yy, xx = index_grids3(b, d, h, w, flags.device)
    blocked = flags != FLUID

    def lookup(pos):
        cell = [torch.trunc(pos)[:, c].to(I32) for c in range(3)]
        near = torch.ones(flags.shape, dtype=torch.bool, device=flags.device)
        for ci, ii in zip(cell, (xx, yy, zz)):
            near = near & ((ci - ii).abs() <= D)
        out = ((pos[:, 0] <= 0) | (pos[:, 0] >= w) | (pos[:, 1] <= 0)
               | (pos[:, 1] >= h) | (pos[:, 2] <= 0) | (pos[:, 2] >= d))
        ok = near & ~out
        zi, yi, xi = (torch.where(ok, ci, 0) for ci in cell[::-1])
        return ok & gather3(blocked, zi, yi, xi)

    return lookup
