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
from .ops3d import index_grids3


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


def gather3(src, zi, yi, xi):
    """src[b, zi, yi, xi] for in-range integer index grids (b, d, h, w)."""
    b, d, h, w = src.shape
    idx = ((zi.long() * h + yi.long()) * w + xi.long()).reshape(b, -1)
    return torch.gather(src.reshape(b, -1), 1, idx).reshape(src.shape)


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
    """Min/max/count of ``src`` over the fluid cells in the 3x3x3
    neighbourhood of the cell containing ``pos`` (after the window clamp).
    Returns (has_fluid, minv, maxv)."""
    _, d, h, w = src.shape
    pos = clamp_pos_to_window3(pos, D)
    i0 = torch.clamp(torch.trunc(pos[:, 0]).to(I32), 0, w - 1)
    j0 = torch.clamp(torch.trunc(pos[:, 1]).to(I32), 0, h - 1)
    k0 = torch.clamp(torch.trunc(pos[:, 2]).to(I32), 0, d - 1)
    minv = torch.full_like(src, float("inf"))
    maxv = torch.full_like(src, float("-inf"))
    found = torch.zeros(src.shape, dtype=torch.bool, device=src.device)
    for dk in (-1, 0, 1):
        kk = k0 + dk
        for dj in (-1, 0, 1):
            jj = j0 + dj
            for di in (-1, 0, 1):
                ii = i0 + di
                inb = ((ii >= 0) & (ii < w) & (jj >= 0) & (jj < h)
                       & (kk >= 0) & (kk < d))
                zi, yi, xi = (torch.where(inb, a, 0) for a in (kk, jj, ii))
                m = inb & (gather3(flags, zi, yi, xi) == FLUID)
                s = gather3(src, zi, yi, xi)
                minv = torch.where(m, torch.minimum(minv, s), minv)
                maxv = torch.where(m, torch.maximum(maxv, s), maxv)
                found = found | m
    return found, minv, maxv


def clamp_component_mac_window3(dst_c, orig_c, vel_mac_dt, D: int = 2):
    """Selle clamp: clamp ``dst_c`` to the min/max of ``orig_c`` over the 8
    trilinear corners of each of the two integer positions
    idx -/+ vel_mac*dt (per axis clamped to +-D, truncated toward zero,
    lower corner clamped to [0, dim-2])."""
    b, d, h, w = orig_c.shape
    idx = index_grids3(b, d, h, w, orig_c.device)[::-1]   # (x, y, z)
    vel = [torch.clamp(vel_mac_dt[:, c], -D, D) for c in range(3)]
    minv = torch.full_like(orig_c, float("inf"))
    maxv = torch.full_like(orig_c, float("-inf"))
    for sign in (-1.0, 1.0):
        lo = [torch.clamp((ii.to(F32) + sign * v).to(I32), 0, dim - 2)
              for ii, v, dim in zip(idx, vel, (w, h, d))]
        for dk in (0, 1):
            for dj in (0, 1):
                for di in (0, 1):
                    s = gather3(orig_c, lo[2] + dk, lo[1] + dj, lo[0] + di)
                    minv = torch.minimum(minv, s)
                    maxv = torch.maximum(maxv, s)
    return torch.maximum(torch.minimum(dst_c, maxv), minv)


def make_blocked_lookup_window3(flags, D: int = 2):
    """Point lookup for a march trace: is the cell containing ``pos``
    (b, 3, d, h, w) non-fluid? Positions outside the domain, or whose cell
    lies beyond +-D of the querying cell, return False."""
    b, d, h, w = flags.shape
    zz, yy, xx = index_grids3(b, d, h, w, flags.device)
    blocked = flags != FLUID

    def lookup(pos):
        cell = [torch.trunc(pos[:, c]).to(I32) for c in range(3)]
        near = torch.ones(flags.shape, dtype=torch.bool, device=flags.device)
        for ci, ii in zip(cell, (xx, yy, zz)):
            near = near & ((ci - ii).abs() <= D)
        out = ((pos[:, 0] <= 0) | (pos[:, 0] >= w) | (pos[:, 1] <= 0)
               | (pos[:, 1] >= h) | (pos[:, 2] <= 0) | (pos[:, 2] >= d))
        ok = near & ~out
        zi, yi, xi = (torch.where(ok, ci, 0) for ci in cell[::-1])
        return ok & gather3(blocked, zi, yi, xi)

    return lookup
