"""Bounded-window sampling (twin of the JAX package's ``ops/window.py``).

A back-traced position is clamped to its own cell centre +- D
(``max_disp``) before it is sampled — that clamp is part of the
semantics (PARITY item 7) and every function here keeps it. Each sample is
written as the same masked sum over the (2D+2)^2 statically shifted
copies as the JAX package, so the two agree bit for bit where float32
arithmetic allows; on the card the advection kernel (ops/kernels/advect.py)
computes the same values with direct loads.
"""
import torch

from ..celltype import FLUID
from .common import F32, I32, cell_index_grid, nb, where0
from .grid import get_centered, interp1d_with_fluid


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


def _corner_offsets(pos, h: int, w: int):
    """Lower bilinear corner as offsets from the cell's own index, and the
    clamped lerp weights (pos-0.5, trunc, clamp to [0, dim-2])."""
    b = pos.shape[0]
    xx, yy = cell_index_grid(b, h, w, pos.device)
    p = pos - 0.5
    pos0 = torch.trunc(p).to(I32)
    s1 = torch.clamp(p[:, 0] - pos0[:, 0].to(F32), 0.0, 1.0)
    t1 = torch.clamp(p[:, 1] - pos0[:, 1].to(F32), 0.0, 1.0)
    x0 = torch.clamp(pos0[:, 0], 0, w - 2)
    y0 = torch.clamp(pos0[:, 1], 0, h - 2)
    return x0 - xx, y0 - yy, s1, t1


def interpol_window(src, pos, D: int = 4):
    """Plain bilinear sample of ``src`` (b, h, w) at ``pos`` (b, 2, h, w),
    window form."""
    _, h, w = src.shape
    pos = clamp_pos_to_window(pos, D)
    ox0, oy0, s1, t1 = _corner_offsets(pos, h, w)
    s0, t0 = 1.0 - s1, 1.0 - t1
    wx = {ox: s0 * (ox0 == ox) + s1 * (ox0 == ox - 1)
          for ox in range(-D, D + 2)}
    out = torch.zeros_like(src)
    for oy in range(-D, D + 2):
        wy = t0 * (oy0 == oy) + t1 * (oy0 == oy - 1)
        row = torch.zeros_like(src)
        for ox in range(-D, D + 2):
            row = row + wx[ox] * nb(src, oy, ox)
        out = out + wy * row
    return out


def _extract_corners(src, flags, pos, D: int):
    """Corner values and fluid masks a=(y0,x0), b=(y0+1,x0), c=(y0,x0+1),
    d=(y0+1,x0+1), plus the lerp weights."""
    _, h, w = src.shape
    ox0, oy0, s1, t1 = _corner_offsets(pos, h, w)
    zero = torch.zeros_like(src)
    Va = Vb = Vc = Vd = zero
    Fa = Fb = Fc = Fd = zero
    fl = (flags == FLUID).to(F32)
    mx0 = {ox: ox0 == ox for ox in range(-D, D + 2)}
    mx1 = {ox: ox0 == ox - 1 for ox in range(-D, D + 2)}
    for oy in range(-D, D + 2):
        my0 = oy0 == oy
        my1 = oy0 == oy - 1
        rV0 = rV1 = rF0 = rF1 = zero
        for ox in range(-D, D + 2):
            s = nb(src, oy, ox)
            f = nb(fl, oy, ox)
            rV0 = rV0 + where0(mx0[ox], s)
            rV1 = rV1 + where0(mx1[ox], s)
            rF0 = rF0 + where0(mx0[ox], f)
            rF1 = rF1 + where0(mx1[ox], f)
        Va = Va + where0(my0, rV0)
        Vb = Vb + where0(my1, rV0)
        Vc = Vc + where0(my0, rV1)
        Vd = Vd + where0(my1, rV1)
        Fa = Fa + where0(my0, rF0)
        Fb = Fb + where0(my1, rF0)
        Fc = Fc + where0(my0, rF1)
        Fd = Fd + where0(my1, rF1)
    return Va, Vb, Vc, Vd, Fa > 0.5, Fb > 0.5, Fc > 0.5, Fd > 0.5, s1, t1


def interpol_with_fluid_window(src, flags, pos, D: int = 4):
    """Fluid-aware bilinear sample, window form: non-fluid corners are
    dropped; all four non-fluid falls back to the plain bilinear value."""
    pos = clamp_pos_to_window(pos, D)
    Va, Vb, Vc, Vd, Fa, Fb, Fc, Fd, s1, t1 = _extract_corners(
        src, flags, pos, D)
    s0, t0 = 1.0 - s1, 1.0 - t1
    Iab, fab = interp1d_with_fluid(Va, Fa, Vb, Fb, t0, t1)
    Icd, fcd = interp1d_with_fluid(Vc, Fc, Vd, Fd, t0, t1)
    Ival, fval = interp1d_with_fluid(Iab, fab, Icd, fcd, s0, s1)
    plain = (Va * t0 + Vb * t1) * s0 + (Vc * t0 + Vd * t1) * s1
    return torch.where(fval, Ival, plain)


def clamp_bounds_scalar_window(src, pos, flags, sample_outside, D: int = 4):
    """Min/max/count of ``src`` over the fluid cells in the 3x3
    neighbourhood of the cell containing ``pos``.
    Returns (do_clamp, minv, maxv)."""
    b, h, w = src.shape
    pos = clamp_pos_to_window(pos, D)
    xx, yy = cell_index_grid(b, h, w, src.device)
    i0 = torch.clamp(torch.trunc(pos[:, 0]).to(I32), 0, w - 1)
    j0 = torch.clamp(torch.trunc(pos[:, 1]).to(I32), 0, h - 1)
    oi0 = i0 - xx
    oj0 = j0 - yy
    fl_ok = (flags == FLUID) | bool(sample_outside)
    minv = torch.full_like(src, float("inf"))
    maxv = torch.full_like(src, float("-inf"))
    ncells = torch.zeros(src.shape, dtype=I32, device=src.device)
    for oy in range(-D - 1, D + 2):
        my = (oj0 - oy).abs() <= 1
        row_ok = (yy + oy >= 0) & (yy + oy < h)
        for ox in range(-D - 1, D + 2):
            m = (my & ((oi0 - ox).abs() <= 1) & row_ok
                 & (xx + ox >= 0) & (xx + ox < w) & nb(fl_ok, oy, ox))
            s = nb(src, oy, ox)
            minv = torch.where(m, torch.minimum(minv, s), minv)
            maxv = torch.where(m, torch.maximum(maxv, s), maxv)
            ncells = ncells + m.to(I32)
    return ncells >= 1, minv, maxv


def clamp_component_mac_window(dst_c, orig_c, vel_mac_dt, D: int = 4):
    """Selle clamp: clamp ``dst_c`` to the min/max of ``orig_c`` over the
    bilinear corners of the integer positions pos -/+ vel_mac*dt."""
    b, h, w = orig_c.shape
    xx, yy = cell_index_grid(b, h, w, orig_c.device)
    vx = torch.clamp(vel_mac_dt[:, 0], -D, D)
    vy = torch.clamp(vel_mac_dt[:, 1], -D, D)

    def offsets(sign):
        cx = (xx.to(F32) + sign * vx).to(I32)   # trunc toward zero
        cy = (yy.to(F32) + sign * vy).to(I32)
        return torch.clamp(cx, 0, w - 2) - xx, torch.clamp(cy, 0, h - 2) - yy

    oiM, ojM = offsets(-1.0)
    oiP, ojP = offsets(1.0)
    minv = torch.full_like(orig_c, float("inf"))
    maxv = torch.full_like(orig_c, float("-inf"))
    for oy in range(-D, D + 2):
        myM = (ojM == oy) | (ojM == oy - 1)
        myP = (ojP == oy) | (ojP == oy - 1)
        for ox in range(-D, D + 2):
            m = ((myM & ((oiM == ox) | (oiM == ox - 1)))
                 | (myP & ((oiP == ox) | (oiP == ox - 1))))
            s = nb(orig_c, oy, ox)
            minv = torch.where(m, torch.minimum(minv, s), minv)
            maxv = torch.where(m, torch.maximum(maxv, s), maxv)
    return torch.maximum(torch.minimum(dst_c, maxv), minv)


def max_displacement(U, dt):
    """Largest per-axis back-trace displacement, in cells, that advection
    will attempt this step: dt * max|centred velocity| (a 0-d tensor). The
    run loop's CFL guard compares it with ``max_disp``."""
    return dt * get_centered(U).abs().max()
