"""MAC-grid face/centre resampling, bilinear sampling by gathers and the
centred curl (twin of the JAX package's ``ops/grid.py``). ``interpol``,
``interpol_with_fluid`` and ``interpol_component`` are the gather
engine's samplers: they read the four corners at any distance, where the
window engine (ops/window.py) clamps the position to the cell's own
centre +- ``max_disp`` first."""
import torch

from ..celltype import FLUID
from .common import F32, I32, border_mask, gather2d, nb, where0


def get_centered(U):
    """MAC -> cell-centre velocity, zero on the 1-ring border."""
    _, _, h, w = U.shape
    u, v = U[:, 0], U[:, 1]
    cu = 0.5 * (u + nb(u, 0, 1))
    cv = 0.5 * (v + nb(v, 1, 0))
    keep = ~border_mask(h, w, 1, U.device)
    return torch.stack([where0(keep, cu), where0(keep, cv)], dim=1)


def get_at_mac_x(U):
    """Velocity vector at the x-face: (u, 0.25*(v + v_W + v_N + v_NW))."""
    _, _, h, w = U.shape
    u, v = U[:, 0], U[:, 1]
    vy = 0.25 * (v + nb(v, 0, -1) + nb(v, 1, 0) + nb(v, 1, -1))
    keep = ~border_mask(h, w, 1, U.device)
    return torch.stack([where0(keep, u), where0(keep, vy)], dim=1)


def get_at_mac_y(U):
    """Velocity vector at the y-face: (0.25*(u + u_S + u_E + u_SE), v)."""
    _, _, h, w = U.shape
    u, v = U[:, 0], U[:, 1]
    ux = 0.25 * (u + nb(u, -1, 0) + nb(u, 0, 1) + nb(u, -1, 1))
    keep = ~border_mask(h, w, 1, U.device)
    return torch.stack([where0(keep, ux), where0(keep, v)], dim=1)


def _corner_setup(shape_hw, pos):
    """Lower bilinear corner (x0, y0) of ``pos`` (b, 2, h, w), clamped to
    [0, dim-2], and the lerp weights (s0, s1, t0, t1) of the unclamped
    corner, clamped to [0, 1]: pos - 0.5 truncated toward zero."""
    h, w = shape_hw
    p = pos - 0.5
    pos0 = torch.trunc(p).to(I32)
    s1 = torch.clamp(p[:, 0] - pos0[:, 0].to(F32), 0.0, 1.0)
    t1 = torch.clamp(p[:, 1] - pos0[:, 1].to(F32), 0.0, 1.0)
    x0 = torch.clamp(pos0[:, 0], 0, w - 2)
    y0 = torch.clamp(pos0[:, 1], 0, h - 2)
    return x0, y0, 1.0 - s1, s1, 1.0 - t1, t1


def interpol(src, pos):
    """Plain bilinear sample of ``src`` (b, h, w) at ``pos`` (b, 2, h, w):
    a lerp along y, then along x."""
    _, h, w = src.shape
    x0, y0, s0, s1, t0, t1 = _corner_setup((h, w), pos)
    Ia = gather2d(src, y0, x0)
    Ib = gather2d(src, y0 + 1, x0)
    Ic = gather2d(src, y0, x0 + 1)
    Id = gather2d(src, y0 + 1, x0 + 1)
    return (Ia * t0 + Ib * t1) * s0 + (Ic * t0 + Id * t1) * s1


def interpol_with_fluid(src, flags, pos):
    """Bilinear sample that drops non-fluid corners; all four non-fluid
    falls back to the plain bilinear value."""
    _, h, w = src.shape
    x0, y0, s0, s1, t0, t1 = _corner_setup((h, w), pos)

    def at(yi, xi):
        return gather2d(src, yi, xi), gather2d(flags, yi, xi) == FLUID

    Ia, fa = at(y0, x0)
    Ib, fb = at(y0 + 1, x0)
    Ic, fc = at(y0, x0 + 1)
    Id, fd = at(y0 + 1, x0 + 1)
    Iab, fab = interp1d_with_fluid(Ia, fa, Ib, fb, t0, t1)
    Icd, fcd = interp1d_with_fluid(Ic, fc, Id, fd, t0, t1)
    Ival, fval = interp1d_with_fluid(Iab, fab, Icd, fcd, s0, s1)
    plain = (Ia * t0 + Ib * t1) * s0 + (Ic * t0 + Id * t1) * s1
    return torch.where(fval, Ival, plain)


def interpol_component(U, pos, c: int):
    """Bilinear sample of velocity component ``c`` at ``pos``."""
    return interpol(U[:, c], pos)


def interp1d_with_fluid(va, fa, vb, fb, ta, tb):
    """Fluid-aware 1-D lerp: non-fluid endpoints are dropped; both
    non-fluid -> 0 and flagged invalid."""
    m0 = (~fa) & (~fb)
    m1 = (~fa) & fb
    m2 = fa & (~fb)
    val = torch.where(m1, vb, torch.where(m2, va, va * ta + vb * tb))
    return where0(~m0, val), ~m0


def curl2d(U):
    """z-vorticity at cell centres, dv/dx - du/dy by central differences,
    zero on the border ring."""
    _, _, h, w = U.shape
    u, v = U[:, 0], U[:, 1]
    dvdx = 0.5 * (nb(v, 0, 1) - nb(v, 0, -1))
    dudy = 0.5 * (nb(u, 1, 0) - nb(u, -1, 0))
    return where0(~border_mask(h, w, 1, U.device), dvdx - dudy)
