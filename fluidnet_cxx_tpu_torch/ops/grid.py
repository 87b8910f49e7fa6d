"""MAC-grid face/centre resampling and the centred curl (the subset of the
JAX package's ``ops/grid.py`` that the window advection engine and the
vorticity confinement use)."""
import torch

from .common import border_mask, nb, where0


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
