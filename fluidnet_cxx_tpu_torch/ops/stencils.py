"""Linear stencil ops: divergence, pressure-gradient update, wall BCs.

Twins of the JAX package's ``ops/stencils.py`` (same masks, same sign
conventions; the reference citations live there).
"""
import torch

from ..celltype import EMPTY, FLUID, OBSTACLE
from .common import border_mask, nb, where0


def velocity_divergence(U, flags):
    """Poisson RHS ``-div(U)`` per fluid cell (Manta makeRhs sign); zero in
    obstacles and on the 1-ring border."""
    _, h, w = flags.shape
    u, v = U[:, 0], U[:, 1]
    rhs = (u - nb(u, 0, 1)) + (v - nb(v, 1, 0))
    keep = (~border_mask(h, w, 1, U.device)) & (flags != OBSTACLE)
    return where0(keep, rhs)


def velocity_update(p, U, flags):
    """U' = U - grad(p) with the fluid/empty face rules; border faces are
    left untouched."""
    _, h, w = flags.shape
    u, v = U[:, 0], U[:, 1]
    fl = flags == FLUID
    em = flags == EMPTY
    fl_xm, em_xm = nb(fl, 0, -1), nb(em, 0, -1)
    fl_ym, em_ym = nb(fl, -1, 0), nb(em, -1, 0)
    p_xm, p_ym = nb(p, 0, -1), nb(p, -1, 0)

    u_new = torch.where(
        fl & fl_xm, u - (p - p_xm),
        torch.where(fl & em_xm, u - p, where0(em & fl_xm, u + p_xm)))
    v_new = torch.where(
        fl & fl_ym, v - (p - p_ym),
        torch.where(fl & em_ym, v - p, where0(em & fl_ym, v + p_ym)))
    interior = ~border_mask(h, w, 1, U.device)
    return torch.stack([torch.where(interior, u_new, u),
                        torch.where(interior, v_new, v)], dim=1)


def _clamped_left(a, dim):
    """Neighbour at index-1 along ``dim`` with the index clamped at 0."""
    first = a.narrow(dim, 0, 1)
    rest = a.narrow(dim, 0, a.shape[dim] - 1)
    return torch.cat([first, rest], dim=dim)


def set_wall_bcs(U, flags):
    """Free-slip walls: zero the normal velocity on obstacle faces (left/down
    neighbour index clamped at 0)."""
    u, v = U[:, 0], U[:, 1]
    fl = flags == FLUID
    ob = flags == OBSTACLE
    cont = fl | ob
    kill_u = cont & (_clamped_left(ob, 2) | (ob & _clamped_left(fl, 2)))
    kill_v = cont & (_clamped_left(ob, 1) | (ob & _clamped_left(fl, 1)))
    return torch.stack([where0(~kill_u, u), where0(~kill_v, v)], dim=1)


def flags_to_occupancy(flags):
    """Flags -> {0: fluid, 1: obstacle} float CNN input channel."""
    occ = flags.to(torch.float32)
    occ = torch.where(flags == FLUID, torch.zeros_like(occ), occ)
    return torch.where(flags == OBSTACLE, torch.ones_like(occ), occ)


def empty_domain(b: int, h: int, w: int, bnd: int = 1, device="cpu"):
    """Fresh flags: fluid interior, obstacle wall of width ``bnd``."""
    border = border_mask(h, w, bnd, device)
    flags = torch.where(border, OBSTACLE, FLUID).to(torch.int32)
    return flags[None].expand(b, h, w).contiguous()
