"""Linear stencil ops: divergence, pressure-gradient update, wall BCs
(free-slip and stick).

Twins of the JAX package's ``ops/stencils.py`` (same masks, same sign
conventions; the reference citations live there).
"""
import torch

from ..celltype import EMPTY, FLUID, OBSTACLE, STICK
from .common import I32, border_mask, nb, where0


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


def set_wall_bcs_stick(U, flags, flags_stick):
    """No-slip (stick) walls, in the JAX package's order:
      1. zero the velocity inside obstacle cells;
      2. free-slip on the normal components (left/down neighbour false at
         index 0);
      3. in stick cells, the tangential ghost velocity is the negated
         fluid neighbour's (the mean of both when both sides are fluid);
      4. zero a stick cell whose x- and y-adjacent neighbours are stick."""
    _, h, w = flags.shape
    dev = U.device
    u, v = U[:, 0], U[:, 1]
    fl = flags == FLUID
    ob = flags == OBSTACLE
    st = flags_stick == STICK
    cont = fl | ob | st
    xx = torch.arange(w, dtype=I32, device=dev)[None, None, :]
    yy = torch.arange(h, dtype=I32, device=dev)[None, :, None]
    has_xm, has_xp = xx > 0, xx < w - 1
    has_ym, has_yp = yy > 0, yy < h - 1

    u = where0(~ob, u)
    v = where0(~ob, v)

    fl_xm = nb(fl, 0, -1) & has_xm
    fl_ym = nb(fl, -1, 0) & has_ym
    u = where0(~(cont & ((nb(ob, 0, -1) & has_xm) | (ob & fl_xm))), u)
    v = where0(~(cont & ((nb(ob, -1, 0) & has_ym) | (ob & fl_ym))), v)

    fl_xp = nb(fl, 0, 1) & has_xp
    fl_yp = nb(fl, 1, 0) & has_yp
    v_xm = where0(has_xm, nb(v, 0, -1))
    v_xp = where0(has_xp, nb(v, 0, 1))
    u_ym = where0(has_ym, nb(u, -1, 0))
    u_yp = where0(has_yp, nb(u, 1, 0))
    stc = cont & st
    v = torch.where(stc & fl_xm, -v_xm, v)
    v = torch.where(stc & fl_xp, -v_xp, v)
    v = torch.where(stc & fl_xm & fl_xp, -0.5 * (v_xm + v_xp), v)
    u = torch.where(stc & fl_ym, -u_ym, u)
    u = torch.where(stc & fl_yp, -u_yp, u)
    u = torch.where(stc & fl_ym & fl_yp, -0.5 * (u_ym + u_yp), u)

    st_xm = nb(st, 0, -1) & has_xm
    st_xp = nb(st, 0, 1) & has_xp
    st_ym = nb(st, -1, 0) & has_ym
    st_yp = nb(st, 1, 0) & has_yp
    u = where0(~(stc & st_xm & (st_ym | st_yp)), u)
    v = where0(~(stc & st_ym & (st_xm | st_xp)), v)
    return torch.stack([u, v], dim=1)


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
