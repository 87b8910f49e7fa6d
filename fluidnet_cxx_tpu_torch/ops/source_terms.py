"""Source terms: buoyancy and gravity (twins of the JAX package's
``ops/source_terms.py``). ``gravity`` is the caller's
``-scale * gravityVec``; the ops multiply by ``dt`` only."""
import numpy as np
import torch

from ..celltype import EMPTY, FLUID
from .common import border_mask, nb


def _times_dt(gravity, dt):
    """(g_x*dt, g_y*dt) rounded to float32 as the JAX package's
    float32 ``gravity * dt`` is."""
    g = np.asarray(gravity, np.float32)[:2] * np.float32(dt)
    return float(g[0]), float(g[1])


def add_buoyancy(U, flags, density, gravity, rho_star, dt):
    """Boussinesq buoyancy on interior fluid faces:
    u += g_x*dt*(0.5*(rho + rho_W) - rho_star) where cell and W are fluid.
    ``gravity`` is a 3-sequence of Python floats."""
    _, h, w = flags.shape
    u, v = U[:, 0], U[:, 1]
    sx, sy = _times_dt(gravity, dt)
    fl = flags == FLUID
    cont = fl & (~border_mask(h, w, 1, U.device))
    fac_x = sx * (0.5 * (density + nb(density, 0, -1)) - rho_star)
    fac_y = sy * (0.5 * (density + nb(density, -1, 0)) - rho_star)
    u = torch.where(cont & nb(fl, 0, -1), u + fac_x, u)
    v = torch.where(cont & nb(fl, -1, 0), v + fac_y, v)
    return torch.stack([u, v], dim=1)


def add_gravity(U, flags, gravity, dt):
    """Constant body force on interior faces between fluid/empty cells."""
    _, h, w = flags.shape
    u, v = U[:, 0], U[:, 1]
    fx, fy = _times_dt(gravity, dt)
    fl = flags == FLUID
    em = flags == EMPTY
    cont = (fl | em) & (~border_mask(h, w, 1, U.device))
    mask_x = cont & (nb(fl, 0, -1) | (nb(em, 0, -1) & fl))
    mask_y = cont & (nb(fl, -1, 0) | (nb(em, -1, 0) & fl))
    u = torch.where(mask_x, u + fx, u)
    v = torch.where(mask_y, v + fy, v)
    return torch.stack([u, v], dim=1)
