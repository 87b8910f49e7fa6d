"""Source terms: buoyancy, gravity, viscosity, the scalar correction and
vorticity confinement (twins of the JAX package's ``ops/source_terms.py``).
``gravity`` is the caller's ``-scale * gravityVec``; the ops multiply by
``dt`` only."""
import numpy as np
import torch

from ..celltype import EMPTY, FLUID
from .common import border_mask, nb, where0
from .grid import curl2d


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


def add_viscosity(dt, U, flags, viscosity):
    """Explicit viscous diffusion with the 5-point Laplacian on interior
    faces: u' = u + dt*nu*(u_E + u_N + u_W + u_S - 4u) where the cell and
    its west neighbour are fluid (south for v), and 0 on every other
    interior face. The stencil's fourth term is the south neighbour, as in
    the JAX package (the FluidNet reference reads a diagonal there)."""
    _, h, w = flags.shape
    fl = flags == FLUID

    def lap(c):
        return (nb(c, 0, 1) + nb(c, 1, 0) + nb(c, 0, -1) + nb(c, -1, 0)
                - 4.0 * c)

    u, v = U[:, 0], U[:, 1]
    u_new = where0(fl & nb(fl, 0, -1), u + dt * viscosity * lap(u))
    v_new = where0(fl & nb(fl, -1, 0), v + dt * viscosity * lap(v))
    interior = ~border_mask(h, w, 1, U.device)
    return torch.stack([torch.where(interior, u_new, u),
                        torch.where(interior, v_new, v)], dim=1)


def correct_scalar(dt, src, div, flags):
    """Variable-density correction: rho += dt*0.5*rho*div in fluid cells."""
    return torch.where(flags == FLUID, src + dt * 0.5 * src * div, src)


def add_vorticity_confinement(U, flags, strength, dt):
    """Vorticity confinement: f = strength * (N x omega) with
    N = grad|omega| / |grad|omega||, omega the centred z-vorticity; f is
    averaged to the faces and added, times dt, on interior fluid faces."""
    _, h, w = flags.shape
    u, v = U[:, 0], U[:, 1]
    fl = flags == FLUID
    omega = curl2d(U)
    mag = omega.abs()
    gx = 0.5 * (nb(mag, 0, 1) - nb(mag, 0, -1))
    gy = 0.5 * (nb(mag, 1, 0) - nb(mag, -1, 0))
    norm = torch.sqrt(gx * gx + gy * gy) + 1e-12
    fx = (gy / norm) * omega
    fy = -(gx / norm) * omega
    fx_face = 0.5 * (fx + nb(fx, 0, -1))
    fy_face = 0.5 * (fy + nb(fy, -1, 0))
    cont = fl & (~border_mask(h, w, 1, U.device))
    u = torch.where(cont & nb(fl, 0, -1), u + strength * dt * fx_face, u)
    v = torch.where(cont & nb(fl, -1, 0), v + strength * dt * fy_face, v)
    return torch.stack([u, v], dim=1)
