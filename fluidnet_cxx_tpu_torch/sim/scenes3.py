"""The 3-D buoyant-plume scene (twin of the JAX package's
``sim/scenes3.py::create_plume_scene3``).

A circular inlet disc on the bottom wall (rows y in [0, 4)) injects
density and vertical velocity through const-BC masks that the step
re-imposes. The 3-D cylinder scene waits (ROADMAP A.7.3).
"""
import numpy as np
import torch

from ..ops.ops3d import empty_domain3
from .step3d import SimState3


def create_plume_scene3(d: int, h: int, w: int, density_val: float = 0.1,
                        u_scale: float = 1.0, rad: float = 0.145,
                        device="cpu") -> SimState3:
    """Plume over an empty (d, h, w) box; U starts at the inlet profile."""
    b = 1
    zz, xx = np.mgrid[0:d, 0:w].astype(np.float32)
    cz, cx = (d - 1) / 2.0, (w - 1) / 2.0
    radius = rad * min(d, w)
    disc = ((xx - cx) ** 2 + (zz - cz) ** 2) <= radius * radius  # (d, w)

    U_bc = np.zeros((b, 3, d, h, w), np.float32)
    U_inv = np.ones_like(U_bc)
    rho_bc = np.zeros((b, d, h, w), np.float32)
    rho_inv = np.ones_like(rho_bc)
    for y in range(4):
        U_bc[:, 1, :, y, :] = np.where(disc, u_scale, 0.0)
        U_inv[:, :, :, y, :] = np.where(disc, 0.0, 1.0)[None, None]
        rho_bc[:, :, y, :] = np.where(disc, density_val, 0.0)
        rho_inv[:, :, y, :] = np.where(disc, 0.0, 1.0)

    def t(a):
        return torch.from_numpy(a).to(device)

    return SimState3(
        p=torch.zeros((b, d, h, w), dtype=torch.float32, device=device),
        U=t(U_bc.copy()),
        flags=empty_domain3(b, d, h, w, device=device),
        density=t(rho_bc.copy()),
        U_bc=t(U_bc), U_bc_inv_mask=t(U_inv), density_bc=t(rho_bc),
        density_bc_inv_mask=t(rho_inv))
