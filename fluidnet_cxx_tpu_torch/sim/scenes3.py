"""The 3-D scenes (twins of the JAX package's ``sim/scenes3.py``).

``create_plume_scene3``: a circular inlet disc on the bottom wall (rows y
in [0, 4)) injects density and vertical velocity through const-BC masks
that the step re-imposes. ``create_cylinder_scene3``: flow past a
z-extruded cylinder with stick walls and a left-wall inlet, the first 3-D
scene with obstacles; it also returns the viscosity |u| 2r / Re.
"""
import numpy as np
import torch

from ..celltype import OBSTACLE, STICK
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


def create_cylinder_scene3(d: int = 32, h: int = 128, w: int = 384,
                           center_x: float = 64.0, center_y: float = None,
                           radius: float = 12.5, inlet_vel: float = 1.0,
                           reynolds: float = 100.0, device="cpu"):
    """Flow past a cylinder of ``radius`` at (center_x, center_y) spanning
    the full depth: OBSTACLE in ``flags``, STICK in ``flags_stick``; the
    inlet is the first three columns (x < 3) inside the border shell, its
    U held at (inlet_vel, 0, 0); U starts at inlet_vel everywhere.
    Returns (state, viscosity) with viscosity = |inlet_vel| 2 radius /
    reynolds."""
    if center_y is None:
        center_y = h // 2
    b = 1
    X = np.arange(w, dtype=np.float32)[None, :]
    Y = np.arange(h, dtype=np.float32)[:, None]
    cyl = np.broadcast_to(
        (X - np.float32(center_x)) ** 2 + (Y - np.float32(center_y)) ** 2
        <= np.float32(radius * radius), (b, d, h, w))
    cyl = torch.from_numpy(np.ascontiguousarray(cyl)).to(device)
    flags = torch.where(cyl, OBSTACLE, empty_domain3(b, d, h, w,
                                                     device=device))
    flags = flags.to(torch.int32)
    flags_stick = torch.where(cyl, STICK, flags).to(torch.int32)

    inlet = np.zeros((d, h, w), bool)
    inlet[1:-1, 1:-1, :3] = True
    U_bc = np.zeros((b, 3, d, h, w), np.float32)
    U_bc[:, 0][:, inlet] = inlet_vel
    U_inv = np.ones((b, 3, d, h, w), np.float32)
    U_inv[:, :, inlet] = 0.0
    U0 = np.zeros((b, 3, d, h, w), np.float32)
    U0[:, 0] = inlet_vel

    def t(a):
        return torch.from_numpy(a).to(device)

    viscosity = float(abs(inlet_vel) * radius * 2.0 / reynolds)
    state = SimState3(
        p=torch.zeros((b, d, h, w), dtype=torch.float32, device=device),
        U=t(U0), flags=flags,
        density=torch.zeros((b, d, h, w), dtype=torch.float32,
                            device=device),
        flags_stick=flags_stick, U_bc=t(U_bc), U_bc_inv_mask=t(U_inv))
    return state, viscosity
