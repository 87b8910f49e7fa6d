"""The buoyant-plume, Rayleigh-Taylor and cylinder scenes, the obstacle
rasterisers and the scenes' configs (twins of the JAX package's
``sim/scenes.py``)."""
import math

import numpy as np
import torch

from ..celltype import OBSTACLE, STICK
from ..config import SimConfig
from ..state import create_state


def create_plume_scene(res_x: int, res_y: int, density_val: float = 1.0,
                       u_scale: float = 1.0, rad: float = 0.2,
                       batch: int = 1, device="cpu"):
    """Bottom-wall inlet disc blowing upward: in rows 0..3 the velocity is
    pinned to (0, u_scale) inside the disc and to 0 outside it; density is
    pinned to ``density_val`` inside the disc."""
    state = create_state(batch, res_y, res_x, device=device)
    center_x = res_x // 2
    plume_rad = math.floor(res_x * rad)
    xx = np.arange(res_x)
    inside_cols = (xx - center_x) ** 2 <= plume_rad * plume_rad
    rows = np.zeros(res_y, bool)
    rows[0:4] = True
    inside = rows[:, None] & inside_cols[None, :]
    in_rows = rows[:, None] & np.ones(res_x, bool)

    U_bc = np.zeros((batch, 2, res_y, res_x), np.float32)
    U_bc[:, 1][:, inside] = u_scale
    U_bc_inv = np.ones((batch, 2, res_y, res_x), np.float32)
    U_bc_inv[:, :, in_rows] = 0.0
    rho_bc = np.zeros((batch, res_y, res_x), np.float32)
    rho_bc[:, inside] = density_val
    rho_bc_inv = np.ones((batch, res_y, res_x), np.float32)
    rho_bc_inv[:, inside] = 0.0

    def t(a):
        return torch.from_numpy(a).to(device)

    return state._replace(U_bc=t(U_bc), U_bc_inv_mask=t(U_bc_inv),
                          density_bc=t(rho_bc),
                          density_bc_inv_mask=t(rho_bc_inv))


def plume_config(**overrides) -> SimConfig:
    """Defaults of the shipped plume config."""
    base = dict(
        dt=0.1,
        maccormack_strength=0.6,
        buoyancy_scale=0.25,
        gravity_scale=0.0,
        gravity_vec=(0.0, -1.0, 0.0),
        operating_density=0.0,
        viscosity=0.0,
        p_tol=0.0,
        jacobi_iter=200,
        sim_method="jacobi",
    )
    base.update(overrides)
    return SimConfig(**base)


def create_rayleigh_taylor_scene(res_x: int, res_y: int, rho1: float = -0.01,
                                 rho2: float = 0.01,
                                 perturb_thickness: float = 100.0,
                                 perturb_amplitude: float = 0.01,
                                 height: float = 0.5, batch: int = 1,
                                 device="cpu"):
    """tanh density interface at ``height`` with a cosine perturbation;
    fluid at rest in a closed box, no inlet."""
    state = create_state(batch, res_y, res_x, device=device)
    X = np.arange(res_x, dtype=np.float32)[None, :]
    Y = np.arange(res_y, dtype=np.float32)[:, None]
    density = 0.5 * (
        rho2 + rho1
        + (rho2 - rho1)
        * np.tanh(
            perturb_thickness
            * (
                Y / res_y
                - (
                    height
                    + perturb_amplitude * np.cos(2 * math.pi * X / res_x)
                )
            )
        )
    ).astype(np.float32)
    density = np.repeat(density[None], batch, axis=0)
    return state._replace(density=torch.from_numpy(density).to(device))


def rayleigh_taylor_config(**overrides) -> SimConfig:
    """Defaults of the shipped Rayleigh-Taylor config: periodic in y."""
    base = dict(
        dt=0.5,
        maccormack_strength=0.6,
        buoyancy_scale=1.0,
        gravity_scale=0.0,
        gravity_vec=(0.0, 1.0, 0.0),
        p_tol=0.0,
        jacobi_iter=200,
        periodic_y=True,
        periodic_x=False,
        sim_method="jacobi",
    )
    base.update(overrides)
    return SimConfig(**base)


def _disc(h, w, center_x, center_y, radius, device):
    """(1, h, w) mask of the cells whose index lies within ``radius`` of the
    centre."""
    X = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    Y = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    return (X - center_x) ** 2 + (Y - center_y) ** 2 <= radius * radius


def add_cylinder(flags, center_x: float, center_y: float, radius: float):
    """Rasterise a solid disc into ``flags``."""
    _, h, w = flags.shape
    disc = _disc(h, w, center_x, center_y, radius, flags.device)
    return torch.where(disc, OBSTACLE, flags).to(torch.int32)


def add_box2d(flags, x0: int, x1: int, y0: int, y1: int):
    """Rasterise the solid box x0 <= x < x1, y0 <= y < y1 into ``flags``."""
    _, h, w = flags.shape
    X = torch.arange(w, device=flags.device)[None, None, :]
    Y = torch.arange(h, device=flags.device)[None, :, None]
    mask = (X >= x0) & (X < x1) & (Y >= y0) & (Y < y1)
    return torch.where(mask, OBSTACLE, flags).to(torch.int32)


def create_cylinder_scene(res_x: int = 8000, res_y: int = 800,
                          center_x: float = 500.0, center_y: float = None,
                          radius: float = 80.5, inlet_vel: float = 1.0,
                          reynolds: float = 100.0, batch: int = 1,
                          device="cpu"):
    """Flow past a no-slip (stick) disc with an inlet on the left wall.
    Returns (state, viscosity) with viscosity = |inlet_vel| * 2 radius /
    reynolds. ``flags_stick`` marks only the disc: the domain walls stay
    free-slip. The inlet pins U to (inlet_vel, 0) in columns 0..2 (rows
    1..res_y-2), and U starts as inlet_vel everywhere."""
    if center_y is None:
        center_y = res_y // 2
    state = create_state(batch, res_y, res_x, device=device)
    disc = _disc(res_y, res_x, center_x, center_y, radius, device)
    flags = torch.where(disc, OBSTACLE, state.flags).to(torch.int32)
    flags_stick = torch.where(disc, STICK, flags).to(torch.int32)

    X = np.arange(res_x)[None, :]
    Y = np.arange(res_y)[:, None]
    inlet = (X < 3) & (Y > 0) & (Y < res_y - 1)
    U_bc = np.zeros((batch, 2, res_y, res_x), np.float32)
    U_bc[:, 0][:, inlet] = inlet_vel
    U_bc_inv = np.ones((batch, 2, res_y, res_x), np.float32)
    U_bc_inv[:, :, inlet] = 0.0
    U0 = np.zeros((batch, 2, res_y, res_x), np.float32)
    U0[:, 0] = inlet_vel

    def t(a):
        return torch.from_numpy(a).to(device)

    viscosity = float(abs(inlet_vel) * radius * 2.0 / reynolds)
    state = state._replace(U=t(U0), flags=flags, flags_stick=flags_stick,
                           U_bc=t(U_bc), U_bc_inv_mask=t(U_bc_inv))
    return state, viscosity


def cylinder_config(viscosity: float, **overrides) -> SimConfig:
    """Defaults of the shipped cylinder config: viscosity from the Reynolds
    number, no density field (so no scalar advection), Jacobi-34."""
    base = dict(
        dt=0.1,
        maccormack_strength=0.6,
        buoyancy_scale=0.0,
        gravity_scale=0.0,
        viscosity=viscosity,
        p_tol=0.0,
        jacobi_iter=34,
        advect_density=False,
        sim_method="jacobi",
    )
    base.update(overrides)
    return SimConfig(**base)
