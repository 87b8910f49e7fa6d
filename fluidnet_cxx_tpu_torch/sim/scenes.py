"""The buoyant-plume and Rayleigh-Taylor scenes and their configs (twins of
the JAX package's ``sim/scenes.py``)."""
import math

import numpy as np
import torch

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
