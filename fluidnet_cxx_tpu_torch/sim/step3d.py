"""One 3-D simulation step (the port of the JAX package's
``sim/step3d.py::simulate_step3``), in the JAX step's order:

viscosity (``add_viscosity3`` of the pre-advection U: the field the
velocity advection carries) -> MacCormack advection on the window engine
with the per-axis displacement bound ``min(max_disp, 2)``: merged (kernel
L, ``fuse_advection`` with ``advect_density`` and no viscosity) or
separate (kernel K for the density when ``advect_density``, then kernel M
for the velocity, with the viscous field as its ``orig``), all in
ops/kernels/advect3.py -> scalar correction -> inlet/const BCs ->
buoyancy -> gravity -> vorticity confinement -> (``output_div`` returns
here) -> wall BCs (free-slip with the periodic overrides, then the stick
walls of ``flags_stick``) -> const BCs -> projection -> wall BCs -> const
BCs. The projection is divergence -> Jacobi (kernel I, ops/kernels/
jacobi3.py; every ``sim_method`` but convnet and multigrid, as in the JAX
step) or ``solve_mg3`` (ops/multigrid.py, its sweeps on kernel I) ->
velocity update, or for ``convnet`` the caller's ``project_fn``
(models/punet3d.py: ``make_project_fn3``, the flax path, or
``make_project_fn3_fused_forward``), which applies the free-slip walls
itself: under convnet the step's own free-slip walls are skipped, as the
JAX step skips them; the stick walls still apply.

The kernels run the first-hit trace at every shape (what the JAX step runs
with ``use_pallas=True`` on its TPU-aligned shapes). Euler and gather
advection and the march trace raise ``NotImplementedError`` naming
ROADMAP A.6.
"""
import warnings
from typing import NamedTuple, Optional

import torch

from ..ops.kernels.advect3 import (advect_all3, advect_scalar3,
                                   advect_velocity3)
from ..ops.kernels.jacobi3 import solve_jacobi3
from ..ops.multigrid import solve_mg3
from ..ops.ops3d import (add_buoyancy3, add_gravity3, add_viscosity3,
                         add_vorticity_confinement3, correct_scalar3,
                         empty_domain3, set_wall_bcs3, set_wall_bcs_stick3,
                         velocity_divergence3, velocity_update3)
from .step import _scaled_gravity, apply_const_vals

# The 3-D window engine's largest per-axis displacement, in cells.
MAX_DISP3 = 2
_warned_max_disp = False


class SimState3(NamedTuple):
    p: torch.Tensor        # (b, d, h, w)
    U: torch.Tensor        # (b, 3, d, h, w)
    flags: torch.Tensor    # (b, d, h, w) int32
    density: torch.Tensor  # (b, d, h, w)
    flags_stick: Optional[torch.Tensor] = None
    U_bc: Optional[torch.Tensor] = None
    U_bc_inv_mask: Optional[torch.Tensor] = None
    density_bc: Optional[torch.Tensor] = None
    density_bc_inv_mask: Optional[torch.Tensor] = None


def create_state3(b: int, d: int, h: int, w: int, device="cpu") -> SimState3:
    """Zeroed fields over an empty domain (fluid interior, obstacle wall)."""
    z = dict(dtype=torch.float32, device=device)
    return SimState3(p=torch.zeros((b, d, h, w), **z),
                     U=torch.zeros((b, 3, d, h, w), **z),
                     flags=empty_domain3(b, d, h, w, device=device),
                     density=torch.zeros((b, d, h, w), **z))


# Re-impose inlet/constant BCs, x = x * inv_mask + bc: the 2-D rule.
apply_const_vals3 = apply_const_vals


def _wall_bcs3(cfg, state, U):
    """Free-slip walls, then the periodic overrides: at the first interior
    layer of a periodic axis both tangential components take the last
    layer's values from before the wall BCs; then the stick walls when the
    state has ``flags_stick``. No free-slip walls under convnet (the
    projection's tail applies them); the stick walls apply under every
    method."""
    if cfg.sim_method != "convnet":
        U_before = U
        U = set_wall_bcs3(U, state.flags)
        if cfg.periodic_x:
            U[:, 1:3, :, :, 1] = U_before[:, 1:3, :, :, -1]
        if cfg.periodic_y:
            for c in (0, 2):
                U[:, c, :, 1, :] = U_before[:, c, :, -1, :]
        if cfg.periodic_z:
            U[:, 0:2, 1, :, :] = U_before[:, 0:2, -1, :, :]
    if state.flags_stick is not None:
        U = set_wall_bcs_stick3(U, state.flags, state.flags_stick)
    return U


def _unsupported(cfg):
    if cfg.advection_method != "maccormackFluidNet" or \
            cfg.advection_impl != "window":
        return "3-D Euler or gather advection (ROADMAP A.6)"
    if (cfg.advect_density and cfg.line_trace
            and cfg.line_trace_impl == "march"
            and (not cfg.use_pallas or cfg.viscosity > 0)):
        # What the JAX step runs on its XLA path (which it also takes with
        # viscosity); the kernels run the first-hit trace, which the JAX
        # step runs with use_pallas=True.
        return "the 3-D march line trace of the XLA path (ROADMAP A.6)"
    return None


def _warn_max_disp(cfg):
    """Warn once per process, as the JAX step does, that the 3-D window
    engine clamps per-axis displacements to 2 cells when ``max_disp`` asks
    for more."""
    global _warned_max_disp
    if cfg.max_disp > MAX_DISP3 and not _warned_max_disp:
        warnings.warn(
            f"3-D window advection bounds per-axis displacements to "
            f"{MAX_DISP3} cells (configured max_disp={cfg.max_disp}); "
            f"trajectories moving faster are clamped. Set max_disp="
            f"{MAX_DISP3} to silence.", stacklevel=3)
        _warned_max_disp = True


def _advect3(cfg, state, orig):
    """Advected (rho, U): kernel L, or K (when the density is advected)
    and M (advecting ``orig``, the viscous field, when given)."""
    flags, U, rho = state.flags, state.U, state.density
    kw = dict(maccormack_strength=cfg.maccormack_strength,
              max_disp=min(cfg.max_disp, MAX_DISP3))
    if cfg.advect_density and cfg.fuse_advection and orig is None:
        rho, U_new = advect_all3(cfg.dt, rho, U, flags,
                                 line_trace=cfg.line_trace, **kw)
    else:
        if cfg.advect_density:
            rho = advect_scalar3(cfg.dt, rho, U, flags,
                                 line_trace=cfg.line_trace, **kw)
        U_new = advect_velocity3(cfg.dt, U, flags, orig=orig, **kw)
    if cfg.advect_density and cfg.correct_scalar:
        # The correction's divergence is the pre-advection U's.
        rho = correct_scalar3(cfg.dt, rho, velocity_divergence3(U, flags),
                              flags)
    return rho, U_new


def simulate_step3(cfg, state, project_fn=None, output_div: bool = False):
    """Advance by one dt. Returns the new state. ``project_fn(p, U, flags,
    density) -> (p, U)`` is the convnet projection (ignored by the other
    methods, as in the JAX step). ``output_div`` returns the divergent
    state before the wall BCs and the projection (the training input)."""
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(f"not ported yet: {why}")
    _warn_max_disp(cfg)
    flags = state.flags
    orig = (add_viscosity3(cfg.dt, state.U, flags, cfg.viscosity)
            if cfg.viscosity > 0 else None)
    rho, U = _advect3(cfg, state, orig)
    U, rho = apply_const_vals3(state, U, rho)
    if cfg.buoyancy_scale > 0:
        U = add_buoyancy3(U, flags, rho, _scaled_gravity(
            cfg.gravity_vec, cfg.buoyancy_scale), cfg.operating_density,
            cfg.dt)
    if cfg.gravity_scale > 0:
        U = add_gravity3(U, flags, _scaled_gravity(cfg.gravity_vec,
                                                   cfg.gravity_scale), cfg.dt)
    if cfg.vorticity_confinement > 0:
        U = add_vorticity_confinement3(U, flags, cfg.vorticity_confinement,
                                       cfg.dt)
    if output_div:
        return state._replace(U=U, density=rho)
    U = _wall_bcs3(cfg, state, U)
    U, rho = apply_const_vals3(state, U, rho)
    if cfg.sim_method == "convnet":
        if project_fn is None:
            raise ValueError("the convnet projection needs a project_fn")
        p, U = project_fn(state.p, U, flags, rho)
    elif cfg.sim_method == "multigrid":
        # A single warm V-cycle is unstable (the JAX step's rule); the
        # depth cap and 8 post sweeps keep the closed loop stable.
        warm = cfg.mg_warm_start and cfg.mg_vcycles >= 2
        p = solve_mg3(flags, velocity_divergence3(U, flags),
                      n_vcycles=cfg.mg_vcycles, pre=cfg.mg_pre,
                      post=cfg.mg_post3, coarse_iters=cfg.mg_coarse_iters,
                      p0=state.p if warm else None,
                      max_levels=cfg.mg_max_levels3)
        U = velocity_update3(p, U, flags)
    else:
        p = solve_jacobi3(flags, velocity_divergence3(U, flags),
                          cfg.jacobi_iter)
        U = velocity_update3(p, U, flags)
    U = _wall_bcs3(cfg, state, U)
    U, rho = apply_const_vals3(state, U, rho)
    return state._replace(p=p, U=U, density=rho)
