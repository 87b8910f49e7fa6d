"""One 3-D simulation step (the port of the JAX package's
``sim/step3d.py::simulate_step3``), in the JAX step's order:

viscosity (``add_viscosity3`` of the pre-advection U: the field the
velocity advection carries) -> advection with ``max_disp`` cut to
``min(max_disp, 2)`` -> scalar correction -> inlet/const BCs ->
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

Advection follows the JAX step's dispatch. With ``use_pallas``, the
window engine, MacCormack and no viscosity, the JAX step runs its Pallas
kernels (the first-hit trace): here kernels L (merged, ``fuse_advection``
with ``advect_density``) or K (the density) and M (the velocity),
ops/kernels/advect3.py, at every shape. Otherwise it runs its XLA engines
with the config's method, engine and trace; of those the kernels compute
MacCormack on the window engine with the first-hit trace or none, K and M
(M with the viscous field as its ``orig``), and run them here. Euler and
the gather engine run both fields, and the march trace the density, on
the torch engines of ops/ops3d.py; the march traces the unclamped
displacement, as JAX's does.
"""
import warnings
from typing import NamedTuple, Optional

import torch

from ..ops.kernels.advect3 import (advect_all3, advect_scalar3,
                                   advect_velocity3)
from ..ops.kernels.jacobi3 import solve_jacobi3
from ..ops import ops3d
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


def _wall_bcs3(cfg, state, U, x0: int = 0, last=None):
    """Free-slip walls, then the periodic overrides: at the first interior
    layer of a periodic axis both tangential components take the last
    layer's values from before the wall BCs; then the stick walls when the
    state has ``flags_stick``. No free-slip walls under convnet (the
    projection's tail applies them); the stick walls apply under every
    method. ``x0`` and ``last`` as in ``sim/step.py::_wall_bcs``: on a
    slab along w, periodic_x writes the grid's layer 1 from ``last``, the
    grid's last layer of (v, w)."""
    if cfg.sim_method != "convnet":
        U_before = U
        U = set_wall_bcs3(U, state.flags)
        if cfg.periodic_x and 0 <= 1 - x0 < U.shape[-1]:
            U[:, 1:3, :, :, 1 - x0] = (U_before[:, 1:3, :, :, -1]
                                       if last is None else last)
        if cfg.periodic_y:
            for c in (0, 2):
                U[:, c, :, 1, :] = U_before[:, c, :, -1, :]
        if cfg.periodic_z:
            U[:, 0:2, 1, :, :] = U_before[:, 0:2, -1, :, :]
    if state.flags_stick is not None:
        U = set_wall_bcs_stick3(U, state.flags, state.flags_stick)
    return U


def torch_advection3(cfg):
    """(density, velocity): whether each field's advection runs on the
    torch engines (ops/ops3d.py) rather than kernels K, L and M, by the
    JAX step's dispatch (see the module's note)."""
    if cfg.advection_method == "eulerFluidNet":
        return True, True
    if cfg.advection_impl != "window":
        return True, True
    if cfg.use_pallas and cfg.viscosity == 0:
        return False, False
    return cfg.line_trace and cfg.line_trace_impl != "firsthit", False


def _warn_max_disp(cfg):
    """Warn once per process, as the JAX step does, that the 3-D window
    engine clamps per-axis displacements to 2 cells when ``max_disp`` asks
    for more."""
    global _warned_max_disp
    if (cfg.advection_impl == "window" and cfg.max_disp > MAX_DISP3
            and not _warned_max_disp):
        warnings.warn(
            f"3-D window advection bounds per-axis displacements to "
            f"{MAX_DISP3} cells (configured max_disp={cfg.max_disp}); "
            f"trajectories moving faster are clamped. Set max_disp="
            f"{MAX_DISP3} to silence, or advection_impl='gather' for "
            "unbounded displacements.", stacklevel=3)
        _warned_max_disp = True


def _advect3(cfg, state, orig):
    """Advected (rho, U): kernel L, or K (when the density is advected)
    and M (advecting ``orig``, the viscous field, when given), or the
    torch engines where ``torch_advection3`` says so."""
    flags, U, rho = state.flags, state.U, state.density
    on_torch_rho, on_torch_U = torch_advection3(cfg)
    kw = dict(maccormack_strength=cfg.maccormack_strength,
              max_disp=min(cfg.max_disp, MAX_DISP3))
    engine = dict(method=cfg.advection_method, impl=cfg.advection_impl)
    if (cfg.advect_density and cfg.fuse_advection and orig is None
            and not (on_torch_rho or on_torch_U)):
        rho, U_new = advect_all3(cfg.dt, rho, U, flags,
                                 line_trace=cfg.line_trace, **kw)
    else:
        if cfg.advect_density and on_torch_rho:
            rho = ops3d.advect_scalar3(
                cfg.dt, rho, U, flags, line_trace=cfg.line_trace,
                line_trace_impl=cfg.line_trace_impl, **kw, **engine)
        elif cfg.advect_density:
            rho = advect_scalar3(cfg.dt, rho, U, flags,
                                 line_trace=cfg.line_trace, **kw)
        if on_torch_U:
            U_new = ops3d.advect_velocity3(cfg.dt, U, flags, orig=orig,
                                           **kw, **engine)
        else:
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
