"""One simulation step (the port of the JAX package's ``sim/step.py::
simulate_step``), limited to the branches of the plume and Rayleigh-Taylor
scenes:

merged MacCormack advection of density and velocity from the same
pre-advection U (ops/kernels/advect.py; window engine, first-hit trace —
what the JAX step runs with ``use_pallas=True``) -> inlet/const BCs ->
buoyancy -> gravity -> pressure projection, one of:

* ``convnet`` with a projection that folds in the inlet BCs
  (``project_fn.handles_const_vals``);
* ``jacobi``: wall BCs (with the periodic overrides) -> const BCs ->
  divergence -> Jacobi (kernel F, ops/kernels/jacobi.py; the early-exit
  ``solve_jacobi`` when ``p_tol > 0``) -> velocity update -> wall BCs ->
  const BCs;
* ``multigrid``: the same frame around kernel H (ops/kernels/mg.py::
  project_mg: RHS, V-cycles, velocity update and wall BCs) or, with a
  periodic axis, divergence -> kernel G (``solve_mg``) -> velocity update.

Every other branch raises ``NotImplementedError`` naming its ROADMAP item.
"""
import numpy as np

from ..ops.jacobi import solve_jacobi as solve_jacobi_tol
from ..ops.kernels.advect import advect_all
from ..ops.kernels.jacobi import solve_jacobi
from ..ops.kernels.mg import project_mg, solve_mg
from ..ops.source_terms import add_buoyancy, add_gravity
from ..ops.stencils import set_wall_bcs, velocity_divergence, velocity_update


def apply_const_vals(state, U, density):
    """Re-impose inlet/constant BCs: x = x * inv_mask + bc."""
    if state.U_bc is not None:
        U = U * state.U_bc_inv_mask + state.U_bc
    if state.density_bc is not None:
        density = density * state.density_bc_inv_mask + state.density_bc
    return U, density


def _unsupported(cfg, state, project_fn):
    if cfg.viscosity > 0:
        return "viscosity (ROADMAP A.2)"
    if cfg.vorticity_confinement > 0 or cfg.correct_scalar:
        return "vorticity confinement / scalar correction (ROADMAP A.2)"
    if cfg.advection_method != "maccormackFluidNet" or \
            cfg.advection_impl != "window":
        return "Euler or gather advection (ROADMAP A.3)"
    if not (cfg.fuse_advection and cfg.advect_density):
        return "separate scalar/velocity advection kernels (ROADMAP B.1)"
    if cfg.sim_method not in ("convnet", "jacobi", "multigrid"):
        return f"the {cfg.sim_method} projection (ROADMAP A.8)"
    if cfg.sim_method == "convnet" and \
            not getattr(project_fn, "handles_const_vals", False):
        return "an unfused projection function (ROADMAP A.5)"
    if state.flags_stick is not None:
        return "stick walls (ROADMAP A.2)"
    return None


def _scaled_gravity(cfg, scale):
    g = np.asarray(cfg.gravity_vec, np.float32) * np.float32(-scale)
    return tuple(float(x) for x in g)


def _wall_bcs(cfg, state, U):
    """Free-slip walls, then the periodic overrides of the Rayleigh-Taylor
    scene: the first interior column's v (periodic_x) or row's u
    (periodic_y) takes the last column's or row's value from before the
    wall BCs. (The convnet projection applies its own walls.)"""
    U_before = U
    U = set_wall_bcs(U, state.flags)
    if cfg.periodic_x:
        U[:, 1, :, 1] = U_before[:, 1, :, -1]
    if cfg.periodic_y:
        U[:, 0, 1, :] = U_before[:, 0, -1, :]
    return U


def _project_classical(cfg, state, U, flags):
    """The jacobi or multigrid projection of U. Returns (p, U)."""
    if cfg.sim_method == "multigrid":
        # Warm start only with >= 2 V-cycles: one warm V-cycle per step is
        # unstable in closed loop (see the JAX step).
        p0 = state.p if (cfg.mg_warm_start and cfg.mg_vcycles >= 2) else None
        kw = dict(n_vcycles=cfg.mg_vcycles, pre=cfg.mg_pre, post=cfg.mg_post,
                  coarse_iters=cfg.mg_coarse_iters, p0=p0)
        if not (cfg.periodic_x or cfg.periodic_y):
            return project_mg(flags, U, **kw)
        p = solve_mg(flags, velocity_divergence(U, flags), **kw)
        return p, velocity_update(p, U, flags)
    div = velocity_divergence(U, flags)
    if cfg.p_tol > 0:
        p, _ = solve_jacobi_tol(flags, div, cfg.p_tol, cfg.jacobi_iter)
    else:
        p = solve_jacobi(flags, div, cfg.jacobi_iter)
    return p, velocity_update(p, U, flags)


def simulate_step(cfg, state, project_fn=None):
    """Advance by one dt. Returns the new state."""
    why = _unsupported(cfg, state, project_fn)
    if why is not None:
        raise NotImplementedError(f"not ported yet: {why}")
    flags = state.flags
    rho, U = advect_all(cfg.dt, state.density, state.U, flags,
                        maccormack_strength=cfg.maccormack_strength,
                        sample_outside_fluid=cfg.sample_outside_fluid,
                        max_disp=cfg.max_disp, line_trace=cfg.line_trace)
    U, rho = apply_const_vals(state, U, rho)
    if cfg.buoyancy_scale > 0:
        U = add_buoyancy(U, flags, rho,
                         _scaled_gravity(cfg, cfg.buoyancy_scale),
                         cfg.operating_density, cfg.dt)
    if cfg.gravity_scale > 0:
        U = add_gravity(U, flags, _scaled_gravity(cfg, cfg.gravity_scale),
                        cfg.dt)
    if cfg.sim_method == "convnet":
        # The projection applies U's const BCs on its input and output;
        # rho's were applied above and are idempotent.
        p, U = project_fn(state.p, U, flags, rho, U_bc=state.U_bc,
                          U_bc_inv_mask=state.U_bc_inv_mask)
        return state._replace(p=p, U=U, density=rho)
    U = _wall_bcs(cfg, state, U)
    U, rho = apply_const_vals(state, U, rho)
    p, U = _project_classical(cfg, state, U, flags)
    U = _wall_bcs(cfg, state, U)
    U, rho = apply_const_vals(state, U, rho)
    return state._replace(p=p, U=U, density=rho)
