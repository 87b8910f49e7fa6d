"""One simulation step (the port of the JAX package's ``sim/step.py::
simulate_step``), limited to the branches of the learned-projection plume:

merged MacCormack advection of density and velocity from the same
pre-advection U (ops/kernels/advect.py; window engine, first-hit trace —
what the JAX step runs with ``use_pallas=True``) -> inlet/const BCs ->
buoyancy -> gravity -> learned projection with the inlet BCs folded in
(``project_fn.handles_const_vals``).

Every other branch raises ``NotImplementedError`` naming its ROADMAP item.
"""
import numpy as np

from ..ops.kernels.advect import advect_all
from ..ops.source_terms import add_buoyancy, add_gravity


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
        return "separate scalar/velocity advection kernels (ROADMAP B.2)"
    if cfg.sim_method == "jacobi":
        return "the Jacobi projection (ROADMAP B.1, A.4)"
    if cfg.sim_method != "convnet":
        return f"the {cfg.sim_method} projection (ROADMAP A.8, B.3)"
    if not getattr(project_fn, "handles_const_vals", False):
        return "an unfused projection function (ROADMAP A.5)"
    if state.flags_stick is not None:
        return "stick walls (ROADMAP A.2)"
    return None


def _scaled_gravity(cfg, scale):
    g = np.asarray(cfg.gravity_vec, np.float32) * np.float32(-scale)
    return tuple(float(x) for x in g)


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
    # The projection applies U's const BCs on its input and output; rho's
    # were applied above and are idempotent.
    p, U = project_fn(state.p, U, flags, rho, U_bc=state.U_bc,
                      U_bc_inv_mask=state.U_bc_inv_mask)
    return state._replace(p=p, U=U, density=rho)
