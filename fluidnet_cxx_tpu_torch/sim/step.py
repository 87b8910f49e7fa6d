"""One simulation step (the port of the JAX package's ``sim/step.py::
simulate_step``), in the JAX step's order:

viscosity (the viscous field ``orig`` that U advects) -> advection ->
scalar correction -> inlet/const BCs -> buoyancy -> gravity -> vorticity
confinement -> pressure projection, one of:

* ``convnet`` with a projection that folds in the inlet BCs
  (``project_fn.handles_const_vals``) and no stick walls; otherwise
  (an unfused projection such as ``models/mg_coarse.py::
  make_project_fn_mg_learned``, or a scene with stick walls) the stick
  walls (if any) -> const BCs -> ``project_fn(p, U, flags, density)`` ->
  stick walls -> const BCs;
* ``jacobi``: wall BCs -> const BCs -> divergence -> Jacobi (kernel F,
  ops/kernels/jacobi.py; the early-exit ``solve_jacobi`` when
  ``p_tol > 0``) -> velocity update -> wall BCs -> const BCs;
* ``multigrid``: the same frame around kernel H (ops/kernels/mg.py::
  project_mg: RHS, V-cycles, velocity update and wall BCs) or, with a
  periodic axis, divergence -> kernel G (``solve_mg``) -> velocity update.

Advection follows the JAX step's dispatch. With ``use_pallas`` (and no
``dyn``) the JAX step runs its Pallas kernels, MacCormack on the window
engine with the first-hit trace: here kernels A (merged,
``fuse_advection`` with ``advect_density``) or D (the density) and E (the
velocity), ops/kernels/advect.py, at every shape (ROADMAP C.1's residue).
Otherwise, and always for Euler, the JAX step runs its XLA engines with
the config's ``advection_method``, ``advection_impl`` and
``line_trace_impl``. Of those the kernels compute MacCormack on the window
engine with the first-hit trace or none (ROADMAP C.3), and run them here;
Euler and the gather engine run both fields, and the march trace the
density, on the torch engines of ops/advection.py (the velocity's
straight back-trace on the window engine stays on E). A config runs the
torch engines only because it asks for an engine no kernel computes.

The wall BCs are free-slip with the periodic overrides (in the jacobi and
multigrid projections), then the stick walls where the scene has
``flags_stick`` (in every projection), as in the JAX package (PARITY.md).

The training rollout's randomised physics (``train/trainer.py``) passes a
``DynParams``: its ``dt`` is then every term's dt (kernels A, D and E
included: the JAX step takes its XLA branch under ``dyn``, where dt is
``dyn.dt`` throughout) and the buoyancy and gravity are applied whatever
their scale, from ``dyn``'s gravity vector. ``output_div`` stops the step
before the projection (after vorticity confinement) and returns the
divergent state. A ``sim_method`` the step does not know raises, where
the JAX step would quietly run Jacobi.
"""
from typing import NamedTuple, Tuple

import numpy as np

from ..ops import advection as engines
from ..ops.jacobi import solve_jacobi as solve_jacobi_tol
from ..ops.kernels.advect import advect_all, advect_scalar, advect_velocity
from ..ops.kernels.jacobi import solve_jacobi
from ..ops.kernels.mg import project_mg, solve_mg
from ..ops.source_terms import (add_buoyancy, add_gravity, add_viscosity,
                                add_vorticity_confinement, correct_scalar)
from ..ops.stencils import (set_wall_bcs, set_wall_bcs_stick,
                            velocity_divergence, velocity_update)


class DynParams(NamedTuple):
    """Per-step physics overrides of the long-term rollout, Python floats
    that hold float32 values (drawn on the host: no device sync)."""
    dt: float
    buoyancy_scale: float
    gravity_scale: float
    gravity_vec: Tuple[float, float, float]


def apply_const_vals(state, U, density):
    """Re-impose inlet/constant BCs: x = x * inv_mask + bc."""
    if state.U_bc is not None:
        U = U * state.U_bc_inv_mask + state.U_bc
    if state.density_bc is not None:
        density = density * state.density_bc_inv_mask + state.density_bc
    return U, density


def _unsupported(cfg):
    if cfg.sim_method not in ("convnet", "jacobi", "multigrid"):
        # The JAX step would run Jacobi for it (its else branch).
        return (f"sim_method {cfg.sim_method!r}: the step runs convnet, "
                "jacobi or multigrid; for mg_learned pass the projection "
                "of models/mg_coarse.py::make_project_fn_mg_learned with "
                'sim_method="convnet", as the JAX scripts/run_plume.py does')
    return None


def torch_advection(cfg, dyn=None):
    """(density, velocity): whether each field's advection runs on the
    torch engines (ops/advection.py) rather than kernels A, D and E. The
    kernels compute MacCormack on the window engine with the first-hit
    trace or none: what the JAX step runs with ``use_pallas`` outside
    ``dyn`` (except for Euler), and on its XLA path with those choices."""
    if cfg.advection_method == engines.EULER:
        return True, True
    if cfg.use_pallas and dyn is None:
        return False, False
    if cfg.advection_impl != "window":
        return True, True
    return cfg.line_trace and cfg.line_trace_impl != "firsthit", False


def _fused_projection(cfg, state, project_fn):
    """The learned projection that folds in the inlet BCs, on a scene
    without stick walls (JAX's fused branch)."""
    return (cfg.sim_method == "convnet"
            and getattr(project_fn, "handles_const_vals", False)
            and state.flags_stick is None)


def _scaled_gravity(gravity_vec, scale):
    """gravity_vec * (-scale) in float32, as the JAX step computes it."""
    g = np.asarray(gravity_vec, np.float32) * np.float32(-scale)
    return tuple(float(x) for x in g)


def _wall_bcs(cfg, state, U):
    """Free-slip walls, except under the convnet projection (the JAX step
    skips them there: the learned projection applies its own after its
    velocity update); the periodic overrides of the Rayleigh-Taylor
    scene: the first interior column's v (periodic_x) or row's u
    (periodic_y) takes the last column's or row's value from before the
    wall BCs; then the stick walls where the scene has them (every
    projection)."""
    if cfg.sim_method != "convnet":
        U_before = U
        U = set_wall_bcs(U, state.flags)
        if cfg.periodic_x:
            U[:, 1, :, 1] = U_before[:, 1, :, -1]
        if cfg.periodic_y:
            U[:, 0, 1, :] = U_before[:, 0, -1, :]
    if state.flags_stick is not None:
        U = set_wall_bcs_stick(U, state.flags, state.flags_stick)
    return U


def _advect(cfg, state, orig, dt, dyn):
    """Advected (rho, U) over ``dt``: kernel A, or D (when the density is
    advected) and E, or the torch engines where ``torch_advection`` says
    so."""
    flags, U, rho = state.flags, state.U, state.density
    on_torch_rho, on_torch_U = torch_advection(cfg, dyn)
    kw = dict(maccormack_strength=cfg.maccormack_strength,
              max_disp=cfg.max_disp)
    scalar_kw = dict(kw, sample_outside_fluid=cfg.sample_outside_fluid,
                     line_trace=cfg.line_trace)
    engine = dict(method=cfg.advection_method, impl=cfg.advection_impl)
    if (cfg.advect_density and cfg.fuse_advection
            and not (on_torch_rho or on_torch_U)):
        rho, U_new = advect_all(dt, rho, U, flags, orig=orig, **scalar_kw)
    else:
        if cfg.advect_density and on_torch_rho:
            rho = engines.advect_scalar(
                dt, rho, U, flags, line_trace_impl=cfg.line_trace_impl,
                **scalar_kw, **engine)
        elif cfg.advect_density:
            rho = advect_scalar(dt, rho, U, flags, **scalar_kw)
        if on_torch_U:
            U_new = engines.advect_velocity(
                dt, U if orig is None else orig, U, flags, **kw, **engine)
        else:
            U_new = advect_velocity(dt, U, flags, orig=orig, **kw)
    if cfg.advect_density and cfg.correct_scalar:
        # The correction's divergence is the pre-advection U's.
        rho = correct_scalar(dt, rho, velocity_divergence(U, flags), flags)
    return rho, U_new


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


def simulate_step(cfg, state, project_fn=None, output_div=False, dyn=None):
    """Advance by one dt (``dyn.dt`` given a ``DynParams``). Returns the
    new state, or with ``output_div`` the divergent state before the
    projection."""
    why = _unsupported(cfg)
    if why is not None:
        raise NotImplementedError(why)
    if cfg.sim_method == "convnet" and project_fn is None and not output_div:
        raise ValueError("the convnet projection needs a project_fn")
    flags = state.flags
    dt = cfg.dt if dyn is None else dyn.dt
    orig = (add_viscosity(dt, state.U, flags, cfg.viscosity)
            if cfg.viscosity > 0 else None)
    rho, U = _advect(cfg, state, orig, dt, dyn)
    U, rho = apply_const_vals(state, U, rho)
    if dyn is not None:
        U = add_buoyancy(U, flags, rho, _scaled_gravity(
            dyn.gravity_vec, dyn.buoyancy_scale), cfg.operating_density, dt)
        U = add_gravity(U, flags, _scaled_gravity(dyn.gravity_vec,
                                                  dyn.gravity_scale), dt)
    else:
        if cfg.buoyancy_scale > 0:
            U = add_buoyancy(U, flags, rho, _scaled_gravity(
                cfg.gravity_vec, cfg.buoyancy_scale), cfg.operating_density,
                dt)
        if cfg.gravity_scale > 0:
            U = add_gravity(U, flags, _scaled_gravity(cfg.gravity_vec,
                                                      cfg.gravity_scale), dt)
    if cfg.vorticity_confinement > 0:
        U = add_vorticity_confinement(U, flags, cfg.vorticity_confinement,
                                      dt)
    if output_div:
        return state._replace(U=U, density=rho)
    if _fused_projection(cfg, state, project_fn):
        # The projection applies U's const BCs on its input and output;
        # rho's were applied above and are idempotent.
        p, U = project_fn(state.p, U, flags, rho, U_bc=state.U_bc,
                          U_bc_inv_mask=state.U_bc_inv_mask)
        return state._replace(p=p, U=U, density=rho)
    U = _wall_bcs(cfg, state, U)
    U, rho = apply_const_vals(state, U, rho)
    if cfg.sim_method == "convnet":
        p, U = project_fn(state.p, U, flags, rho)
    else:
        p, U = _project_classical(cfg, state, U, flags)
    U = _wall_bcs(cfg, state, U)
    U, rho = apply_const_vals(state, U, rho)
    return state._replace(p=p, U=U, density=rho)
