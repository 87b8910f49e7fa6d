"""Width-sharded simulation steps: ``simulate_step_sharded`` (2-D) and
``simulate_step3_sharded`` (3-D), the twins of what the JAX package runs
under GSPMD with the state's width over the mesh's sx axis
(``tests/test_parallel.py``, ``__graft_entry__.py::dryrun_multichip``).

Each rank holds its slab of the state (``parallel/mesh.py::
state_sharding``). A step is

1. one ghost-zone exchange of every field the step reads before its
   projection (U, density, flags, the stick flags and the BC arrays),
   ``step_halo(cfg)`` columns on each side, 2 max_disp + 9: the step's
   reach (viscosity 1, MacCormack's forward and backward traces
   2 (max_disp + 1), buoyancy 1, vorticity confinement 3, the wall BCs 1)
   and the column its tail reads;
2. the single-device step (``sim/step.py``, ``sim/step3d.py``) on the
   padded slab up to its projection, then its wall BCs (``_wall_bcs``,
   ``_wall_bcs3``, told the slab's place in the grid), const BCs and
   divergence there; kernels A, D and E (K, L and M in 3-D) run on the
   padded slab as on a whole grid;
3. the projection on the owned columns: ``parallel/halo.py::
   solve_jacobi_sharded`` on kernel F (``solve_jacobi3_sharded`` on
   kernel I), or with ``p_tol > 0`` the early exit with its residual
   reduced over the mesh;
4. an exchange of 2 columns of p, then the velocity update, the wall BCs
   and the const BCs on the owned columns and those 2, and the crop.

A slab on a global domain edge has no halo on that side, so the border
ring, the window's clamp at the array's edge and the first-hit trace's
box behave there as on one device. The periodic override of x (the first
interior column takes the last column's v) reads the global last column,
broadcast from the last rank of the sx group.

The result is the single-device step to the bit where the back-traced
positions round alike, and not always otherwise. The advection kernels and
their plain versions trace in absolute cell coordinates, x + 0.5 - dt u,
and a slab's coordinates are its own: the same position rounds at another
magnitude, up to half an ulp of the global x-coordinate apart (2^-18
cells at x < 64, 2^-11 at x < 8000). A sample moves by that times the
field's slope; where a position lies that close to a cell face, the
limiter's neighbourhood is another cell's and the value changes by the
field's local spread. The Jacobi solve and every stencil are exact, and
with displacements that round alike in any coordinates (multiples of
1/8 and no line trace) the step is exact, which is how
``tests/test_torch_parallel_step.py`` (on the CPU) and ``chip_smoke.py``
(on the card) hold the halo's reach.

Not in this slice: ``sim_method`` "multigrid" and "convnet" under sx > 1
(the sharded V-cycle's coarse levels and the learned projection's
per-layer conv halos, ROADMAP A.8.1), and the gather engine, whose reach
is not bounded by ``max_disp``; each raises ``NotImplementedError``.
Under dp alone (sx = 1) every step is the single-device step of the
rank's batch.
"""
import torch
import torch.distributed as dist

from ..ops.ops3d import velocity_divergence3, velocity_update3
from ..ops.stencils import velocity_divergence, velocity_update
from ..sim.step import _wall_bcs, apply_const_vals, simulate_step
from ..sim.step3d import MAX_DISP3, _wall_bcs3, simulate_step3
from .halo import (crop, pad_columns, solve_jacobi3_sharded,
                   solve_jacobi_sharded, solve_jacobi_tol_sharded)

# Columns of p the step's tail reads on each side of an owned cell (the
# velocity update at a neighbour of the stick walls).
TAIL = 2


def step_halo(cfg, three_d: bool = False) -> int:
    """Halo columns a step of ``cfg`` reads, along its longest chain of
    dependencies from an owned cell back to the state: 1 for the tail (the
    stick walls read the updated velocity of the next column; the
    divergence reads the next column too), 1 for the wall BCs before the
    projection, 3 for vorticity confinement, 1 for buoyancy, 2 (D + 1) for
    MacCormack's forward and backward traces on the window engine (D =
    max_disp, at most 2 in 3-D; the limiter and the scalar correction read
    within them) and 1 for the viscous field."""
    D = min(cfg.max_disp, MAX_DISP3) if three_d else cfg.max_disp
    return 1 + 1 + 3 + 1 + 2 * (D + 1) + 1


def check_sharded(cfg, mesh):
    """Raise ``NotImplementedError`` for what the width-sharded step does
    not run (sx > 1)."""
    if mesh.sx == 1:
        return
    if cfg.sim_method in ("multigrid", "convnet"):
        raise NotImplementedError(
            f"sim_method {cfg.sim_method!r} under sx = {mesh.sx}: the "
            "sharded V-cycle's coarse levels and the learned projection's "
            "per-layer conv halos are ROADMAP A.8.1; under dp alone (sx = "
            "1) the step runs")
    if cfg.advection_impl != "window":
        raise NotImplementedError(
            f"advection_impl {cfg.advection_impl!r} under sx = {mesh.sx}: "
            "its reach is not bounded by max_disp, so no fixed halo holds "
            "it (ROADMAP A.8.1); the sharded step runs the window engine")


def _periodic_source(cfg, mesh, U, three_d):
    """Under periodic_x, the grid's last column of the tangential
    velocity, broadcast from the last rank of the sx group (its slab's
    last column); else None."""
    if not cfg.periodic_x:
        return None
    col = (U[:, 1:3, ..., -1] if three_d else U[:, 1, :, -1]).contiguous()
    dist.broadcast(col, src=mesh.rank_of(mesh.dp_index, mesh.sx - 1),
                   group=mesh.row)
    return col


def _pad_state(mesh, state, g):
    """The state's fields but p with ``g`` halo columns; p is a zero
    placeholder (the step reads it only in the projections that do not
    run sharded). Returns (padded state, left width)."""
    names = [n for n in state._fields
             if n != "p" and getattr(state, n) is not None]
    padded, lw, _ = pad_columns(mesh, [getattr(state, n) for n in names], g)
    fields = dict(zip(names, padded))
    fields["p"] = torch.zeros_like(fields["density"])
    return state._replace(**fields), lw


def _sharded(cfg, state, mesh, three_d):
    check_sharded(cfg, mesh)
    wl = state.flags.shape[-1]
    x_own = mesh.sx_index * wl
    pad, lw = _pad_state(mesh, state, step_halo(cfg, three_d))
    step = simulate_step3 if three_d else simulate_step
    s = step(cfg, pad, output_div=True)
    walls = _wall_bcs3 if three_d else _wall_bcs
    U = walls(cfg, pad, s.U, x_own - lw,
              _periodic_source(cfg, mesh, s.U, three_d))
    U, rho = apply_const_vals(pad, U, s.density)
    div = (velocity_divergence3 if three_d else velocity_divergence)(
        U, pad.flags)
    flags = crop(pad.flags, lw, wl)
    div = crop(div, lw, wl)
    if three_d:
        p = solve_jacobi3_sharded(flags, div, cfg.jacobi_iter, mesh)
    elif cfg.p_tol > 0:
        p, _ = solve_jacobi_tol_sharded(flags, div, cfg.p_tol,
                                        cfg.jacobi_iter, mesh)
    else:
        p = solve_jacobi_sharded(flags, div, cfg.jacobi_iter, mesh)

    # The tail on the owned columns and TAIL columns each side.
    (p2,), l2, r2 = pad_columns(mesh, [p], TAIL)
    a, b = lw - l2, lw + wl + r2
    tail = pad._replace(**{n: getattr(pad, n)[..., a:b].contiguous()
                           for n in pad._fields
                           if getattr(pad, n) is not None and n != "p"})
    U = U[..., a:b]
    rho = rho[..., a:b]
    update = velocity_update3 if three_d else velocity_update
    U = update(p2, U, tail.flags)
    U = walls(cfg, tail, U, x_own - l2,
              _periodic_source(cfg, mesh, U, three_d))
    U, rho = apply_const_vals(tail, U, rho)
    return state._replace(p=p, U=crop(U, l2, wl), density=crop(rho, l2, wl))


def simulate_step_sharded(cfg, state, mesh, project_fn=None):
    """One 2-D step of this rank's slab of ``state`` (``SimState``, batch
    over dp, width over sx). Under sx = 1 the single-device step of the
    rank's batch (every projection, ``project_fn`` for convnet)."""
    if mesh.sx == 1:
        return simulate_step(cfg, state, project_fn)
    return _sharded(cfg, state, mesh, False)


def simulate_step3_sharded(cfg, state, mesh, project_fn=None):
    """One 3-D step of this rank's slab of ``state`` (``SimState3``, width
    w over sx). Under sx = 1 the single-device step."""
    if mesh.sx == 1:
        return simulate_step3(cfg, state, project_fn)
    return _sharded(cfg, state, mesh, True)
