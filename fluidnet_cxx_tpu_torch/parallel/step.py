"""Width-sharded simulation steps: ``simulate_step_sharded`` (2-D) and
``simulate_step3_sharded`` (3-D), the twins of what the JAX package runs
under GSPMD with the state's width over the mesh's sx axis
(``tests/test_parallel.py``, ``__graft_entry__.py::dryrun_multichip``).

Each rank holds its slab of the state (``parallel/mesh.py::
state_sharding``). A step is

1. one ghost-zone exchange of every field the step reads before its
   projection (U, density, flags, the stick flags and the BC arrays),
   ``step_halo(cfg)`` columns on each side, 2 D + 9: the step's reach
   (viscosity 1, MacCormack's forward and backward traces 2 (D + 1),
   buoyancy 1, vorticity confinement 3, the wall BCs 1) and the column
   its tail reads. D is ``max_disp`` on the window engine; on the gather
   engine, whose reach no clamp bounds, the step's own largest
   displacement, ceil(dt max|U|) all-reduced with MAX over the sx group
   (``gather_disp``: one scalar a step);
2. the single-device step (``sim/step.py``, ``sim/step3d.py``) on the
   padded slab up to its projection, then its wall BCs (``_wall_bcs``,
   ``_wall_bcs3``, told the slab's place in the grid), const BCs and
   divergence there; kernels A, D and E (K, L and M in 3-D) run on the
   padded slab as on a whole grid;
3. the projection on the owned columns: ``parallel/halo.py::
   solve_jacobi_sharded`` on kernel F (``solve_jacobi3_sharded`` on
   kernel I), or with ``p_tol > 0`` the early exit with its residual
   reduced over the mesh; the V-cycles of ``parallel/multigrid.py`` on
   kernels G and H (``solve_mg3_sharded`` in 3-D); or the learned
   projection the caller passes, on a second exchange of the divergent
   state as wide as its receptive field (``parallel/project.py``; the
   fused branch, ``handles_const_vals`` without stick walls, and the
   unfused one, as ``sim/step.py`` runs them);
4. an exchange of 2 columns of p, then the velocity update (kernel H's
   epilogue under multigrid; the projection's own for convnet), the wall
   BCs and the const BCs on the owned columns and those 2, and the crop.

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

A convnet ``project_fn`` must say how to shard it (its ``kind``, set by
every projection factory: ``parallel/project.py::sharding_of``); one
without raises ``ValueError``. Under dp
alone (sx = 1) every step is the single-device step of the rank's batch.
"""
import math

import torch
import torch.distributed as dist

from ..ops.ops3d import velocity_divergence3, velocity_update3
from ..ops.stencils import velocity_divergence, velocity_update
from ..sim.step import (_fused_projection, _wall_bcs, apply_const_vals,
                        simulate_step)
from ..sim.step3d import MAX_DISP3, _wall_bcs3, simulate_step3
from .halo import (crop, pad_columns, solve_jacobi3_sharded,
                   solve_jacobi_sharded, solve_jacobi_tol_sharded)
from .multigrid import (mg_epilogue_sharded, solve_mg3_sharded,
                        solve_mg_raw, solve_mg_sharded)
from .project import project_sharded, sharding_of

# Columns of p the step's tail reads on each side of an owned cell (the
# velocity update at a neighbour of the stick walls).
TAIL = 2


def step_halo(cfg, three_d: bool = False, disp: int = None) -> int:
    """Halo columns a step of ``cfg`` reads, along its longest chain of
    dependencies from an owned cell back to the state: 1 for the tail (the
    stick walls read the updated velocity of the next column; the
    divergence reads the next column too), 1 for the wall BCs before the
    projection, 3 for vorticity confinement, 1 for buoyancy, 2 (D + 1) for
    MacCormack's forward and backward traces (the limiter and the scalar
    correction read within them) and 1 for the viscous field. D is
    max_disp on the window engine (at most 2 in 3-D); on the gather
    engine, whose reach no clamp bounds, ``disp``: the step's largest
    displacement in cells (``gather_disp``)."""
    if cfg.advection_impl == "gather":
        if disp is None:
            raise ValueError("the gather engine's halo is the step's largest "
                             "displacement: pass disp (gather_disp)")
        D = disp
    else:
        D = min(cfg.max_disp, MAX_DISP3) if three_d else cfg.max_disp
    return 1 + 1 + 3 + 1 + 2 * (D + 1) + 1


def gather_disp(mesh, U, dt: float) -> int:
    """ceil(dt max|U|) over the whole grid: this rank's owned cells,
    all-reduced with MAX over the sx group (one scalar a step). Every
    semi-Lagrangian trace of the step moves at most that far, and with
    the line trace on the march walks no farther."""
    top = (U.abs().amax() if U.numel() else U.new_zeros(())).reshape(1)
    top = top.to(torch.float32) * float(abs(dt))
    if mesh.sx > 1:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.row)
    v = float(top)
    if not math.isfinite(v):
        raise ValueError(f"the gather engine's displacement is {v}")
    return int(math.ceil(v))


def check_sharded(cfg, mesh, project_fn=None):
    """Raise ``ValueError`` for a convnet step without a projection that
    says how to shard it (``parallel/project.py::sharding_of``)."""
    if mesh.sx == 1 or cfg.sim_method != "convnet":
        return
    if project_fn is None:
        raise ValueError("the convnet projection needs a project_fn")
    sharding_of(project_fn)


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
    placeholder (the step reads it only in the projections, which take
    the owned p). Returns (padded state, left width)."""
    names = [n for n in state._fields
             if n != "p" and getattr(state, n) is not None]
    padded, lw, _ = pad_columns(mesh, [getattr(state, n) for n in names], g)
    fields = dict(zip(names, padded))
    fields["p"] = torch.zeros_like(fields["density"])
    return state._replace(**fields), lw


def _owned(pad, lw, wl, state, U, rho):
    """The projection's inputs: this rank's p and the owned columns of the
    divergent state."""
    f = {n: crop(getattr(pad, n), lw, wl) for n in
         ("flags", "U_bc", "U_bc_inv_mask")
         if n in pad._fields and getattr(pad, n) is not None}
    return dict(f, p=state.p, U=crop(U, lw, wl), density=crop(rho, lw, wl))


def _finish(cfg, mesh, state, pad, lw, wl, x_own, U, rho, l2, r2, three_d):
    """The wall and const BCs on the owned columns and ``l2``/``r2`` more
    (``U`` holds that window, ``rho`` the padded slab's), then the crop."""
    a, b = lw - l2, lw + wl + r2
    tail = pad._replace(**{n: getattr(pad, n)[..., a:b].contiguous()
                           for n in pad._fields
                           if getattr(pad, n) is not None and n != "p"})
    walls = _wall_bcs3 if three_d else _wall_bcs
    U = walls(cfg, tail, U, x_own - l2,
              _periodic_source(cfg, mesh, U, three_d))
    U, rho = apply_const_vals(tail, U, rho[..., a:b])
    return crop(U, l2, wl), crop(rho, l2, wl)


def _sharded(cfg, state, mesh, three_d, project_fn=None, dyn=None):
    check_sharded(cfg, mesh, project_fn)
    wl = state.flags.shape[-1]
    x_own = mesh.sx_index * wl
    disp = None
    if cfg.advection_impl == "gather":
        disp = gather_disp(mesh, state.U, cfg.dt if dyn is None else dyn.dt)
    pad, lw = _pad_state(mesh, state, step_halo(cfg, three_d, disp))
    if three_d:
        s = simulate_step3(cfg, pad, output_div=True)
    else:
        s = simulate_step(cfg, pad, output_div=True, dyn=dyn)
    if not three_d and _fused_projection(cfg, state, project_fn):
        p, U, _, _ = project_sharded(project_fn, mesh,
                                     _owned(pad, lw, wl, state, s.U,
                                            s.density), fused=True)
        return state._replace(p=p, U=U, density=crop(s.density, lw, wl))
    walls = _wall_bcs3 if three_d else _wall_bcs
    U = walls(cfg, pad, s.U, x_own - lw,
              _periodic_source(cfg, mesh, s.U, three_d))
    U, rho = apply_const_vals(pad, U, s.density)
    if cfg.sim_method == "convnet":
        p, U, l2, r2 = project_sharded(project_fn, mesh,
                                       _owned(pad, lw, wl, state, U, rho),
                                       out_halo=TAIL)
        U, rho = _finish(cfg, mesh, state, pad, lw, wl, x_own, U, rho,
                             l2, r2, three_d)
        return state._replace(p=p, U=U, density=rho)
    div = (velocity_divergence3 if three_d else velocity_divergence)(
        U, pad.flags)
    flags = crop(pad.flags, lw, wl)
    div = crop(div, lw, wl)
    if cfg.sim_method == "multigrid":
        warm = state.p if (cfg.mg_warm_start and cfg.mg_vcycles >= 2) \
            else None
        kw = dict(n_vcycles=cfg.mg_vcycles, pre=cfg.mg_pre,
                  coarse_iters=cfg.mg_coarse_iters, p0=warm)
        if three_d:
            p = solve_mg3_sharded(mesh, flags, div, post=cfg.mg_post3,
                                  max_levels=cfg.mg_max_levels3, **kw)
        elif cfg.periodic_x or cfg.periodic_y:
            p = solve_mg_sharded(mesh, flags, div, post=cfg.mg_post, **kw)
        else:
            # Kernel H: its epilogue's update and walls on the window.
            _, p_raw, sums = solve_mg_raw(mesh, flags, div,
                                          post=cfg.mg_post, **kw)
            p, U, l2, r2 = mg_epilogue_sharded(mesh, pad.flags, U, lw,
                                               p_raw, sums, TAIL)
            U, rho = _finish(cfg, mesh, state, pad, lw, wl, x_own, U,
                                 rho, l2, r2, three_d)
            return state._replace(p=p, U=U, density=rho)
    elif three_d:
        p = solve_jacobi3_sharded(flags, div, cfg.jacobi_iter, mesh)
    elif cfg.p_tol > 0:
        p, _ = solve_jacobi_tol_sharded(flags, div, cfg.p_tol,
                                        cfg.jacobi_iter, mesh)
    else:
        p = solve_jacobi_sharded(flags, div, cfg.jacobi_iter, mesh)

    # The tail on the owned columns and TAIL columns each side.
    (p2,), l2, r2 = pad_columns(mesh, [p], TAIL)
    a, b = lw - l2, lw + wl + r2
    update = velocity_update3 if three_d else velocity_update
    U = update(p2, U[..., a:b], pad.flags[..., a:b])
    U, rho = _finish(cfg, mesh, state, pad, lw, wl, x_own, U, rho, l2,
                         r2, three_d)
    return state._replace(p=p, U=U, density=rho)


def simulate_step_sharded(cfg, state, mesh, project_fn=None, dyn=None):
    """One 2-D step of this rank's slab of ``state`` (``SimState``, batch
    over dp, width over sx), with the ``project_fn`` a user passes to
    ``simulate_step`` for convnet (one that carries its ``kind``),
    and ``dyn`` as there. Under sx = 1 the single-device step of the
    rank's batch."""
    if mesh.sx == 1:
        return simulate_step(cfg, state, project_fn, dyn=dyn)
    return _sharded(cfg, state, mesh, False, project_fn, dyn)


def simulate_step3_sharded(cfg, state, mesh, project_fn=None):
    """One 3-D step of this rank's slab of ``state`` (``SimState3``, width
    w over sx). Under sx = 1 the single-device step."""
    if mesh.sx == 1:
        return simulate_step3(cfg, state, project_fn)
    return _sharded(cfg, state, mesh, True, project_fn)
