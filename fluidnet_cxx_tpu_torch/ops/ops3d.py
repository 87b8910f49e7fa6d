"""3-D MAC-grid ops of the classical step (twins of the JAX package's
``ops/ops3d.py``).

Layout: scalars ``(b, d, h, w)``; MAC velocity ``(b, 3, d, h, w)`` with
channels (u, v, w) on the x/y/z faces, x first; flags ``(b, d, h, w)``
int32; cell centres at ``idx + 0.5``. ``nb3`` is a circular roll, as in
the JAX package: every caller masks the wrapped border ring.

Advection is the window engine only (MacCormack, the first-hit trace):
the plain versions of kernels K (``advect_scalar3``) and M
(``advect_velocity3``), which sample their corners with direct gathers
(``ops/window3.py``). ``solve_jacobi_fixed3`` is the plain version of
kernel I, ``jacobi_adjoint_fixed3`` of its adjoint. ``add_viscosity3``,
``set_wall_bcs_stick3``, ``curl3`` and ``add_vorticity_confinement3`` are
torch code, as they are XLA in the JAX package; ``advect_velocity3(...,
orig=...)`` carries the viscous field.
"""
import torch

from ..celltype import EMPTY, FLUID, OBSTACLE, STICK
from .common import F32, I32, where0

_AXES = ((0, 0, 1), (0, 1, 0), (1, 0, 0))  # (dz, dy, dx) per channel
# The six neighbours in the Jacobi sweep's order: x-1, x+1, y-1, y+1, z-1,
# z+1, as (dz, dy, dx).
_NEIGHBOURS6 = ((0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0), (-1, 0, 0),
                (1, 0, 0))


def nb3(a, dz: int, dy: int, dx: int):
    """result[..., z, y, x] = a[..., z+dz, y+dy, x+dx] (circular)."""
    if dz == 0 and dy == 0 and dx == 0:
        return a
    return torch.roll(a, shifts=(-dz, -dy, -dx), dims=(-3, -2, -1))


def border_mask3(d: int, h: int, w: int, bnd: int = 1, device="cpu"):
    """Boolean (d, h, w) mask, True on the ``bnd``-wide border shell."""
    zz = torch.arange(d, dtype=I32, device=device)[:, None, None]
    yy = torch.arange(h, dtype=I32, device=device)[None, :, None]
    xx = torch.arange(w, dtype=I32, device=device)[None, None, :]
    return ((xx < bnd) | (xx > w - 1 - bnd) | (yy < bnd) | (yy > h - 1 - bnd)
            | (zz < bnd) | (zz > d - 1 - bnd))


def empty_domain3(b: int, d: int, h: int, w: int, bnd: int = 1,
                  device="cpu"):
    """Fresh flags: fluid interior, obstacle wall of width ``bnd``."""
    flags = torch.where(border_mask3(d, h, w, bnd, device), OBSTACLE, FLUID)
    return flags.to(I32)[None].expand(b, d, h, w).contiguous()


def index_grids3(b: int, d: int, h: int, w: int, device="cpu"):
    """Integer (z, y, x) index grids, each (b, d, h, w)."""
    shape = (b, d, h, w)
    zz = torch.arange(d, dtype=I32, device=device)[None, :, None, None]
    yy = torch.arange(h, dtype=I32, device=device)[None, None, :, None]
    xx = torch.arange(w, dtype=I32, device=device)[None, None, None, :]
    return zz.expand(shape), yy.expand(shape), xx.expand(shape)


def centers3(b: int, d: int, h: int, w: int, device="cpu"):
    """Cell centres (b, 3, d, h, w), channels (x, y, z)."""
    zz, yy, xx = index_grids3(b, d, h, w, device)
    return torch.stack([xx.to(F32) + 0.5, yy.to(F32) + 0.5,
                        zz.to(F32) + 0.5], dim=1)


def velocity_divergence3(U, flags):
    """Poisson RHS ``-div(U)`` per non-obstacle interior cell."""
    _, d, h, w = flags.shape
    u, v, wz = U[:, 0], U[:, 1], U[:, 2]
    rhs = ((u - nb3(u, 0, 0, 1)) + (v - nb3(v, 0, 1, 0))
           + (wz - nb3(wz, 1, 0, 0)))
    keep = (~border_mask3(d, h, w, 1, U.device)) & (flags != OBSTACLE)
    return where0(keep, rhs)


def velocity_update3(p, U, flags):
    """U' = U - grad(p) with the fluid/empty face rules; border faces are
    left untouched."""
    _, d, h, w = flags.shape
    fl = flags == FLUID
    em = flags == EMPTY
    interior = ~border_mask3(d, h, w, 1, U.device)
    outs = []
    for c, (dz, dy, dx) in enumerate(_AXES):
        fm = nb3(fl, -dz, -dy, -dx)
        e_m = nb3(em, -dz, -dy, -dx)
        p_m = nb3(p, -dz, -dy, -dx)
        vel = U[:, c]
        new = torch.where(fl & fm, vel - (p - p_m),
                          torch.where(fl & e_m, vel - p,
                                      where0(em & fm, vel + p_m)))
        outs.append(torch.where(interior, new, vel))
    return torch.stack(outs, dim=1)


def _clamped_back(a, dim):
    """Neighbour at index-1 along ``dim`` with the index clamped at 0."""
    first = a.narrow(dim, 0, 1)
    rest = a.narrow(dim, 0, a.shape[dim] - 1)
    return torch.cat([first, rest], dim=dim)


def set_wall_bcs3(U, flags):
    """Free-slip walls: zero the normal velocity on obstacle faces (the
    lower neighbour's index clamped at 0)."""
    fl = flags == FLUID
    ob = flags == OBSTACLE
    cont = fl | ob
    outs = []
    for c in range(3):
        dim = 3 - c   # the axis of (b, d, h, w): x 3, y 2, z 1
        kill = cont & (_clamped_back(ob, dim)
                       | (ob & _clamped_back(fl, dim)))
        outs.append(where0(~kill, U[:, c]))
    return torch.stack(outs, dim=1)


def _times_dt3(gravity, dt):
    """gravity * dt per axis, rounded to float32 as the JAX package's
    float32 ``gravity * dt`` is."""
    g = torch.tensor(gravity, dtype=F32) * torch.tensor(dt, dtype=F32)
    return [float(x) for x in g]


def add_buoyancy3(U, flags, density, gravity, rho_star, dt):
    """Boussinesq buoyancy on interior fluid faces whose lower neighbour is
    fluid. ``gravity`` is the caller's ``-scale * gravity_vec``."""
    _, d, h, w = flags.shape
    fl = flags == FLUID
    cont = fl & (~border_mask3(d, h, w, 1, U.device))
    strength = _times_dt3(gravity, dt)
    outs = []
    for c, (dz, dy, dx) in enumerate(_AXES):
        rho_m = nb3(density, -dz, -dy, -dx)
        fac = strength[c] * (0.5 * (density + rho_m) - rho_star)
        outs.append(torch.where(cont & nb3(fl, -dz, -dy, -dx),
                                U[:, c] + fac, U[:, c]))
    return torch.stack(outs, dim=1)


def add_gravity3(U, flags, gravity, dt):
    """Constant body force on interior faces between fluid/empty cells."""
    _, d, h, w = flags.shape
    fl = flags == FLUID
    em = flags == EMPTY
    cont = (fl | em) & (~border_mask3(d, h, w, 1, U.device))
    force = _times_dt3(gravity, dt)
    outs = []
    for c, (dz, dy, dx) in enumerate(_AXES):
        mask = cont & (nb3(fl, -dz, -dy, -dx)
                       | (nb3(em, -dz, -dy, -dx) & fl))
        outs.append(torch.where(mask, U[:, c] + force[c], U[:, c]))
    return torch.stack(outs, dim=1)


def jacobi3_masks(flags):
    """(cont, cnt): cells the sweep updates (interior, not obstacle) and
    the number of each cell's obstacle neighbours, as float32."""
    _, d, h, w = flags.shape
    ob = flags == OBSTACLE
    cont = (~border_mask3(d, h, w, 1, flags.device)) & (~ob)
    cnt = torch.zeros(flags.shape, dtype=F32, device=flags.device)
    for s in _NEIGHBOURS6:
        cnt = cnt + nb3(ob, *s).to(F32)
    return cont, cnt


def solve_jacobi_fixed3(flags, div, iters: int, p0=None,
                        damping: float = 1.0):
    """``iters`` 6-neighbour Jacobi sweeps with the obstacle-Neumann
    substitution; pressure pinned to 0 on the border shell and in
    obstacles. ``p0`` warm-starts the solve, ``damping`` < 1 blends
    (1-damping)*p + damping*update.

    The plain version of kernel I, in the float32 order of the TPU kernel
    (``jacobi3_pallas.py``): the six obstacle-neighbour selects fold into
    ``cnt * p_c`` (exact because p is 0 on obstacles, so a warm ``p0`` is
    zeroed there once), then x-1, x+1, y-1, y+1, z-1, z+1 are added and
    the sum is scaled by 1/6. The JAX package's XLA solver adds in another
    order."""
    cont, cnt = jacobi3_masks(flags)
    p = (torch.zeros_like(div) if p0 is None
         else where0(flags != OBSTACLE, p0))
    w_ = float(damping)
    for _ in range(iters):
        acc = div + cnt * p
        for s in _NEIGHBOURS6:
            acc = acc + nb3(p, *s)
        upd = acc * (1.0 / 6.0)
        if w_ != 1.0:
            upd = (1.0 - w_) * p + w_ * upd
        p = where0(cont, upd)
    return p


def jacobi_adjoint_fixed3(flags, g, iters: int, damping: float = 1.0):
    """``iters`` transposed damped sweeps of the upstream gradient ``g``
    (b, d, h, w): the gradient with respect to ``p0`` of
    ``solve_jacobi_fixed3(flags, div, iters, p0=p0, damping=damping)``,
    whatever ``div`` (the plain version of kernel I's adjoint).

    The sweep is p' = where0(cont, (1-w) p + w (div + cnt p + sum nb3(p))
    / 6) on a p that is 0 on obstacles; its transpose in p, with a =
    where0(cont, g) and c = (w a) / 6, is g' = (1-w) a + cnt c + c[x-1] +
    c[x+1] + c[y-1] + c[y+1] + c[z-1] + c[z+1] (each in its own float32
    add, in that order) on cells that are not obstacles, 0 on obstacles:
    the mask and the cnt term act on the gradient, the border shell still
    receives it from its interior neighbours, and the obstacles take none,
    as a warm start is zeroed there."""
    cont, cnt = jacobi3_masks(flags)
    open_ = flags != OBSTACLE
    w_ = float(damping)
    if iters == 0:
        return where0(open_, g)
    for _ in range(iters):
        a = where0(cont, g)
        c = (w_ * a) * (1.0 / 6.0)
        t = cnt * c
        if w_ != 1.0:
            t = (1.0 - w_) * a + t
        for s in _NEIGHBOURS6:
            t = t + nb3(c, *s)
        g = where0(open_, t)
    return g


def get_centered3(U):
    """Cell-centred velocity (b, 3, d, h, w); zero on the border shell."""
    _, _, d, h, w = U.shape
    u, v, wz = U[:, 0], U[:, 1], U[:, 2]
    keep = ~border_mask3(d, h, w, 1, U.device)
    return torch.stack([where0(keep, 0.5 * (u + nb3(u, 0, 0, 1))),
                        where0(keep, 0.5 * (v + nb3(v, 0, 1, 0))),
                        where0(keep, 0.5 * (wz + nb3(wz, 1, 0, 0)))], dim=1)


def mac_vectors3(U):
    """The full velocity vector at each component's face: a list of three
    (b, 3, d, h, w) tensors (x-, y-, z-face), zero on the border shell."""
    _, _, d, h, w = U.shape
    u, v, wz = U[:, 0], U[:, 1], U[:, 2]
    keep = ~border_mask3(d, h, w, 1, U.device)[None, None]

    def avg(a, s1, s2, s3):
        return 0.25 * (((a + nb3(a, *s1)) + nb3(a, *s2)) + nb3(a, *s3))

    x_face = [u, avg(v, (0, 0, -1), (0, 1, 0), (0, 1, -1)),
              avg(wz, (0, 0, -1), (1, 0, 0), (1, 0, -1))]
    y_face = [avg(u, (0, -1, 0), (0, 0, 1), (0, -1, 1)), v,
              avg(wz, (0, -1, 0), (1, 0, 0), (1, -1, 0))]
    z_face = [avg(u, (-1, 0, 0), (0, 0, 1), (-1, 0, 1)),
              avg(v, (-1, 0, 0), (0, 1, 0), (-1, 1, 0)), wz]
    return [where0(keep, torch.stack(f, dim=1))
            for f in (x_face, y_face, z_face)]


def _unsupported_advection(impl, method, line_trace_impl, line_trace):
    if impl != "window" or method != "maccormackFluidNet":
        raise NotImplementedError(
            "not ported yet: 3-D gather or Euler advection (ROADMAP A.6)")
    if line_trace and line_trace_impl != "firsthit":
        raise NotImplementedError(
            "not ported yet: the 3-D march line trace (ROADMAP A.6)")


def advect_scalar3(dt, src, U, flags, maccormack_strength=0.75,
                   method="maccormackFluidNet", impl="window", max_disp=2,
                   line_trace=False, line_trace_impl="firsthit"):
    """MacCormack advection of scalar ``src`` (b, d, h, w) by ``U`` on the
    window engine: back-trace from the cell centre (the first-hit
    obstacle trace when ``line_trace``), trilinear samples of the position
    clamped to the centre +- ``max_disp``, the MacCormack correction and
    the clamp to the 3^3 fluid neighbourhood of the forward landing cell
    (interior only; no fluid there keeps the forward value). Solid cells
    keep their value; the border shell keeps the corrected value."""
    from .line_trace3 import line_trace_firsthit3
    from .window3 import clamp_bounds_scalar_window3, interpol_window3

    _unsupported_advection(impl, method, line_trace_impl, line_trace)
    D = max_disp
    b, d, h, w = src.shape
    fluid = flags == FLUID
    border = border_mask3(d, h, w, 1, src.device)
    start = centers3(b, d, h, w, src.device)
    cc = where0(~border[None, None], get_centered3(U))

    def trace(sdt):
        if not line_trace:
            return start - sdt * cc
        disp = torch.clamp(-sdt * cc, -D, D)
        return line_trace_firsthit3(start, disp, flags, D)

    def sl(field, back):
        return torch.where(fluid, interpol_window3(field, back, D), field)

    fwd_back = trace(dt)
    fwd = where0(~border, sl(src, fwd_back))
    bwd = where0(~border, sl(fwd, trace(-dt)))
    dst = torch.where(fluid, fwd + maccormack_strength * 0.5 * (src - bwd),
                      fwd)
    pos = torch.where(fluid[:, None], fwd_back, start)
    ok, minv, maxv = clamp_bounds_scalar_window3(src, pos, flags, D)
    clamped = torch.where(ok, torch.maximum(minv, torch.minimum(maxv, dst)),
                          fwd)
    return torch.where(border, dst, clamped)


def advect_velocity3(dt, U, flags, maccormack_strength=0.75,
                     method="maccormackFluidNet", impl="window", max_disp=2,
                     orig=None):
    """MacCormack advection of the MAC velocity ``orig`` (U itself when
    None; the step passes the viscous field) by ``U`` on the window
    engine: each component of ``orig`` is sampled from the cell-centre
    position ``idx + 0.5`` along its face's full velocity vector of U (the
    JAX package's semantics), corrected where the face lies between fluid
    cells (the ``skip`` rule) and clamped to the extrema of ``orig`` over
    the 8 trilinear corners of the integer positions idx -/+ vel*dt (the
    Selle clamp). Non-fluid cells keep ``orig``'s value in each sample.
    The output's border shell is 0."""
    from .window3 import clamp_component_mac_window3, interpol_window3

    _unsupported_advection(impl, method, "firsthit", False)
    if orig is None:
        orig = U
    D = max_disp
    b, _, d, h, w = U.shape
    fluid = flags == FLUID
    border = border_mask3(d, h, w, 1, U.device)
    start = centers3(b, d, h, w, U.device)
    mac = mac_vectors3(U)

    def sl(field, sdt):
        val = torch.stack([interpol_window3(field[:, c],
                                            start - sdt * mac[c], D)
                           for c in range(3)], dim=1)
        return torch.where(fluid[:, None], val, field)

    ring = border[None, None]
    fwd = where0(~ring, sl(orig, dt))
    bwd = where0(~ring, sl(fwd, -dt))
    zz, yy, xx = index_grids3(b, d, h, w, U.device)
    outs = []
    for c, (dz, dy, dx) in enumerate(_AXES):
        idx = (xx, yy, zz)[c]
        skip = (~fluid) | ((idx > 0) & (~nb3(fluid, -dz, -dy, -dx)))
        dst = torch.where(
            skip, fwd[:, c],
            fwd[:, c] + maccormack_strength * 0.5 * (orig[:, c] - bwd[:, c]))
        out = clamp_component_mac_window3(dst, orig[:, c], mac[c] * dt, D)
        outs.append(where0(~border, out))
    return torch.stack(outs, dim=1)


def add_viscosity3(dt, U, flags, viscosity):
    """Explicit viscous diffusion with the 7-point Laplacian on interior
    faces whose cell and lower neighbour are fluid (0 on the other
    interior faces); the border shell keeps U."""
    _, d, h, w = flags.shape
    fl = flags == FLUID

    def lap(c):
        acc = -6.0 * c
        for s in _NEIGHBOURS6:
            acc = acc + nb3(c, *s)
        return acc

    interior = ~border_mask3(d, h, w, 1, U.device)
    outs = []
    for c, (dz, dy, dx) in enumerate(_AXES):
        mask = fl & nb3(fl, -dz, -dy, -dx)
        comp = where0(mask, U[:, c] + dt * viscosity * lap(U[:, c]))
        outs.append(torch.where(interior, comp, U[:, c]))
    return torch.stack(outs, dim=1)


def correct_scalar3(dt, src, div, flags):
    """Variable-density correction: rho += dt*0.5*rho*div in fluid cells."""
    return torch.where(flags == FLUID, src + dt * 0.5 * src * div, src)


def _shift_ok3(a, dz, dy, dx):
    """``nb3`` of boolean ``a`` (b, d, h, w), False where the roll would
    wrap: result[..., z, y, x] = a[..., z+dz, y+dy, x+dx] inside the grid
    (one copy of the overlapping slab, not a roll and a mask)."""
    def cut(k, n):
        return (slice(max(0, -k), n - max(0, k)),
                slice(max(0, k), n + min(0, k)))

    (zo, zi), (yo, yi), (xo, xi) = (cut(k, n) for k, n in
                                    zip((dz, dy, dx), a.shape[-3:]))
    out = torch.zeros_like(a)
    out[..., zo, yo, xo] = a[..., zi, yi, xi]
    return out


def set_wall_bcs_stick3(U, flags, flags_stick):
    """No-slip (stick) walls, in the JAX package's order:
      1. zero the velocity inside obstacle cells;
      2. free-slip on each normal component (the lower neighbour false
         off the grid);
      3. in stick cells, each tangential component's ghost value is the
         negated mean of its fluid neighbours along the two tangential
         axes (1-4 of them);
      4. a stick cell whose normal-minus neighbour is stick zeroes the
         component when a tangential axis has a stick neighbour on exactly
         one side (a both-sided pair is the extrusion axis, not a
         corner)."""
    fl = flags == FLUID
    ob = flags == OBSTACLE
    st = flags_stick == STICK
    cont = fl | ob | st
    comps = [where0(~ob, U[:, c]) for c in range(3)]
    for c, (ndz, ndy, ndx) in enumerate(_AXES):
        ob_m = _shift_ok3(ob, -ndz, -ndy, -ndx)
        fl_m = _shift_ok3(fl, -ndz, -ndy, -ndx)
        vel = where0(~(cont & (ob_m | (ob & fl_m))), comps[c])
        acc = torch.zeros_like(vel)
        cnt = torch.zeros(vel.shape, dtype=I32, device=vel.device)
        for ta, (tdz, tdy, tdx) in enumerate(_AXES):
            if ta == c:
                continue
            for sgn in (-1, 1):
                sh = (sgn * tdz, sgn * tdy, sgn * tdx)
                fl_t = _shift_ok3(fl, *sh)
                acc = acc + where0(fl_t, nb3(vel, *sh))
                cnt = cnt + fl_t.to(I32)
        ghost = -acc / torch.clamp(cnt, min=1).to(F32)
        vel = torch.where(cont & st & (cnt > 0), ghost, vel)
        st_nm = _shift_ok3(st, -ndz, -ndy, -ndx)
        st_tan = torch.zeros(vel.shape, dtype=torch.bool, device=vel.device)
        for ta, (tdz, tdy, tdx) in enumerate(_AXES):
            if ta == c:
                continue
            st_tan = st_tan | (_shift_ok3(st, -tdz, -tdy, -tdx)
                               ^ _shift_ok3(st, tdz, tdy, tdx))
        comps[c] = where0(~(cont & st & st_nm & st_tan), vel)
    return torch.stack(comps, dim=1)


def curl3(U):
    """Cell-centred vorticity (b, 3, d, h, w): central differences of the
    raw MAC components, zero on the border shell."""
    _, _, d, h, w = U.shape
    cu, cv, cw = U[:, 0], U[:, 1], U[:, 2]

    def ddx(a):
        return 0.5 * (nb3(a, 0, 0, 1) - nb3(a, 0, 0, -1))

    def ddy(a):
        return 0.5 * (nb3(a, 0, 1, 0) - nb3(a, 0, -1, 0))

    def ddz(a):
        return 0.5 * (nb3(a, 1, 0, 0) - nb3(a, -1, 0, 0))

    keep = ~border_mask3(d, h, w, 1, U.device)
    return torch.stack([where0(keep, ddy(cw) - ddz(cv)),
                        where0(keep, ddz(cu) - ddx(cw)),
                        where0(keep, ddx(cv) - ddy(cu))], dim=1)


def add_vorticity_confinement3(U, flags, strength, dt):
    """Vorticity confinement, f = strength * (N x omega) with N =
    grad|omega| / |grad|omega||, averaged to the faces and added, times dt,
    on interior fluid faces whose lower neighbour is fluid."""
    _, d, h, w = flags.shape
    fl = flags == FLUID
    om = curl3(U)
    mag = torch.sqrt(torch.sum(om * om, dim=1))
    gx = 0.5 * (nb3(mag, 0, 0, 1) - nb3(mag, 0, 0, -1))
    gy = 0.5 * (nb3(mag, 0, 1, 0) - nb3(mag, 0, -1, 0))
    gz = 0.5 * (nb3(mag, 1, 0, 0) - nb3(mag, -1, 0, 0))
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz) + 1e-12
    nx, ny, nz = gx / norm, gy / norm, gz / norm
    forces = [ny * om[:, 2] - nz * om[:, 1], nz * om[:, 0] - nx * om[:, 2],
              nx * om[:, 1] - ny * om[:, 0]]
    cont = fl & (~border_mask3(d, h, w, 1, U.device))
    outs = []
    for c, (dz, dy, dx) in enumerate(_AXES):
        f_face = 0.5 * (forces[c] + nb3(forces[c], -dz, -dy, -dx))
        mask = cont & nb3(fl, -dz, -dy, -dx)
        outs.append(torch.where(mask, U[:, c] + strength * dt * f_face,
                                U[:, c]))
    return torch.stack(outs, dim=1)
