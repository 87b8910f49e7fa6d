"""Geometric multigrid pressure solver, 2-D (twin of the JAX package's
``ops/multigrid.py``; the reasons for each design choice are stated
there). The plain version of kernels G and H (``ops/kernels/mg.py``).

The operator is the one the Jacobi sweeps iterate: ``A p = 4 p - sum_n
sel_n(p)`` with obstacle neighbours substituted by the centre value and p
pinned to 0 on border/obstacle cells. A V-cycle: compatibility projection
of the RHS, damped-Jacobi pre-smoothing, residual, border fold, 2x2
child-sum restriction, recursion from a zero coarse correction, Neumann
extension and bilinear prolongation of the correction, post-smoothing; the
coarsest level only smooths. Coarse flags are OBSTACLE where all children
are, with a forced obstacle border ring. ``solve_mg`` ends with the
zero-mean gauge.

The learned coarse solve: ``solve_mg(coarse_fn=...)`` hands the first level
of side <= ``coarse_size`` below the finest (``cut_level``) to
``coarse_fn(flags_c, rhs_c)`` in place of the sub-V below it, then runs
``post`` damped sweeps there from its correction (models/mg_coarse.py);
``mg_cut_rhs`` is the downward half alone.

3-D (``solve_mg3``): the same V-cycle on the 7-point operator ``A p = 6 p -
sum_n sel_n(p)``, 2x2x2 child sums halved, trilinear prolongation, three
Neumann-extension passes, 6/7 damping by default and the depth cap
``max_levels`` (the step passes ``mg_max_levels3``). Its smoother and
coarse solve are kernel I (``ops/kernels/jacobi3.py::solve_jacobi3``, with
``p0`` and ``damping``), the plain ``solve_jacobi_fixed3`` on CPU tensors;
the rest is torch glue, as it is XLA in the JAX package.
"""
import torch

from ..celltype import OBSTACLE
from . import ops3d
from .common import border_mask, nb, where0
from .jacobi import solve_jacobi_fixed
from .stencils import set_wall_bcs, velocity_update
from .kernels.jacobi3 import solve_jacobi3

_NEIGHBOURS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def slab_columns(w: int, x0: int, W: int, device="cpu"):
    """The grid's column of each column of a slab ``w`` wide whose first
    column is the grid's column ``x0`` of ``W``, mod ``W`` (a halo past a
    domain edge holds the other edge's columns, as the rolls wrap)."""
    return torch.remainder(x0 + torch.arange(w, device=device), W)


def slab_border(h: int, w: int, x0: int, W: int, device="cpu"):
    """(h, w) border ring of such a slab: the grid's first and last
    columns and the first and last rows."""
    X = slab_columns(w, x0, W, device)[None, :]
    yy = torch.arange(h, device=device)[:, None]
    return (X == 0) | (X == W - 1) | (yy == 0) | (yy == h - 1)


def _cont(flags, border=None):
    """Continuation cells; ``border`` (h, w) replaces the array's own
    ring (``slab_border``)."""
    _, h, w = flags.shape
    if border is None:
        border = border_mask(h, w, 1, flags.device)
    return ~(border[None] | (flags == OBSTACLE))


def apply_A(flags, p, border=None):
    """A p on continuation cells, 0 elsewhere. The fixed point of the
    Jacobi sweep satisfies A p = rhs."""
    ob = flags == OBSTACLE
    acc = torch.zeros_like(p)
    for dy, dx in _NEIGHBOURS:
        acc = acc + torch.where(nb(ob, dy, dx), p, nb(p, dy, dx))
    return where0(_cont(flags, border), 4.0 * p - acc)


def residual(flags, rhs, p, border=None):
    return where0(_cont(flags, border), rhs - apply_A(flags, p, border))


def _coarsen_flags(flags, border=None):
    """OBSTACLE iff all four children are; otherwise the least cell-type id
    of the non-obstacle children; an OBSTACLE border ring on every level
    (``border``, the coarse level's ring of a slab, or the array's)."""
    b, h, w = flags.shape
    f = flags.reshape(b, h // 2, 2, w // 2, 2)
    all_ob = (f == OBSTACLE).all(dim=4).all(dim=2)
    big = torch.iinfo(torch.int32).max
    rep = torch.where(f == OBSTACLE, big, f).amin(dim=(2, 4))
    out = torch.where(all_ob, OBSTACLE, rep).to(torch.int32)
    if border is None:
        border = border_mask(h // 2, w // 2, 1, flags.device)
    return torch.where(border[None], OBSTACLE, out).to(torch.int32)


def _fold_border(r, X=None, W=None):
    """Move the residual of the border-layer rows and columns (1 and -2)
    one cell inward; rows first, then columns. On a slab, ``X`` holds the
    grid's column of each column (``slab_columns``) of a grid ``W``
    wide."""
    r = r.clone()
    r[:, 2, :] += r[:, 1, :]
    r[:, -3, :] += r[:, -2, :]
    r[:, 1, :] = 0.0
    r[:, -2, :] = 0.0
    if X is None:
        r[:, :, 2] += r[:, :, 1]
        r[:, :, -3] += r[:, :, -2]
        r[:, :, 1] = 0.0
        r[:, :, -2] = 0.0
        return r
    r = torch.where(X == 2, r + nb(r, 0, -1), r)
    r = torch.where(X == W - 3, r + nb(r, 0, 1), r)
    return where0(~((X == 1) | (X == W - 2)), r)


def _restrict_sum(r, X=None, W=None):
    b, h, w = r.shape
    r = _fold_border(r, X, W)
    return r.reshape(b, h // 2, 2, w // 2, 2).sum(dim=(2, 4))


def _prolong(e):
    """Cell-centred bilinear prolongation: per axis (3/4, 1/4) toward the
    containing coarse cell and its previous (even child) or next (odd
    child) neighbour."""
    b, hc, wc = e.shape
    ey0 = 0.75 * e + 0.25 * nb(e, -1, 0)
    ey1 = 0.75 * e + 0.25 * nb(e, 1, 0)
    g = torch.stack([ey0, ey1], dim=2).reshape(b, 2 * hc, wc)
    ex0 = 0.75 * g + 0.25 * nb(g, 0, -1)
    ex1 = 0.75 * g + 0.25 * nb(g, 0, 1)
    return torch.stack([ex0, ex1], dim=3).reshape(b, 2 * hc, 2 * wc)


def _cont_mask(flags, border=None):
    """Continuation cells (interior, not obstacle) as float32; 2-D or
    3-D flags."""
    return (_cont(flags, border) if flags.dim() == 3
            else _cont3(flags, border)).to(torch.float32)


def _remove_incompatible(flags, rhs):
    """Project the RHS onto the range of A: subtract its mean over
    continuation cells."""
    m = _cont_mask(flags)
    dims = tuple(range(1, rhs.dim()))
    mean = (torch.sum(rhs * m, dim=dims, keepdim=True)
            / torch.clamp(torch.sum(m, dim=dims, keepdim=True), min=1.0))
    return (rhs - mean) * m


def _neumann_extend(flags, e, border=None):
    """Fill dead cells with the mean of their live neighbours, two passes."""
    live = _cont_mask(flags, border)
    e = e * live
    for _ in range(2):
        num = torch.zeros_like(e)
        den = torch.zeros_like(e)
        for dy, dx in _NEIGHBOURS:
            num = num + nb(e * live, dy, dx)
            den = den + nb(live, dy, dx)
        fill = num / torch.clamp(den, min=1.0)
        e = torch.where(live > 0.5, e, fill)
        live = torch.maximum(live, (den > 0.5).to(e.dtype))
    return e


def _vcycle(flags_lvls, rhs, p, lvl, pre, post, coarse_iters, damping,
            coarse_fn=None, cut_lvl=None):
    flags = flags_lvls[lvl]
    rhs = _remove_incompatible(flags, rhs)
    if coarse_fn is not None and lvl == cut_lvl:
        # The learned solve replaces the sub-V below this level; the post
        # sweeps clean its high-frequency noise before the prolongation.
        e = coarse_fn(flags, rhs)
        return solve_jacobi_fixed(flags, rhs, post, p0=p + e,
                                  damping=damping)
    if lvl + 1 == len(flags_lvls):
        return solve_jacobi_fixed(flags, rhs, coarse_iters, p0=p,
                                  damping=damping)
    p = solve_jacobi_fixed(flags, rhs, pre, p0=p, damping=damping)
    rhs_c = _restrict_sum(residual(flags, rhs, p))
    e_c = _vcycle(flags_lvls, rhs_c, torch.zeros_like(rhs_c), lvl + 1, pre,
                  post, coarse_iters, damping, coarse_fn, cut_lvl)
    e_c = _neumann_extend(flags_lvls[lvl + 1], e_c)
    p = p + where0(_cont(flags), _prolong(e_c))
    return solve_jacobi_fixed(flags, rhs, post, p0=p, damping=damping)


def level_shapes(h: int, w: int, min_size: int = 8):
    """(h, w) of every level: halve while both sides are even and the
    halved smaller side is at least ``min_size``."""
    shapes = [(h, w)]
    while (shapes[-1][0] % 2 == 0 and shapes[-1][1] % 2 == 0
           and min(shapes[-1]) // 2 >= min_size):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    return shapes


def _levels(flags, min_size):
    lvls = [flags]
    for _ in level_shapes(*flags.shape[1:], min_size)[1:]:
        lvls.append(_coarsen_flags(lvls[-1]))
    return lvls


def cut_level(shapes, coarse_size: int):
    """Index of the first level of ``shapes`` (``level_shapes``) whose
    larger side is <= ``coarse_size``: the level a learned coarse solve
    takes over. None if that is the finest level (a learned solve there is
    a plain convnet projection, not a hybrid) or no level is that small."""
    for i, (h, w) in enumerate(shapes):
        if max(h, w) <= coarse_size:
            return i if i > 0 else None
    return None


def _cut_level(lvls, coarse_size: int):
    """``cut_level`` of a list of per-level flags (the JAX package's
    ``_cut_level``)."""
    return cut_level([tuple(f.shape[1:]) for f in lvls], coarse_size)


def _gauge(flags, p):
    cont = _cont_mask(flags)
    dims = tuple(range(1, p.dim()))
    mean = (torch.sum(p * cont, dim=dims, keepdim=True)
            / torch.clamp(torch.sum(cont, dim=dims, keepdim=True), min=1.0))
    return cont * (p - mean)


def solve_mg(flags, div, n_vcycles: int = 2, pre: int = 4, post: int = 4,
             coarse_iters: int = 32, damping: float = 2.0 / 3.0,
             min_size: int = 8, p0=None, coarse_fn=None,
             coarse_size: int = 128):
    """V-cycle multigrid for the obstacle-aware pressure Poisson equation,
    with ``solve_jacobi_fixed``'s (flags, div) contract; returns p in the
    zero-mean gauge over continuation cells (0 on border/obstacle).

    ``coarse_fn(flags_c, rhs_c) -> e_c`` (optional) is a learned solve
    that takes over the first level of side <= ``coarse_size`` below the
    finest; with no such level it is not called (a plain V-cycle)."""
    p = torch.zeros_like(div) if p0 is None else p0
    lvls = _levels(flags, min_size)
    cut = _cut_level(lvls, coarse_size) if coarse_fn is not None else None
    for _ in range(n_vcycles):
        p = _vcycle(lvls, div, p, 0, pre, post, coarse_iters, damping,
                    coarse_fn if cut is not None else None, cut)
    return _gauge(flags, p)


def mg_cut_rhs(flags, div, coarse_size: int = 128, pre: int = 4,
               damping: float = 2.0 / 3.0, min_size: int = 8, p0=None):
    """The downward half-V alone: pre-sweeps and restriction from the
    finest level to the learned cut. Returns ``(flags_c, rhs_c)``, the
    inputs ``coarse_fn`` sees inside ``solve_mg``."""
    lvls = _levels(flags, min_size)
    cut = _cut_level(lvls, coarse_size)
    if cut is None:
        raise ValueError(f"no level of side <= {coarse_size} below the "
                         f"finest {tuple(flags.shape[1:])}")
    p = torch.zeros_like(div) if p0 is None else p0
    rhs = div
    for lvl in range(cut):
        f = lvls[lvl]
        rhs = _remove_incompatible(f, rhs)
        p = solve_jacobi_fixed(f, rhs, pre, p0=p, damping=damping)
        rhs = _restrict_sum(residual(f, rhs, p))
        p = torch.zeros_like(rhs)
    return lvls[cut], _remove_incompatible(lvls[cut], rhs)


# ------------------------------------------- width-sharded levels, 2-D
#
# The plain versions of csrc/mg.cu's slab entries (parallel/multigrid.py):
# each runs one level's step on a slab of it, columns ``x0`` .. of a grid
# ``W`` wide taken mod ``W`` (``slab_columns``), with the border ring and
# the fold at the grid's columns, and returns the window of columns [lo,
# hi). ``sums`` (b, 2) are the grid's sums (sum, count) of the level's
# RHS over continuation cells; the step subtracts their mean. A window is
# exact where the slab holds the grid's columns far enough around it
# (parallel/multigrid.py says how far). On the whole grid (x0 0, W w, the
# window all of it) each is the per-level step of ``_vcycle``.


def slab_coarsen(flags, x0: int, W: int):
    """Coarse flags of a slab of flags (fn_mg_slab_coarsen)."""
    _, h, w = flags.shape
    return _coarsen_flags(flags, slab_border(h // 2, w // 2, x0 // 2,
                                             W // 2, flags.device))


def slab_sums(x, flags, x0: int, W: int, lo: int, hi: int):
    """(b, 2) sums (x * cont, cont) over the window (fn_mg_slab_partials,
    its partials summed)."""
    _, h, w = flags.shape
    m = _cont_mask(flags, slab_border(h, w, x0, W, flags.device))
    m = m[..., lo:hi]
    return torch.stack([torch.sum(x[..., lo:hi] * m, dim=(1, 2)),
                        torch.sum(m, dim=(1, 2))], dim=1)


def _mean_of(sums):
    return (sums[:, 0] / torch.clamp(sums[:, 1], min=1.0))[:, None, None]


def slab_down(flags, x0: int, W: int, p, rhs, sums, k: int, lo: int,
              hi: int, restrict: bool, damping: float = 2.0 / 3.0):
    """The compatibility projection of ``rhs``, ``k`` damped sweeps from
    ``p`` (None: zeros) and, with ``restrict``, the residual, the fold
    and the child sums (fn_mg_slab_down). Returns (p, coarse RHS, its sums
    (b, 2)) of the window (None, None without ``restrict``)."""
    _, h, w = flags.shape
    border = slab_border(h, w, x0, W, flags.device)
    rhs = (rhs - _mean_of(sums)) * _cont_mask(flags, border)
    p = solve_jacobi_fixed(flags, rhs, k, p0=p, damping=damping,
                           border=border)
    if not restrict:
        return p[..., lo:hi], None, None
    X = slab_columns(w, x0, W, flags.device)
    rc = _restrict_sum(residual(flags, rhs, p, border), X, W)
    return (p[..., lo:hi], rc[..., lo // 2:hi // 2],
            slab_sums(rc, slab_coarsen(flags, x0, W), x0 // 2, W // 2,
                      lo // 2, hi // 2))


def slab_up(flags, x0: int, W: int, flags_c, x0c: int, p, rhs, sums, e_c,
            k: int, lo: int, hi: int, damping: float = 2.0 / 3.0):
    """The Neumann extension of the coarse correction ``e_c`` (a slab of
    the coarse level, flags ``flags_c``, first column the coarse grid's
    ``x0c``), its prolongation onto ``p`` on the continuation cells and
    ``k`` damped sweeps on the projected ``rhs`` (fn_mg_slab_up). Returns
    p of the window."""
    _, h, w = flags.shape
    border = slab_border(h, w, x0, W, flags.device)
    m = _cont(flags, border)
    rhs = (rhs - _mean_of(sums)) * m.to(torch.float32)
    hc, wc = flags_c.shape[1:]
    e = _neumann_extend(flags_c, e_c, slab_border(hc, wc, x0c, W // 2,
                                                  flags.device))
    off = 2 * (x0 // 2 - x0c)
    p = p + where0(m, _prolong(e)[..., off:off + w])
    p = solve_jacobi_fixed(flags, rhs, k, p0=p, damping=damping,
                           border=border)
    return p[..., lo:hi]


def slab_epilogue(flags, x0: int, W: int, p, sums, lo: int, hi: int,
                  U=None):
    """The gauge (p - mean) * cont of the window (fn_mg_slab_epilogue);
    with ``U`` also the velocity update and the free-slip walls, whose
    own border and clamp are the array's: the window leaves out the
    slab's first and last columns unless they are the grid's. Returns (p,
    U or None) of the window."""
    _, h, w = flags.shape
    pg = _cont_mask(flags, slab_border(h, w, x0, W, flags.device)) * (
        p - _mean_of(sums))
    if U is None:
        return pg[..., lo:hi], None
    U = set_wall_bcs(velocity_update(pg, U, flags), flags)
    return pg[..., lo:hi], U[..., lo:hi]


def tail_solve(flags, rhs, pre: int = 4, post: int = 4,
               coarse_iters: int = 32, damping: float = 2.0 / 3.0,
               min_size: int = 8):
    """One V-cycle from zero on the whole grid, without the gauge
    (fn_mg_tail_solve): the gathered coarse levels of a width-sharded
    solve."""
    return _vcycle(_levels(flags, min_size), rhs, torch.zeros_like(rhs), 0,
                   pre, post, coarse_iters, damping)


# ---------------------------------------------------------------- 3-D


def _cont3(flags, border=None):
    _, d, h, w = flags.shape
    if border is None:
        border = ops3d.border_mask3(d, h, w, 1, flags.device)
    return ~(border[None] | (flags == OBSTACLE))


def apply_A3(flags, p):
    """A p = 6 p - sum_n sel_n(p) on continuation cells, 0 elsewhere."""
    ob = flags == OBSTACLE
    acc = torch.zeros_like(p)
    for s in ops3d._NEIGHBOURS6:
        acc = acc + torch.where(ops3d.nb3(ob, *s), p, ops3d.nb3(p, *s))
    return where0(_cont3(flags), 6.0 * p - acc)


def _residual3(flags, rhs, p):
    return where0(_cont3(flags), rhs - apply_A3(flags, p))


def _coarsen_flags3(flags, border=None):
    """OBSTACLE iff all eight children are; otherwise the least cell-type
    id of the non-obstacle children; an OBSTACLE border shell (``border``,
    the coarse level's shell of a slab, or the array's)."""
    b, d, h, w = flags.shape
    f = flags.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2)
    all_ob = (f == OBSTACLE).all(dim=6).all(dim=4).all(dim=2)
    big = torch.iinfo(torch.int32).max
    rep = torch.where(f == OBSTACLE, big, f).amin(dim=(2, 4, 6))
    out = torch.where(all_ob, OBSTACLE, rep).to(torch.int32)
    if border is None:
        border = ops3d.border_mask3(d // 2, h // 2, w // 2, 1, flags.device)
    return torch.where(border[None], OBSTACLE, out).to(torch.int32)


def _fold_border3(r, X=None, W=None):
    """Move the residual of the border-layer planes (1 and -2) one cell
    inward, z, then y, then x (edges and corners travel once per axis).
    On a slab along x, ``X`` holds the grid's column of each column of a
    grid ``W`` wide (``slab_columns``)."""
    r = r.clone()
    for ax in (1, 2, 3) if X is None else (1, 2):
        lo_src, lo_dst = r.select(ax, 1), r.select(ax, 2)
        hi_src, hi_dst = r.select(ax, -2), r.select(ax, -3)
        lo_dst += lo_src
        hi_dst += hi_src
        lo_src.zero_()
        hi_src.zero_()
    if X is not None:
        r = torch.where(X == 2, r + torch.roll(r, 1, dims=3), r)
        r = torch.where(X == W - 3, r + torch.roll(r, -1, dims=3), r)
        r = where0(~((X == 1) | (X == W - 2)), r)
    return r


def _restrict_sum3(r, X=None, W=None):
    """Border fold, then the sum of each cell's 8 children halved (the
    unit-spacing stencil at every level)."""
    b, d, h, w = r.shape
    r = _fold_border3(r, X, W)
    return r.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2).sum(
        dim=(2, 4, 6)) * 0.5


def _prolong3(e):
    """Cell-centred trilinear prolongation: per axis z, y, x, (3/4, 1/4)
    toward the containing coarse cell and its previous (even child) or
    next (odd child) neighbour."""
    def interleave(x, axis):
        lo = 0.75 * x + 0.25 * torch.roll(x, 1, dims=axis)
        hi = 0.75 * x + 0.25 * torch.roll(x, -1, dims=axis)
        shape = list(x.shape)
        shape[axis] *= 2
        return torch.stack([lo, hi], dim=axis + 1).reshape(shape)

    return interleave(interleave(interleave(e, 1), 2), 3)


def _neumann_extend3(flags, e, border=None):
    """Fill dead cells with the mean of their live 6-neighbours, three
    passes (cube corners fill through edges and faces)."""
    live = _cont_mask(flags, border)
    e = e * live
    for _ in range(3):
        num = torch.zeros_like(e)
        den = torch.zeros_like(e)
        for s in ops3d._NEIGHBOURS6:
            num = num + ops3d.nb3(e * live, *s)
            den = den + ops3d.nb3(live, *s)
        fill = num / torch.clamp(den, min=1.0)
        e = torch.where(live > 0.5, e, fill)
        live = torch.maximum(live, (den > 0.5).to(e.dtype))
    return e


def _vcycle3(flags_lvls, rhs, p, lvl, pre, post, coarse_iters, damping):
    flags = flags_lvls[lvl]
    rhs = _remove_incompatible(flags, rhs)
    if lvl + 1 == len(flags_lvls):
        return solve_jacobi3(flags, rhs, coarse_iters, p0=p, damping=damping)
    p = solve_jacobi3(flags, rhs, pre, p0=p, damping=damping)
    rhs_c = _restrict_sum3(_residual3(flags, rhs, p))
    e_c = _vcycle3(flags_lvls, rhs_c, torch.zeros_like(rhs_c), lvl + 1,
                   pre, post, coarse_iters, damping)
    e_c = _neumann_extend3(flags_lvls[lvl + 1], e_c)
    p = p + where0(_cont3(flags), _prolong3(e_c))
    return solve_jacobi3(flags, rhs, post, p0=p, damping=damping)


def level_shapes3(d: int, h: int, w: int, min_size: int = 8,
                  max_levels: int = 0):
    """(d, h, w) of every level: halve while all sides are even, the
    halved smallest side is at least ``min_size`` and there are fewer
    than ``max_levels`` levels (0: no cap)."""
    shapes = [(d, h, w)]
    while (all(s % 2 == 0 for s in shapes[-1])
           and min(shapes[-1]) // 2 >= min_size
           and (max_levels <= 0 or len(shapes) < max_levels)):
        shapes.append(tuple(s // 2 for s in shapes[-1]))
    return shapes


def _levels3(flags, min_size, max_levels: int = 0):
    lvls = [flags]
    for _ in level_shapes3(*flags.shape[1:], min_size, max_levels)[1:]:
        lvls.append(_coarsen_flags3(lvls[-1]))
    return lvls


def solve_mg3(flags, div, n_vcycles: int = 2, pre: int = 4, post: int = 4,
              coarse_iters: int = 32, damping: float = 6.0 / 7.0,
              min_size: int = 8, p0=None, max_levels: int = 0):
    """3-D V-cycle multigrid with ``solve_jacobi3``'s (flags, div)
    contract; returns p in the zero-mean gauge over continuation cells.
    ``max_levels`` caps the hierarchy (0: none)."""
    p = torch.zeros_like(div) if p0 is None else p0
    lvls = _levels3(flags, min_size, max_levels)
    for _ in range(n_vcycles):
        p = _vcycle3(lvls, div, p, 0, pre, post, coarse_iters, damping)
    return _gauge(flags, p)
