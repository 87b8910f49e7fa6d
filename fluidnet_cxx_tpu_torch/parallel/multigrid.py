"""The width-sharded V-cycle: kernel G (``solve_mg_sharded``), kernel H's
solve and epilogue (``solve_mg_raw``, ``mg_epilogue_sharded``), the
learned V-cycle of ``mg_learned`` (``solve_mg_learned_sharded``) and the
3-D ``solve_mg3`` (``solve_mg3_sharded``), with the width split over the
mesh's sx axis. The twins of what GSPMD makes of the JAX package's
``ops/multigrid.py`` (and its Pallas kernels) under the sharded step.

Every level of the V-cycle takes global means (the compatibility
projection, the gauge) and places its border ring and its fold at the
grid's columns; its rolls wrap around the grid. So each rank holds each
level's slab with ``HALO`` columns on each side taken around the ring of
sx ranks (``parallel/halo.py::pad_columns(..., periodic=True)``: past a
domain edge, the other edge's columns), and

* above the gather level, one level at a time: the mean of the level's
  RHS from each rank's partial sums, all-reduced over the sx group; one
  exchange of the level's RHS and p; the level's down launch on the slab
  (``ops/kernels/mg.py::slab_down``: the pre-sweeps, the residual, the
  fold at the grid's columns, the child sums of the owned columns);
* the gather level, the first whose remaining hierarchy fits kernel H's
  single-block tail (``ops/kernels/mg.py::tail_first_level``; 64^2 on
  the 512^2 plume, 25x250 on the 8000x800 cylinder): its RHS is gathered
  over the sx row and every rank runs the tail on the whole coarse grid
  (``tail_solve``), the same kernel on the same data, so the ranks agree
  to the bit;
* up, one level at a time: the coarse correction's slab (``HALO`` / 2
  coarse columns around, from the gathered grid or by an exchange), the
  level's pre-swept p by an exchange, the up launch (``slab_up``: the
  Neumann extension, the prolongation, the post-sweeps), and one more
  exchange and smoothing launch for every 8 post-sweeps past the first 8;
* after the last V-cycle, the gauge's mean, all-reduced, and the
  epilogue on the owned columns (``slab_epilogue``; H's with the
  velocity update and walls, on the owned columns and a few more).

A launch's window is exact where its slab holds the grid's columns within
k + 2 fine columns (the down launch: the sweeps, the residual, the fold)
and, for the up launch, within k fine and k / 2 + 4 coarse columns (the
sweeps, the prolongation, the extension's two passes, the kernel's own
coarse ring); ``HALO`` = 16 holds both at kernel G's 8 sweeps a launch.
The per-level flags and mask bytes are built once a solve from one
exchange of the fine flags, ``(HALO + 2) 2^(gather level - 1)`` columns
wide, coarsened level by level with the ring at the grid's columns
(``slab_coarsen``).

The means sum in another order than one device's, so the result is the
single-device solve to rounding, not to the bit; the gathered levels are
the same bits on every rank. A slab width not divisible by 2^(gather
level) raises ``ValueError``.

3-D (``solve_mg3_sharded``): the same V-cycle over ops/multigrid.py's 3-D
glue, its sweeps on kernel I by the ghost zone of
``parallel/halo.py::solve_jacobi3_sharded``. It gathers at the first
level below the finest of at most ``GATHER3_CELLS`` cells (64^3 on the
128^3 plume): the levels below hold at most a megabyte, so running them
whole on every rank costs less than an exchange a level, and only the
finest level runs sharded.
"""
import math

import torch
import torch.distributed as dist

from ..ops import multigrid as mgp
from ..ops.kernels import mg as mgk
from ..ops.multigrid import level_shapes, level_shapes3
from .halo import pad_columns, solve_jacobi3_sharded
from .mesh import _all_gather

# Fine columns each side of a level's slab (see the module's note).
HALO = 16
# Sweeps a slab launch runs (csrc/mg.cu::kMaxSweeps).
MAX_SWEEPS = 8
# Cells of the largest 3-D level that runs whole on every rank.
GATHER3_CELLS = 1 << 18


def _sum_row(mesh, t):
    """``t`` summed over the sx group (in place)."""
    if mesh.sx > 1:
        dist.all_reduce(t, group=mesh.row)
    return t


def _gather(mesh, t):
    """The whole grid of the sx row's slabs (last axis)."""
    return _all_gather(t, mesh.row, -1, mesh.staged)


def _wrap(t, start: int, stop: int):
    """Columns start .. stop - 1 of a whole grid, taken mod its width."""
    idx = torch.remainder(torch.arange(start, stop, device=t.device),
                          t.shape[-1])
    return t.index_select(-1, idx).contiguous()


def _ring(mesh, tensors, g):
    """``tensors`` with ``g`` columns each side around the ring."""
    return pad_columns(mesh, tensors, g, periodic=True)[0]


def gather_level(mesh, shapes, wl: int, first=None) -> int:
    """The level whose coarse grid is gathered: ``first`` (the learned
    cut) or the tail's first level; raises ``ValueError`` where the slab
    width ``wl`` does not split into it."""
    gl = mgk.tail_first_level(shapes) if first is None else first
    if gl >= len(shapes):
        raise ValueError(f"multigrid: no level of {shapes} fits the "
                         "single-block tail the sharded V-cycle gathers")
    if wl % (1 << gl):
        raise ValueError(
            f"multigrid: a slab {wl} columns wide does not split into "
            f"level {gl} {shapes[gl]} (its width must be a multiple of "
            f"2^{gl}); use another sx")
    return gl


class _Levels:
    """The per-level slabs of one solve: ``own[j]`` (the owned columns),
    ``pad[j]`` (``HALO`` around, the level's launches), ``coarse[j]``
    (level j+1's columns under ``pad[j]``, ``HALO`` / 2 around) for the
    levels above ``gl``, and ``whole``, the gathered level's flags."""

    def __init__(self, mesh, flags, shapes, gl: int):
        _, h, wl = flags.shape
        self.mesh, self.gl, self.wl = mesh, gl, wl
        self.W = [s[1] for s in shapes]
        self.start = [mesh.sx_index * (wl >> j) for j in range(gl + 1)]
        g = (HALO + 2) << max(gl - 1, 0)
        full = mgk.slab(_ring(mesh, [flags], g)[0], self.start[0] - g,
                        self.W[0])
        self.own, self.pad, self.coarse = [], [], []
        for j in range(gl + 1):
            gj, wj = g >> j, wl >> j
            self.own.append(mgk.slab_crop(full, gj, gj + wj))
            if j < gl:
                self.pad.append(mgk.slab_crop(full, gj - HALO,
                                              gj + wj + HALO))
                full = mgk.slab_coarsen(full)
                gc = g >> (j + 1)
                self.coarse.append(mgk.slab_crop(
                    full, gc - HALO // 2, gc + (wj >> 1) + HALO // 2))
        self.whole = _gather(mesh, self.own[gl].flags)

    def width(self, j):
        return self.wl >> j


def _smooth(lv, j, q, rhs_pad, sums, k, damping):
    """``k`` sweeps of level j from the owned ``q`` in launches of up to
    ``MAX_SWEEPS``, an exchange of q before each."""
    lo, hi = HALO, HALO + lv.width(j)
    while k > 0:
        kk = min(k, MAX_SWEEPS)
        q = mgk.slab_down(lv.pad[j], None, _ring(lv.mesh, [q], HALO)[0],
                          rhs_pad, sums, kk, lo, hi, False, damping)[0]
        k -= kk
    return q


def _descend(lv, rhs, sums, p, pre, damping):
    """The down-leg of the levels above the gather level from level 0's
    RHS ``rhs`` (owned; ``sums`` its grid sums) and p (None: zeros).
    Returns (each level's (pre-swept p, padded RHS, sums), the gather
    level's RHS (owned) and sums)."""
    saved = []
    for j in range(lv.gl):
        lo, hi = HALO, HALO + lv.width(j)
        k = (pre - 1) % MAX_SWEEPS + 1 if pre > MAX_SWEEPS else pre
        (rhs_pad,) = _ring(lv.mesh, [rhs], HALO)
        if pre > k:
            p = _smooth(lv, j, torch.zeros_like(rhs) if p is None else p,
                        rhs_pad, sums, pre - k, damping)
        p_in = None if p is None else _ring(lv.mesh, [p], HALO)[0]
        p, rhs, sums_c = mgk.slab_down(lv.pad[j], lv.coarse[j], p_in,
                                       rhs_pad, sums, k, lo, hi, True,
                                       damping)
        saved.append((p, rhs_pad, sums))
        sums, p = _sum_row(lv.mesh, sums_c), None
    return saved, rhs, sums


def _ascend(lv, saved, e_whole, post, damping):
    """The up-leg from the gathered level's correction ``e_whole`` to
    level 0's p (owned)."""
    e = None
    for j in range(lv.gl - 1, -1, -1):
        p, rhs_pad, sums = saved[j]
        lo, hi = HALO, HALO + lv.width(j)
        g = HALO // 2
        if j + 1 == lv.gl:
            s = lv.start[j + 1]
            e_c = _wrap(e_whole, s - g, s + lv.width(j + 1) + g)
        else:
            (e_c,) = _ring(lv.mesh, [e], g)
        kp = min(post, MAX_SWEEPS)
        (p_pad,) = _ring(lv.mesh, [p], HALO)
        e = mgk.slab_up(lv.pad[j], lv.coarse[j], p_pad, rhs_pad, sums, e_c,
                        kp, lo, hi, damping)
        e = _smooth(lv, j, e, rhs_pad, sums, post - kp, damping)
    return e


def _vcycles(lv, div, sums0, p, n_vcycles, pre, post, coarse_iters,
             damping, min_size, coarse_fn=None):
    """``n_vcycles`` V-cycles from ``p`` (None: zeros); level 0's p
    (owned), not gauged."""
    for _ in range(n_vcycles):
        saved, rhs, sums = _descend(lv, div, sums0, p, pre, damping)
        rhs_whole = _gather(lv.mesh, rhs)
        if coarse_fn is None:
            e = mgk.tail_solve(lv.whole, rhs_whole, pre, post, coarse_iters,
                               damping, min_size)
        else:
            e = _learned_cut(lv, rhs_whole, sums, coarse_fn, post, damping)
        p = _ascend(lv, saved, e, post, damping)
    return p


def _learned_cut(lv, rhs_whole, sums, coarse_fn, post, damping):
    """The learned solve at the cut level on the whole cut grid, on every
    rank: its projected RHS, ``coarse_fn``, ``post`` sweeps from its
    correction (the single-device ``fn_mg_learned_down``'s cut output and
    ``fn_mg_learned_up``'s first sweeps)."""
    W = rhs_whole.shape[-1]
    whole = mgk.slab(lv.whole, 0, W)
    rhs_c, _ = mgk.slab_epilogue(whole, rhs_whole, sums, 0, W)
    e = coarse_fn(lv.whole, rhs_c).contiguous()
    zero = torch.zeros_like(sums)
    zero[:, 1] = 1.0
    k = post
    while k > 0:
        kk = min(k, MAX_SWEEPS)
        e = mgk.slab_down(whole, None, e, rhs_c, zero, kk, 0, W, False,
                          damping)[0]
        k -= kk
    return e


def _whole_solve(mesh, flags, div, p0, solve):
    """Grids whose finest level is the gather level: every rank solves
    the whole grid and keeps its columns."""
    wl = flags.shape[-1]
    s = mesh.sx_index * wl
    whole = solve(_gather(mesh, flags), _gather(mesh, div),
                  None if p0 is None else _gather(mesh, p0))
    return whole[..., s:s + wl].contiguous()


def _levels_of(mesh, flags, min_size, first=None):
    _, h, wl = flags.shape
    shapes = level_shapes(h, wl * mesh.sx, min_size)
    gl = gather_level(mesh, shapes, wl, first)
    return shapes, gl


def solve_mg_raw(mesh, flags, div, n_vcycles: int = 2, pre: int = 4,
                 post: int = 4, coarse_iters: int = 32,
                 damping: float = 2.0 / 3.0, min_size: int = 8, p0=None,
                 coarse_fn=None, cut=None):
    """The sharded V-cycles without the gauge: (level 0's slab of the
    solve, p (owned), the gauge's grid sums (b, 2)). ``flags``, ``div``,
    ``p0``: this rank's slabs. A grid whose whole hierarchy fits the tail,
    or a mesh with sx = 1, is solved whole on every rank (kernel G,
    gauged; the sums' mean is then 0 and the slab None)."""
    shapes, gl = _levels_of(mesh, flags, min_size, cut)
    if gl == 0 or mesh.sx == 1:
        p = _whole_solve(mesh, flags, div, p0, lambda f, d, q: mgk.solve_mg(
            f, d, n_vcycles, pre, post, coarse_iters, damping, min_size,
            p0=q))
        sums = torch.zeros((flags.shape[0], 2), device=div.device)
        sums[:, 1] = 1.0
        return None, p, sums
    lv = _Levels(mesh, flags, shapes, gl)
    sums0 = _sum_row(mesh, mgk.slab_sums(lv.own[0], div, 0, lv.wl))
    p = _vcycles(lv, div, sums0, p0, n_vcycles, pre, post, coarse_iters,
                 damping, min_size, coarse_fn)
    if p is None:
        p = torch.zeros_like(div)
    return lv.own[0], p, _sum_row(mesh, mgk.slab_sums(lv.own[0], p, 0,
                                                      lv.wl))


def solve_mg_sharded(mesh, flags, div, n_vcycles: int = 2, pre: int = 4,
                     post: int = 4, coarse_iters: int = 32,
                     damping: float = 2.0 / 3.0, min_size: int = 8,
                     p0=None):
    """Kernel G with the width split over sx: ``n_vcycles`` V-cycles from
    ``p0`` and the zero-mean gauge; this rank's slab of p."""
    own, p, sums = solve_mg_raw(mesh, flags, div, n_vcycles, pre, post,
                                coarse_iters, damping, min_size, p0)
    if own is None:
        return p
    return mgk.slab_epilogue(own, p, sums, 0, flags.shape[-1])[0]


def solve_mg_learned_sharded(mesh, flags, div, coarse_fn, n_vcycles: int = 1,
                             pre: int = 4, post: int = 4,
                             coarse_iters: int = 32,
                             damping: float = 2.0 / 3.0, min_size: int = 8,
                             coarse_size: int = 128):
    """``solve_mg(coarse_fn=...)`` (JAX's ``mg_learned``) with the width
    split over sx: the down-leg above the learned cut sharded, the cut
    level's flags and RHS gathered, ``coarse_fn`` (MGCoarseNet, kernel B's
    bfloat16 route on the card) on the whole cut grid on every rank, the
    up-leg sharded, the gauge. Without a learned cut (``plan_learned_cut``
    None) the plain sharded V-cycle."""
    _, h, wl = flags.shape
    if mesh.sx == 1:
        return mgk.solve_mg(flags, div, n_vcycles, pre, post, coarse_iters,
                            damping, min_size, coarse_fn=coarse_fn,
                            coarse_size=coarse_size)
    cut = mgk.plan_learned_cut(h, wl * mesh.sx, min_size, coarse_size)
    if cut is None:
        return solve_mg_sharded(mesh, flags, div, n_vcycles, pre, post,
                                coarse_iters, damping, min_size)
    own, p, sums = solve_mg_raw(mesh, flags, div, n_vcycles, pre, post,
                                coarse_iters, damping, min_size,
                                coarse_fn=coarse_fn, cut=cut)
    return mgk.slab_epilogue(own, p, sums, 0, wl)[0]


def mg_epilogue_sharded(mesh, flags_pad, U_pad, lw: int, p, sums, t: int):
    """Kernel H's epilogue on the owned columns and ``t`` more each side
    (fewer at a domain edge): the gauge of ``p`` (owned, raw) by the mean
    of ``sums``, the velocity update and the free-slip walls. ``flags_pad``
    and ``U_pad`` hold at least ``t + 1`` columns around the owned ones
    from column ``lw``. Returns (p of the owned columns, U of the window,
    the window's left and right widths)."""
    wl = p.shape[-1]
    (p3,), l3, r3 = pad_columns(mesh, [p], t + 1)
    a, b = lw - l3, lw + wl + r3
    W = wl * mesh.sx
    s = mgk.Slab(flags_pad[..., a:b].contiguous(), mesh.sx_index * wl - l3,
                 W)
    l2, r2 = min(t, l3), min(t, r3)
    p_out, U_out = mgk.slab_epilogue(s, p3, sums, l3 - l2, l3 + wl + r2,
                                     U_pad[..., a:b].contiguous())
    return p_out[..., l2:l2 + wl], U_out, l2, r2


# ---------------------------------------------------------------- 3-D


def _gather_level3(shapes) -> int:
    for j in range(1, len(shapes)):
        if math.prod(shapes[j]) <= GATHER3_CELLS:
            return j
    return len(shapes) - 1


def _border3(d, h, w, x0, W, device):
    X = mgp.slab_columns(w, x0, W, device)
    zz = torch.arange(d, device=device)[:, None, None]
    yy = torch.arange(h, device=device)[None, :, None]
    return ((X == 0) | (X == W - 1))[None, None, :] | (zz == 0) | (
        zz == d - 1) | (yy == 0) | (yy == h - 1)


def solve_mg3_sharded(mesh, flags, div, n_vcycles: int = 2, pre: int = 4,
                      post: int = 4, coarse_iters: int = 32,
                      damping: float = 6.0 / 7.0, min_size: int = 8,
                      p0=None, max_levels: int = 0):
    """``solve_mg3`` with the width w split over sx (see the module's
    note): ``flags``, ``div`` (b, d, h, w) and ``p0`` this rank's slabs;
    returns its slab of p in the zero-mean gauge."""
    b, d, h, wl = flags.shape
    W = wl * mesh.sx
    shapes = level_shapes3(d, h, W, min_size, max_levels)
    gl = _gather_level3(shapes)
    if mesh.sx == 1 or gl == 0:
        return _whole_solve(mesh, flags, div, p0, lambda f, q, r: (
            mgp.solve_mg3(f, q, n_vcycles, pre, post, coarse_iters, damping,
                          min_size, p0=r, max_levels=max_levels)))
    if wl % (1 << gl):
        raise ValueError(
            f"multigrid: a slab {wl} columns wide does not split into "
            f"level {gl} {shapes[gl]} (its width must be a multiple of "
            f"2^{gl}); use another sx")
    dev = div.device
    start = [mesh.sx_index * (wl >> j) for j in range(gl + 1)]
    fl = [flags]
    for j in range(gl):
        dj, hj, wj = fl[-1].shape[1:]
        fl.append(mgp._coarsen_flags3(fl[-1], _border3(
            dj // 2, hj // 2, wj // 2, start[j + 1], W >> (j + 1), dev)))
    whole = [_gather(mesh, fl[gl])]
    for _ in range(len(shapes) - gl - 1):
        whole.append(mgp._coarsen_flags3(whole[-1]))
    conts = [mgp._cont_mask(fl[j], _border3(*fl[j].shape[1:], start[j],
                                            W >> j, dev))
             for j in range(gl)]

    def project(j, rhs):
        m = conts[j]
        sums = _sum_row(mesh, torch.stack(
            [torch.sum(rhs * m, dim=(1, 2, 3)), torch.sum(m, dim=(1, 2, 3))],
            dim=1))
        return (rhs - (sums[:, 0] / torch.clamp(sums[:, 1], min=1.0))[
            :, None, None, None]) * m

    def down(j, rhs, p):
        rhs = project(j, rhs)
        p = solve_jacobi3_sharded(fl[j], rhs, pre, mesh, p0=p,
                                  damping=damping)
        (f1, r1, p1), l1, _ = pad_columns(mesh, [fl[j], rhs, p], 1)
        res = mgp._residual3(f1, r1, p1)[..., l1:l1 + fl[j].shape[-1]]
        X = mgp.slab_columns(fl[j].shape[-1], start[j], W >> j, dev)
        return rhs, p, mgp._restrict_sum3(res, X, W >> j)

    def up(j, rhs, p, e_c, e_whole):
        g = 4
        wc = fl[j + 1].shape[-1]
        if e_whole is not None:
            e = _wrap(e_whole, start[j + 1] - g, start[j + 1] + wc + g)
            f = _wrap(whole[0], start[j + 1] - g, start[j + 1] + wc + g)
        else:
            e, f = _ring(mesh, [e_c, fl[j + 1]], g)
        e = mgp._neumann_extend3(f, e, _border3(
            *f.shape[1:], start[j + 1] - g, W >> (j + 1), dev))
        pro = mgp._prolong3(e)[..., 2 * g:2 * g + fl[j].shape[-1]]
        p = p + torch.where(conts[j] > 0.5, pro, torch.zeros_like(pro))
        return solve_jacobi3_sharded(fl[j], rhs, post, mesh, p0=p,
                                     damping=damping)

    p = p0
    for _ in range(n_vcycles):
        saved, rhs, q = [], div, p
        for j in range(gl):
            r, q, rhs = down(j, rhs, q)
            saved.append((r, q))
            q = None
        e = mgp._vcycle3(whole, _gather(mesh, rhs),
                         torch.zeros_like(_gather(mesh, rhs)), 0, pre, post,
                         coarse_iters, damping)
        e_whole, e_c = e, None
        for j in range(gl - 1, -1, -1):
            r, q = saved[j]
            e_c = up(j, r, q, e_c, e_whole)
            e_whole = None
        p = e_c
    m = conts[0]
    sums = _sum_row(mesh, torch.stack(
        [torch.sum(p * m, dim=(1, 2, 3)), torch.sum(m, dim=(1, 2, 3))],
        dim=1))
    return m * (p - (sums[:, 0] / torch.clamp(sums[:, 1], min=1.0))[
        :, None, None, None])
