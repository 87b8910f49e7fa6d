"""Kernels G and H: multigrid V-cycles (G, ``solve_mg``) and the whole
multigrid pressure projection (H, ``project_mg``).

Replace ``fluidnet_cxx_tpu/ops/pallas/mg_pallas.py::solve_mg_pallas`` and
``::project_mg_pallas`` with the CUDA kernels in ``csrc/mg.cu``. One C call
(``fn_mg_solve``, ``fn_mg_project``) issues every launch of a solve on the
current stream: two set-up launches, a down and an up launch per level too
large for one block and V-cycle, one single-block launch per sample for
the rest of each V-cycle (the cut, a decision of the C source:
``fn_mg_cut_level``), and the epilogue. Its scratch is one device
workspace whose size ``fn_mg_workspace`` answers; ``fn_mg_launches``
answers how many launches the call makes. No launch waits on another
block; grid-wide means are per-block partial sums that the next launch
adds up in a fixed order.

G with a learned coarse solve (``solve_mg(coarse_fn=...)``, JAX's
``mg_learned``) splits each V-cycle at the cut level into two C calls on
one workspace, ``fn_mg_learned_down`` and ``fn_mg_learned_up``, with
``coarse_fn`` (kernel B's PUNet and torch glue, models/mg_coarse.py)
between them (``solve_mg_learned``, its own launch counter).
``plan_learned_cut`` decides on the host, with no card, where the cut
falls against the single-block tail: a cut inside the tail raises.

Plain versions: ``ops/multigrid.py::solve_mg`` (G, with or without
``coarse_fn``) and ``project_mg_plain`` (H: velocity_divergence ->
solve_mg -> velocity_update -> set_wall_bcs). A CPU tensor runs them, a
CUDA tensor the kernels.
"""
import functools

import torch

from typing import NamedTuple, Optional

from .. import multigrid as plain
from ..multigrid import cut_level, level_shapes
from ..multigrid import solve_mg as solve_mg_plain
from ..stencils import set_wall_bcs, velocity_divergence, velocity_update
from . import _build
from .jacobi import sweep_args

# csrc/mg.cu::kTailBudget: the dynamic shared memory the single-block tail
# may take.
TAIL_BUDGET = 160 * 1024


def tail_bytes(shapes, first: int) -> int:
    """Dynamic shared memory of the single-block tail over levels
    ``first`` .. of ``shapes`` (csrc/mg.cu::tail_args): p and r of every
    level and a scratch field of the first, float32; the mask bytes of
    every level, each padded to 4; the whole rounded up to 16."""
    cells = [h * w for h, w in shapes[first:]]
    nbytes = 4 * (2 * sum(cells) + cells[0])
    nbytes += sum((n + 3) & ~3 for n in cells)
    return (nbytes + 15) & ~15


def tail_first_level(shapes) -> int:
    """The first level whose remaining hierarchy fits the tail's budget
    (``fn_mg_cut_level``'s rule); ``len(shapes)`` if none does."""
    return next((j for j in range(len(shapes))
                 if tail_bytes(shapes, j) <= TAIL_BUDGET), len(shapes))


def plan_learned_cut(h: int, w: int, min_size: int = 8,
                     coarse_size: int = 128):
    """The level a learned coarse solve takes over on an (h, w) grid
    (``ops/multigrid.py::cut_level``), or None if no level below the finest
    has side <= ``coarse_size`` (the solve is then a plain V-cycle). The
    kernel route splits its V-cycle there; a cut below the tail's first
    level falls inside the single-block tail, which has no split: raises
    ValueError."""
    shapes = level_shapes(h, w, min_size)
    cut = cut_level(shapes, coarse_size)
    if cut is None:
        return None
    tail = tail_first_level(shapes)
    if cut > tail:
        raise ValueError(
            f"multigrid: the learned cut at level {cut} {shapes[cut]} falls "
            f"inside the single-block tail, which runs levels {tail} "
            f"{shapes[tail]} and below on {h}x{w}: the kernel route splits "
            "a V-cycle only above the tail or at its first level")
    return cut


def project_mg_plain(flags, U, p0=None, n_vcycles: int = 1, pre: int = 4,
                     post: int = 4, coarse_iters: int = 32,
                     damping: float = 2.0 / 3.0, min_size: int = 8):
    """velocity_divergence -> solve_mg(p0) -> velocity_update ->
    set_wall_bcs. Returns (p, U')."""
    div = velocity_divergence(U, flags)
    p = solve_mg_plain(flags, div, n_vcycles, pre, post, coarse_iters,
                       damping, min_size, p0=p0)
    return p, set_wall_bcs(velocity_update(p, U, flags), flags)


@functools.lru_cache(maxsize=64)
def _plan(b, h, w, min_size, n_vcycles, pre, post, coarse, project):
    """(workspace bytes, launches) of one C call, as the C source answers."""
    nbytes = _build.query("fn_mg_workspace", b, h, w, min_size, pre, post,
                          coarse, project)
    launches = _build.query("fn_mg_launches", b, h, w, min_size, n_vcycles,
                            pre, post, coarse, project)
    if nbytes < 0 or launches < 0:
        raise ValueError("multigrid: the kernels refuse these sizes")
    return nbytes, launches


def _run(owner, entry, flags, data, p0, outs, n_vcycles, pre, post,
         coarse_iters, damping, min_size):
    b, h, w = flags.shape
    if p0 is not None:
        _build.check(p0, "p0", torch.float32, (b, h, w), flags.device)
    if h < 3 or w < 3 or min(n_vcycles, pre, post, coarse_iters) < 0:
        raise ValueError("multigrid needs h, w >= 3 and non-negative counts")
    project = int(entry == "fn_mg_project")
    nbytes, launches = _plan(b, h, w, min_size, n_vcycles, pre, post,
                             coarse_iters, project)
    work = torch.empty(nbytes, dtype=torch.uint8, device=flags.device)
    _build.call(entry, flags.data_ptr(), data.data_ptr(), _build.ptr(p0),
                *[o.data_ptr() for o in outs], work.data_ptr(), b, h, w,
                min_size, n_vcycles, pre, post, coarse_iters,
                *sweep_args(damping), _build.stream())
    owner.launches += launches


def solve_mg(flags, div, n_vcycles: int = 2, pre: int = 4, post: int = 4,
             coarse_iters: int = 32, damping: float = 2.0 / 3.0,
             min_size: int = 8, p0=None, coarse_fn=None,
             coarse_size: int = 128):
    """Kernel G: ``n_vcycles`` V-cycles from ``p0`` (default 0) and the
    zero-mean gauge. flags (b,h,w) int32, div (b,h,w) the RHS. Returns p.
    With ``coarse_fn`` and a learned cut (``plan_learned_cut``) the
    V-cycles run split around it (``solve_mg_learned``)."""
    if not _build.on_cuda(div):
        return solve_mg_plain(flags, div, n_vcycles, pre, post, coarse_iters,
                              damping, min_size, p0=p0, coarse_fn=coarse_fn,
                              coarse_size=coarse_size)
    b, h, w = flags.shape
    _build.check(flags, "flags", torch.int32, (b, h, w), div.device)
    _build.check(div, "div", torch.float32, (b, h, w), div.device)
    cut = (plan_learned_cut(h, w, min_size, coarse_size)
           if coarse_fn is not None and n_vcycles > 0 else None)
    if cut is not None:
        return solve_mg_learned(flags, div, coarse_fn, cut, n_vcycles, pre,
                                post, coarse_iters, damping, min_size, p0)
    out = torch.empty_like(div)
    _run(solve_mg, "fn_mg_solve", flags, div, p0, (out,), n_vcycles, pre,
         post, coarse_iters, damping, min_size)
    return out


@functools.lru_cache(maxsize=64)
def _learned_launches(b, h, w, min_size, cut, pre, post, coarse, half,
                      flag):
    n = _build.query("fn_mg_learned_launches", b, h, w, min_size, cut, pre,
                     post, coarse, half, flag)
    if n < 0:
        raise ValueError(f"multigrid: the kernels refuse a learned cut at "
                         f"level {cut} of {h}x{w}")
    return n


def solve_mg_learned(flags, div, coarse_fn, cut: int, n_vcycles: int = 1,
                     pre: int = 4, post: int = 4, coarse_iters: int = 32,
                     damping: float = 2.0 / 3.0, min_size: int = 8,
                     p0=None):
    """Kernel G split at level ``cut`` (CUDA tensors only): each V-cycle is
    ``fn_mg_learned_down`` (set-up on the first, the levels above the cut,
    the cut level's flags and projected RHS), ``coarse_fn(flags_c,
    rhs_c)`` and ``fn_mg_learned_up`` (the post-sweeps at the cut from the
    correction, the levels above, the gauge after the last). Returns p."""
    b, h, w = flags.shape
    dev = div.device
    if p0 is not None:
        _build.check(p0, "p0", torch.float32, (b, h, w), dev)
    hc, wc = level_shapes(h, w, min_size)[cut]
    nbytes, _ = _plan(b, h, w, min_size, n_vcycles, pre, post, coarse_iters,
                      0)
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    flags_c = torch.empty((b, hc, wc), dtype=torch.int32, device=dev)
    rhs_c = torch.empty((b, hc, wc), dtype=torch.float32, device=dev)
    sizes = (b, h, w, min_size, cut)
    counts = (pre, post, coarse_iters)
    p = p0
    for v in range(n_vcycles):
        first, last = v == 0, v + 1 == n_vcycles
        _build.call("fn_mg_learned_down", flags.data_ptr(), div.data_ptr(),
                    _build.ptr(p), flags_c.data_ptr(), rhs_c.data_ptr(),
                    work.data_ptr(), *sizes, int(first), *counts,
                    *sweep_args(damping), _build.stream())
        solve_mg_learned.launches += _learned_launches(*sizes, *counts, 0,
                                                       int(first))
        e = coarse_fn(flags_c, rhs_c)
        _build.check(e, "coarse_fn's correction", torch.float32,
                     (b, hc, wc), dev)
        out = torch.empty_like(div)
        _build.call("fn_mg_learned_up", flags.data_ptr(), div.data_ptr(),
                    e.data_ptr(), rhs_c.data_ptr(), out.data_ptr(),
                    work.data_ptr(),
                    *sizes, int(last), *counts, *sweep_args(damping),
                    _build.stream())
        solve_mg_learned.launches += _learned_launches(*sizes, *counts, 1,
                                                       int(last))
        p = out
    return p


def project_mg(flags, U, p0=None, n_vcycles: int = 1, pre: int = 4,
               post: int = 4, coarse_iters: int = 32,
               damping: float = 2.0 / 3.0, min_size: int = 8):
    """Kernel H: the divergence RHS of U, ``n_vcycles`` V-cycles from
    ``p0`` (default 0), the gauge, the velocity update and the free-slip
    wall BCs. flags (b,h,w) int32, U (b,2,h,w). Returns (p, U')."""
    if not _build.on_cuda(U):
        return project_mg_plain(flags, U, p0, n_vcycles, pre, post,
                                coarse_iters, damping, min_size)
    b, h, w = flags.shape
    _build.check(flags, "flags", torch.int32, (b, h, w), U.device)
    _build.check(U, "U", torch.float32, (b, 2, h, w), U.device)
    p_out = torch.empty((b, h, w), dtype=torch.float32, device=U.device)
    U_out = torch.empty_like(U)
    _run(project_mg, "fn_mg_project", flags, U, p0, (p_out, U_out),
         n_vcycles, pre, post, coarse_iters, damping, min_size)
    return p_out, U_out


# ------------------------------------------- the width-sharded V-cycle
#
# One launch each on a slab of a level (parallel/multigrid.py): the
# entries fn_mg_slab_* and fn_mg_tail_solve of csrc/mg.cu, their plain
# versions ops/multigrid.py's slab_* and tail_solve. A slab is a level's
# columns x0 .. of a grid W wide taken mod W; a window [lo, hi) is the
# columns a launch writes.


class Slab(NamedTuple):
    """A slab of a level: its flags (b, h, w) int32, the grid's column of
    its first column, the grid's width, and on the card its mask bytes
    (``fn_mg_slab_mask``; None on the CPU)."""
    flags: torch.Tensor
    x0: int
    W: int
    mask: Optional[torch.Tensor] = None


def slab(flags, x0: int, W: int) -> Slab:
    """The ``Slab`` of ``flags``: on a CUDA tensor with its mask bytes
    (one launch, counted in ``slab.launches``)."""
    if not _build.on_cuda(flags):
        return Slab(flags, x0, W)
    b, h, w = flags.shape
    _build.check(flags, "flags", torch.int32, (b, h, w), flags.device)
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=flags.device)
    _build.call("fn_mg_slab_mask", flags.data_ptr(), mask.data_ptr(), b, h,
                w, x0, W, _build.stream())
    slab.launches += 1
    return Slab(flags, x0, W, mask)


def _masked(s: Slab) -> Slab:
    """``s`` with its mask bytes: a slab of CUDA tensors made without
    them (a ``Slab`` built by hand) gets them here (``slab``)."""
    return s if s.mask is not None else slab(s.flags, s.x0, s.W)


def slab_coarsen(s: Slab) -> Slab:
    """The next level's slab of the same columns (``_coarsen_flags`` with
    the ring at the grid's columns; x0 and the width even)."""
    if not _build.on_cuda(s.flags):
        return Slab(plain.slab_coarsen(s.flags, s.x0, s.W), s.x0 // 2,
                    s.W // 2)
    b, h, w = s.flags.shape
    out = torch.empty((b, h // 2, w // 2), dtype=torch.int32,
                      device=s.flags.device)
    _build.call("fn_mg_slab_coarsen", s.flags.data_ptr(), out.data_ptr(), b,
                h, w, s.x0, s.W, _build.stream())
    slab.launches += 1
    return slab(out, s.x0 // 2, s.W // 2)


def slab_crop(s: Slab, a: int, b: int) -> Slab:
    """Columns [a, b) of a slab."""
    return Slab(s.flags[..., a:b].contiguous(), s.x0 + a, s.W,
                None if s.mask is None else s.mask[..., a:b].contiguous())


@functools.lru_cache(maxsize=256)
def _slab_parts(kind, b, h, lo, hi, k):
    n = _build.query("fn_mg_slab_parts", kind, b, h, lo, hi, k)
    if n < 0:
        raise ValueError(f"multigrid: the slab kernels refuse a window "
                         f"[{lo}, {hi}) of {h} rows with {k} sweeps")
    return n


def _summed(parts, b):
    return parts.view(b, -1, 2).sum(dim=1)


def slab_sums(s: Slab, x, lo: int, hi: int):
    """(b, 2) sums (x * cont, cont) over the window: per-block partials
    (one launch, ``slab.launches``), added up here."""
    if not _build.on_cuda(s.flags):
        return plain.slab_sums(x, s.flags, s.x0, s.W, lo, hi)
    s = _masked(s)
    b, h, w = s.flags.shape
    _build.check(x, "x", torch.float32, (b, h, w), x.device)
    parts = torch.empty((b, _slab_parts(3, b, h, lo, hi, 0), 2),
                        dtype=torch.float32, device=x.device)
    _build.call("fn_mg_slab_partials", x.data_ptr(), s.mask.data_ptr(),
                parts.data_ptr(), b, h, w, lo, hi, _build.stream())
    slab.launches += 1
    return _summed(parts, b)


def _coarse_geometry(s: Slab, s_c: Slab):
    """(width, offset) of the coarse slab: the coarse cell of column x of
    ``s`` is its column x / 2 + offset."""
    return s_c.flags.shape[-1], s.x0 // 2 - s_c.x0


def slab_down(s: Slab, s_c: Slab, p, rhs, sums, k: int, lo: int, hi: int,
              restrict: bool, damping: float = 2.0 / 3.0):
    """One down launch (with ``restrict``) or smoothing launch on a slab
    (``fn_mg_slab_down``, counted in ``slab_down.launches``): ``k`` <= 8
    sweeps. ``s_c`` is the next level's slab (its mask bytes for the
    coarse RHS's sums). Returns (p, coarse RHS, its sums) of the
    window."""
    if not _build.on_cuda(s.flags):
        return plain.slab_down(s.flags, s.x0, s.W, p, rhs, sums, k, lo, hi,
                               restrict, damping)
    s, s_c = _masked(s), _masked(s_c) if restrict else s_c
    b, h, w = s.flags.shape
    dev = rhs.device
    _build.check(rhs, "rhs", torch.float32, (b, h, w), dev)
    if p is not None:
        _build.check(p, "p", torch.float32, (b, h, w), dev)
    sums = sums.contiguous()
    p_out = torch.empty((b, h, hi - lo), dtype=torch.float32, device=dev)
    rhs_c = parts = None
    wcp, offc = 0, 0
    if restrict:
        wcp, offc = _coarse_geometry(s, s_c)
        rhs_c = torch.empty((b, h // 2, (hi - lo) // 2), dtype=torch.float32,
                            device=dev)
        parts = torch.empty((b, _slab_parts(1, b, h, lo, hi, k), 2),
                            dtype=torch.float32, device=dev)
    _build.call("fn_mg_slab_down", _build.ptr(p), rhs.data_ptr(),
                s.mask.data_ptr(), sums.data_ptr(),
                _build.ptr(s_c.mask if restrict else None), p_out.data_ptr(),
                _build.ptr(rhs_c), _build.ptr(parts), b, h, w, s.x0, s.W, lo,
                hi, wcp, offc, k, int(restrict), *sweep_args(damping),
                _build.stream())
    slab_down.launches += 1
    return p_out, rhs_c, None if parts is None else _summed(parts, b)


def slab_up(s: Slab, s_c: Slab, p, rhs, sums, e_c, k: int, lo: int,
            hi: int, damping: float = 2.0 / 3.0):
    """One up launch on a slab (``fn_mg_slab_up``, counted in
    ``slab_up.launches``): the coarse correction ``e_c`` on the coarse
    slab ``s_c``'s columns, its extension and prolongation onto ``p``,
    ``k`` <= 8 post-sweeps. Returns p of the window."""
    if not _build.on_cuda(s.flags):
        return plain.slab_up(s.flags, s.x0, s.W, s_c.flags, s_c.x0, p, rhs,
                             sums, e_c, k, lo, hi, damping)
    s, s_c = _masked(s), _masked(s_c)
    b, h, w = s.flags.shape
    dev = rhs.device
    for t, name in ((p, "p"), (rhs, "rhs")):
        _build.check(t, name, torch.float32, (b, h, w), dev)
    _build.check(e_c, "e_c", torch.float32, tuple(s_c.flags.shape), dev)
    wcp, offc = _coarse_geometry(s, s_c)
    p_out = torch.empty((b, h, hi - lo), dtype=torch.float32, device=dev)
    _build.call("fn_mg_slab_up", p.data_ptr(), rhs.data_ptr(),
                s.mask.data_ptr(), sums.contiguous().data_ptr(),
                e_c.data_ptr(), s_c.mask.data_ptr(), p_out.data_ptr(), b, h,
                w, s.x0, s.W, lo, hi, wcp, offc, k, *sweep_args(damping),
                _build.stream())
    slab_up.launches += 1
    return p_out


def slab_epilogue(s: Slab, p, sums, lo: int, hi: int, U=None):
    """The gauge of the window (``fn_mg_slab_epilogue``, counted in
    ``slab_epilogue.launches``) and with ``U`` H's velocity update and
    walls: the window leaves out the slab's first and last columns unless
    they are the grid's. Returns (p, U or None) of the window."""
    if not _build.on_cuda(p):
        return plain.slab_epilogue(s.flags, s.x0, s.W, p, sums, lo, hi, U)
    b, h, w = s.flags.shape
    dev = p.device
    _build.check(p, "p", torch.float32, (b, h, w), dev)
    p_out = torch.empty((b, h, hi - lo), dtype=torch.float32, device=dev)
    U_out = None
    if U is not None:
        _build.check(U, "U", torch.float32, (b, 2, h, w), dev)
        U_out = torch.empty((b, 2, h, hi - lo), dtype=torch.float32,
                            device=dev)
    _build.call("fn_mg_slab_epilogue", s.flags.data_ptr(), _build.ptr(U),
                p.data_ptr(), sums.contiguous().data_ptr(), p_out.data_ptr(),
                _build.ptr(U_out), b, h, w, s.x0, s.W, lo, hi,
                _build.stream())
    slab_epilogue.launches += 1
    return p_out, U_out


@functools.lru_cache(maxsize=64)
def _tail_plan(b, h, w, min_size, pre, post, coarse):
    launches = _build.query("fn_mg_tail_launches", b, h, w, min_size, pre,
                            post, coarse)
    if launches < 0:
        raise ValueError(f"multigrid: the hierarchy of {h}x{w} does not fit "
                         "the single-block tail")
    return _plan(b, h, w, min_size, 1, pre, post, coarse, 0)[0], launches


def tail_solve(flags, rhs, pre: int = 4, post: int = 4,
               coarse_iters: int = 32, damping: float = 2.0 / 3.0,
               min_size: int = 8):
    """One V-cycle from zero on a whole grid whose hierarchy fits the
    single-block tail, without the gauge (``fn_mg_tail_solve``: the set-up
    and the tail, counted in ``tail_solve.launches``). Returns p."""
    if not _build.on_cuda(rhs):
        return plain.tail_solve(flags, rhs, pre, post, coarse_iters, damping,
                                min_size)
    b, h, w = flags.shape
    _build.check(flags, "flags", torch.int32, (b, h, w), rhs.device)
    _build.check(rhs, "rhs", torch.float32, (b, h, w), rhs.device)
    nbytes, launches = _tail_plan(b, h, w, min_size, pre, post,
                                  coarse_iters)
    work = torch.empty(nbytes, dtype=torch.uint8, device=rhs.device)
    out = torch.empty_like(rhs)
    _build.call("fn_mg_tail_solve", flags.data_ptr(), rhs.data_ptr(),
                out.data_ptr(), work.data_ptr(), b, h, w, min_size, pre, post,
                coarse_iters, *sweep_args(damping), _build.stream())
    tail_solve.launches += launches
    return out


solve_mg.launches = 0
solve_mg_learned.launches = 0
project_mg.launches = 0
slab.launches = 0
slab_down.launches = 0
slab_up.launches = 0
slab_epilogue.launches = 0
tail_solve.launches = 0
