"""Kernels G and H: multigrid V-cycles (G, ``solve_mg``) and the whole
multigrid pressure projection (H, ``project_mg``).

Replace ``fluidnet_cxx_tpu/ops/pallas/mg_pallas.py::solve_mg_pallas`` and
``::project_mg_pallas`` with the CUDA kernels in ``csrc/mg.cu`` (and the
temporally blocked smoothing sweeps of ``csrc/jacobi.cu``). Levels too
large for one block's shared memory run one launch per stage; the first
level whose remaining hierarchy fits in one block (``fn_mg_cut_level``,
which knows the single-block launch's layout) runs the rest of the
V-cycle in one single-block launch per sample. No launch waits on
another block; grid-wide means are per-block partial sums that the next
launch adds up in a fixed order.

Plain versions: ``ops/multigrid.py::solve_mg`` (G) and
``project_mg_plain`` (H: velocity_divergence -> solve_mg ->
velocity_update -> set_wall_bcs). A CPU tensor runs them, a CUDA tensor
the kernels.
"""
import ctypes

import torch

from ..multigrid import level_shapes, solve_mg as solve_mg_plain
from ..stencils import set_wall_bcs, velocity_divergence, velocity_update
from . import _build
from .jacobi import sweep_args, sweeps


def n_partials(h: int, w: int) -> int:
    """Per-block partial sums of a level: one per 32x8 block."""
    return -(-w // 32) * -(-h // 8)


def project_mg_plain(flags, U, p0=None, n_vcycles: int = 1, pre: int = 4,
                     post: int = 4, coarse_iters: int = 32,
                     damping: float = 2.0 / 3.0, min_size: int = 8):
    """velocity_divergence -> solve_mg(p0) -> velocity_update ->
    set_wall_bcs. Returns (p, U')."""
    div = velocity_divergence(U, flags)
    p = solve_mg_plain(flags, div, n_vcycles, pre, post, coarse_iters,
                       damping, min_size, p0=p0)
    return p, set_wall_bcs(velocity_update(p, U, flags), flags)


def _ints(values):
    values = list(values)
    return (ctypes.c_int * len(values))(*values)


def _arg(a):
    return a.data_ptr() if isinstance(a, torch.Tensor) else a


class _Solve:
    """One multigrid solve on the card: the level hierarchy, its buffers
    and the V-cycle launches, each counted on ``owner.launches``."""

    def __init__(self, owner, flags, mask0, rhs0, pre, post, coarse_iters,
                 damping, min_size):
        b, h, w = flags.shape
        dev = flags.device
        self.owner, self.b = owner, b
        self.pre, self.post, self.coarse = pre, post, coarse_iters
        self.damping = damping
        self.stream = _build.stream()
        self.shapes = level_shapes(h, w, min_size)
        cut = _build.query("fn_mg_cut_level", len(self.shapes),
                           _ints(s[0] for s in self.shapes),
                           _ints(s[1] for s in self.shapes))
        self.cut = None if cut < 0 else cut

        def f32(hw):
            return torch.empty((b,) + hw, dtype=torch.float32, device=dev)

        self.masks, fine = [mask0], flags
        for (hf, wf), hw in zip(self.shapes, self.shapes[1:]):
            coarse = torch.empty((b,) + hw, dtype=torch.int32, device=dev)
            mask = torch.empty((b,) + hw, dtype=torch.uint8, device=dev)
            self.call("fn_mg_coarsen", fine, coarse, mask, b, hf, wf)
            self.masks.append(mask)
            fine = coarse
        self.rhs = [rhs0] + [f32(hw) for hw in self.shapes[1:]]
        self.rhsp = [f32(hw) for hw in self.shapes]
        self.parts = [torch.empty((b, n_partials(*hw), 2),
                                  dtype=torch.float32, device=dev)
                      for hw in self.shapes]
        self.pairs = [(f32(hw), f32(hw)) for hw in self.shapes]
        if self.cut != 0:
            # Level 0's RHS is the same in every V-cycle: project it once.
            self.call("fn_mg_partials", rhs0, mask0, self.parts[0], b, h, w)
            self.project(0)

    def call(self, name, *args):
        _build.call(name, *[_arg(a) for a in args], self.stream)
        self.owner.launches += 1

    def project(self, lvl):
        h, w = self.shapes[lvl]
        self.call("fn_mg_project", self.rhs[lvl], self.masks[lvl],
                  self.parts[lvl], n_partials(h, w), self.rhsp[lvl], self.b,
                  h, w)

    def smooth(self, lvl, p, k):
        return sweeps(self.owner, p, self.rhsp[lvl], self.masks[lvl],
                      self.pairs[lvl], k, self.damping)

    def vcycle(self, lvl, p):
        """One V-cycle from level ``lvl`` with start ``p`` (None: zeros);
        returns the buffer holding the level's result."""
        h, w = self.shapes[lvl]
        pair = self.pairs[lvl]
        if lvl == self.cut:
            out = pair[1] if p is pair[0] else pair[0]
            shapes = self.shapes[lvl:]
            n = len(shapes)
            masks = (ctypes.c_void_p * n)(*[m.data_ptr()
                                            for m in self.masks[lvl:]])
            self.call("fn_mg_small", n, _ints(s[0] for s in shapes),
                      _ints(s[1] for s in shapes), masks, p, self.rhs[lvl],
                      out, self.b, self.pre, self.post, self.coarse,
                      *sweep_args(self.damping))
            return out
        if lvl > 0:
            self.project(lvl)
        if lvl + 1 == len(self.shapes):
            p = self.smooth(lvl, p, self.coarse)
            return pair[0].zero_() if p is None else p
        p = self.smooth(lvl, p, self.pre)
        if p is None:
            p = pair[0].zero_()
        elif p is not pair[0] and p is not pair[1]:
            p = pair[0].copy_(p)      # prolongation adds in place
        self.call("fn_mg_restrict", p, self.rhsp[lvl], self.masks[lvl],
                  self.rhs[lvl + 1], self.masks[lvl + 1], self.parts[lvl + 1],
                  self.b, h, w)
        e = self.vcycle(lvl + 1, None)
        self.call("fn_mg_prolong", e, self.masks[lvl + 1], p,
                  self.masks[lvl], self.b, h, w)
        return self.smooth(lvl, p, self.post)

    def run(self, p0, n_vcycles):
        """``n_vcycles`` V-cycles from ``p0``; returns p before the gauge,
        with level 0's partial sums of p * cont in ``parts[0]``."""
        p = p0
        for _ in range(n_vcycles):
            p = self.vcycle(0, p)
        if p is None:
            p = self.pairs[0][0].zero_()
        h, w = self.shapes[0]
        self.call("fn_mg_partials", p, self.masks[0], self.parts[0], self.b,
                  h, w)
        return p


def _check_common(flags, p0, dev, n_vcycles):
    b, h, w = flags.shape
    _build.check(flags, "flags", torch.int32, (b, h, w), dev)
    if p0 is not None:
        _build.check(p0, "p0", torch.float32, (b, h, w), dev)
    if h < 3 or w < 3 or n_vcycles < 0:
        raise ValueError("multigrid needs h, w >= 3 and n_vcycles >= 0")


def solve_mg(flags, div, n_vcycles: int = 2, pre: int = 4, post: int = 4,
             coarse_iters: int = 32, damping: float = 2.0 / 3.0,
             min_size: int = 8, p0=None):
    """Kernel G: ``n_vcycles`` V-cycles from ``p0`` (default 0) and the
    zero-mean gauge. flags (b,h,w) int32, div (b,h,w) the RHS. Returns p."""
    if not _build.on_cuda(div):
        return solve_mg_plain(flags, div, n_vcycles, pre, post, coarse_iters,
                              damping, min_size, p0=p0)
    b, h, w = flags.shape
    _check_common(flags, p0, div.device, n_vcycles)
    _build.check(div, "div", torch.float32, (b, h, w), div.device)
    mask0 = torch.empty((b, h, w), dtype=torch.uint8, device=div.device)
    _build.call("fn_jacobi_mask", flags.data_ptr(), mask0.data_ptr(), b, h, w,
                _build.stream())
    solve_mg.launches += 1
    solve = _Solve(solve_mg, flags, mask0, div, pre, post, coarse_iters,
                   damping, min_size)
    p = solve.run(p0, n_vcycles)
    out = torch.empty_like(div)
    solve.call("fn_mg_project", p, mask0, solve.parts[0], n_partials(h, w),
               out, b, h, w)      # the zero-mean gauge
    return out


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
    dev = U.device
    _check_common(flags, p0, dev, n_vcycles)
    _build.check(U, "U", torch.float32, (b, 2, h, w), dev)
    mask0 = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    rhs0 = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    _build.call("fn_mg_prologue", flags.data_ptr(), U.data_ptr(),
                mask0.data_ptr(), rhs0.data_ptr(), b, h, w, _build.stream())
    project_mg.launches += 1
    solve = _Solve(project_mg, flags, mask0, rhs0, pre, post, coarse_iters,
                   damping, min_size)
    p = solve.run(p0, n_vcycles)
    p_out = torch.empty_like(rhs0)
    U_out = torch.empty_like(U)
    solve.call("fn_mg_epilogue", flags, U, p, mask0, solve.parts[0],
               n_partials(h, w), p_out, U_out, b, h, w)
    return p_out, U_out


solve_mg.launches = 0
project_mg.launches = 0
