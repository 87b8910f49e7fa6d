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

Plain versions: ``ops/multigrid.py::solve_mg`` (G) and
``project_mg_plain`` (H: velocity_divergence -> solve_mg ->
velocity_update -> set_wall_bcs). A CPU tensor runs them, a CUDA tensor
the kernels.
"""
import functools

import torch

from ..multigrid import solve_mg as solve_mg_plain
from ..stencils import set_wall_bcs, velocity_divergence, velocity_update
from . import _build
from .jacobi import sweep_args


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
             min_size: int = 8, p0=None):
    """Kernel G: ``n_vcycles`` V-cycles from ``p0`` (default 0) and the
    zero-mean gauge. flags (b,h,w) int32, div (b,h,w) the RHS. Returns p."""
    if not _build.on_cuda(div):
        return solve_mg_plain(flags, div, n_vcycles, pre, post, coarse_iters,
                              damping, min_size, p0=p0)
    b, h, w = flags.shape
    _build.check(flags, "flags", torch.int32, (b, h, w), div.device)
    _build.check(div, "div", torch.float32, (b, h, w), div.device)
    out = torch.empty_like(div)
    _run(solve_mg, "fn_mg_solve", flags, div, p0, (out,), n_vcycles, pre,
         post, coarse_iters, damping, min_size)
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
    _build.check(flags, "flags", torch.int32, (b, h, w), U.device)
    _build.check(U, "U", torch.float32, (b, 2, h, w), U.device)
    p_out = torch.empty((b, h, w), dtype=torch.float32, device=U.device)
    U_out = torch.empty_like(U)
    _run(project_mg, "fn_mg_project", flags, U, p0, (p_out, U_out),
         n_vcycles, pre, post, coarse_iters, damping, min_size)
    return p_out, U_out


solve_mg.launches = 0
project_mg.launches = 0
