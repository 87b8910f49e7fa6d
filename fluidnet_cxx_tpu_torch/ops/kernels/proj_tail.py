"""Kernel C: the learned projection's tail.

Replaces ``fluidnet_cxx_tpu/ops/pallas/proj_tail_pallas.py::
project_tail_pallas`` with the CUDA kernels in ``csrc/jacobi.cu``, all
issued by one C call (``fn_tail``): a prologue launch (inlet BC, RHS,
p0 * scale, the mask byte), kernel F's tile launches (on 4-row strips)
of up to ``fn_jacobi_max_sweeps()`` damped Jacobi sweeps each
(ping-ponging two pressure buffers) and an epilogue launch (velocity
update, walls, inlet BC): 6 launches for 32 sweeps. No launch waits on
another block. The plain version, ``project_tail_plain``, is the unfused
chain of ``ops/stencils.py`` and ``ops/jacobi.py``; a CPU tensor runs it,
a CUDA tensor the kernels.
"""
import functools

import torch

from ..jacobi import solve_jacobi_fixed
from ..stencils import set_wall_bcs, velocity_divergence, velocity_update
from . import _build
from .jacobi import sweep_args


def project_tail_plain(flags, U, p0, iters: int, damping: float = 2.0 / 3.0,
                       scale=None, U_bc=None, U_bc_inv_mask=None):
    """[U = U*inv_mask + bc]; div; p = Jacobi(iters, p0*scale, damping);
    U' = set_wall_bcs(velocity_update(p, U)); [U' = U'*inv_mask + bc]."""
    if U_bc is not None:
        U = U * U_bc_inv_mask + U_bc
    if scale is not None:
        p0 = p0 * scale[:, None, None]
    div = velocity_divergence(U, flags)
    p = solve_jacobi_fixed(flags, div, iters, p0=p0, damping=damping)
    U = set_wall_bcs(velocity_update(p, U, flags), flags)
    if U_bc is not None:
        U = U * U_bc_inv_mask + U_bc
    return p, U


def project_tail(flags, U, p0, iters: int, damping: float = 2.0 / 3.0,
                 scale=None, U_bc=None, U_bc_inv_mask=None):
    """Projection tail on un-normalised fields. flags (b,h,w) int32, U
    (b,2,h,w) divergent velocity, p0 (b,h,w) warm start, scale (b,)
    optional, U_bc/U_bc_inv_mask (b,2,h,w) optional inlet BCs applied to
    the input and the output. Returns (p, U')."""
    if not _build.on_cuda(U):
        return project_tail_plain(flags, U, p0, iters, damping, scale, U_bc,
                                  U_bc_inv_mask)
    b, h, w = flags.shape
    dev = U.device
    _build.check(flags, "flags", torch.int32, (b, h, w), dev)
    _build.check(U, "U", torch.float32, (b, 2, h, w), dev)
    _build.check(p0, "p0", torch.float32, (b, h, w), dev)
    if scale is not None:
        _build.check(scale, "scale", torch.float32, (b,), dev)
    if (U_bc is None) != (U_bc_inv_mask is None):
        raise ValueError("U_bc and U_bc_inv_mask come together")
    if U_bc is not None:
        _build.check(U_bc, "U_bc", torch.float32, (b, 2, h, w), dev)
        _build.check(U_bc_inv_mask, "U_bc_inv_mask", torch.float32,
                     (b, 2, h, w), dev)
    if h < 3 or w < 3 or iters < 0:
        raise ValueError("project_tail needs h, w >= 3 and iters >= 0")
    rhs, tmp, p = (torch.empty_like(p0) for _ in range(3))
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    U_out = torch.empty_like(U)
    _build.call("fn_tail", flags.data_ptr(), U.data_ptr(), p0.data_ptr(),
                _build.ptr(scale), _build.ptr(U_bc),
                _build.ptr(U_bc_inv_mask), rhs.data_ptr(), mask.data_ptr(),
                tmp.data_ptr(), p.data_ptr(), U_out.data_ptr(), b, h, w,
                iters, *sweep_args(damping), _build.stream())
    project_tail.launches += tail_launches(iters)
    return p, U_out


@functools.lru_cache(maxsize=64)
def tail_launches(iters: int) -> int:
    """Launches of one fn_tail call of ``iters`` sweeps (asked of the
    library once an ``iters``)."""
    return _build.query("fn_tail_launches", iters)


project_tail.launches = 0
