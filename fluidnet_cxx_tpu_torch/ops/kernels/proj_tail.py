"""Kernel C: the learned projection's tail.

Replaces ``fluidnet_cxx_tpu/ops/pallas/proj_tail_pallas.py::
project_tail_pallas`` with the CUDA kernels in ``csrc/proj_tail.cu``: one
prologue launch, one launch per damped Jacobi sweep (two pressure buffers,
ping-pong), one epilogue launch. No launch waits on another block. The
plain version, ``project_tail_plain``, is the unfused chain of
``ops/stencils.py`` and ``ops/jacobi.py``; a CPU tensor runs it, a CUDA
tensor the kernels.
"""
import torch

from ..jacobi import solve_jacobi_fixed
from ..stencils import set_wall_bcs, velocity_divergence, velocity_update
from . import _build


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
    rhs = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    p_out = torch.empty_like(p0)
    p_tmp = torch.empty_like(p0)
    U_out = torch.empty_like(U)
    s = _build.stream()
    bc, inv = _build.ptr(U_bc), _build.ptr(U_bc_inv_mask)
    # The last sweep must land in p_out.
    cur, nxt = (p_out, p_tmp) if iters % 2 == 0 else (p_tmp, p_out)
    _build.call("fn_tail_prologue", flags.data_ptr(), U.data_ptr(),
                p0.data_ptr(), _build.ptr(scale), bc, inv, rhs.data_ptr(),
                cur.data_ptr(), mask.data_ptr(), b, h, w, s)
    project_tail.launches += 1
    w_ = float(damping)
    for _ in range(iters):
        _build.call("fn_tail_sweep", cur.data_ptr(), rhs.data_ptr(),
                    mask.data_ptr(), nxt.data_ptr(), b, h, w,
                    int(w_ != 1.0), 1.0 - w_, w_, s)
        project_tail.launches += 1
        cur, nxt = nxt, cur
    _build.call("fn_tail_epilogue", flags.data_ptr(), U.data_ptr(),
                p_out.data_ptr(), bc, inv, U_out.data_ptr(), b, h, w, s)
    project_tail.launches += 1
    return p_out, U_out


project_tail.launches = 0
