"""Kernel J: the learned 3-D projection's tail.

Replaces ``fluidnet_cxx_tpu/ops/pallas/proj_tail3_pallas.py::
project_tail3_pallas`` with the CUDA kernels in ``csrc/jacobi3.cu``: one
prologue launch (the divergence RHS, the per-cell mask byte, the warm
start zeroed on obstacles), one z-march launch per
``fn_jacobi3_max_sweeps()`` damped Jacobi sweeps (kernel I's march,
ping-ponging two pressure buffers) and one epilogue launch (velocity
update and free-slip walls), all issued by one C call. No launch waits on
another block. The plain version, ``project_tail3_plain``, is the unfused
chain of ``ops/ops3d.py`` that the TPU kernel's docstring names; a CPU
tensor runs it, a CUDA tensor the kernels.
"""
import torch

from ..ops3d import (set_wall_bcs3, solve_jacobi_fixed3,
                     velocity_divergence3, velocity_update3)
from . import _build
from .jacobi import sweep_args


def project_tail3_plain(flags, U, p0, iters: int,
                        damping: float = 6.0 / 7.0):
    """div; p = Jacobi(iters, p0, damping); U' = set_wall_bcs3(
    velocity_update3(p, U))."""
    div = velocity_divergence3(U, flags)
    p = solve_jacobi_fixed3(flags, div, iters, p0=p0, damping=damping)
    return p, set_wall_bcs3(velocity_update3(p, U, flags), flags)


def project_tail3(flags, U, p0, iters: int, damping: float = 6.0 / 7.0):
    """Projection tail on un-normalised fields. flags (b,d,h,w) int32, U
    (b,3,d,h,w) divergent velocity, p0 (b,d,h,w) warm start (zeroed on
    obstacles). Returns (p, U')."""
    if not _build.on_cuda(U):
        return project_tail3_plain(flags, U, p0, iters, damping)
    b, d, h, w = flags.shape
    dev = U.device
    _build.check(flags, "flags", torch.int32, (b, d, h, w), dev)
    _build.check(U, "U", torch.float32, (b, 3, d, h, w), dev)
    _build.check(p0, "p0", torch.float32, (b, d, h, w), dev)
    if iters < 0 or min(d, h, w) < 3:
        raise ValueError("project_tail3 needs iters >= 0 and d, h, w >= 3")
    rhs, tmp, p = (torch.empty_like(p0) for _ in range(3))
    mask = torch.empty((b, d, h, w), dtype=torch.uint8, device=dev)
    U_out = torch.empty_like(U)
    _build.call("fn_tail3", flags.data_ptr(), U.data_ptr(), p0.data_ptr(),
                rhs.data_ptr(), mask.data_ptr(), tmp.data_ptr(),
                p.data_ptr(), U_out.data_ptr(), b, d, h, w, iters,
                *sweep_args(damping), _build.stream())
    per_launch = _build.constant("fn_jacobi3_max_sweeps")
    project_tail3.launches += 2 + -(-iters // per_launch)
    return p, U_out


project_tail3.launches = 0
