"""Kernel I: fixed-count 3-D Jacobi pressure sweeps.

Replaces ``fluidnet_cxx_tpu/ops/pallas/jacobi3_pallas.py::
solve_jacobi3_pallas`` with the CUDA kernels in ``csrc/jacobi3.cu``: one
launch that builds the per-cell mask byte (and zeroes a warm start on
obstacles), then one launch per ``fn_jacobi3_max_sweeps()`` sweeps (a
z-march that keeps each sweep's planes in registers and shared memory),
ping-ponging two pressure buffers, all issued by one C call. No launch
waits on another block. The plain
version is ``ops/ops3d.py::solve_jacobi_fixed3``, in the same float32
order; a CPU tensor runs it, a CUDA tensor the kernels.
"""
import torch

from ..ops3d import solve_jacobi_fixed3
from . import _build
from .jacobi import sweep_args


def solve_jacobi3(flags, div, iters: int, p0=None, damping: float = 1.0):
    """``iters`` Jacobi sweeps. flags (b,d,h,w) int32, div (b,d,h,w) the
    RHS, p0 (b,d,h,w) optional warm start (default 0; zeroed on
    obstacles), ``damping`` the weighted-Jacobi factor. Returns p."""
    if not _build.on_cuda(div):
        return solve_jacobi_fixed3(flags, div, iters, p0=p0, damping=damping)
    b, d, h, w = flags.shape
    dev = div.device
    _build.check(flags, "flags", torch.int32, (b, d, h, w), dev)
    _build.check(div, "div", torch.float32, (b, d, h, w), dev)
    if p0 is not None:
        _build.check(p0, "p0", torch.float32, (b, d, h, w), dev)
    if iters < 0 or min(d, h, w) < 3:
        raise ValueError("solve_jacobi3 needs iters >= 0 and d, h, w >= 3")
    if iters == 0:
        return solve_jacobi_fixed3(flags, div, 0, p0=p0)
    mask = torch.empty((b, d, h, w), dtype=torch.uint8, device=dev)
    tmp, p = torch.empty_like(div), torch.empty_like(div)
    _build.call("fn_jacobi3_solve", flags.data_ptr(), div.data_ptr(),
                _build.ptr(p0), mask.data_ptr(), tmp.data_ptr(),
                p.data_ptr(), b, d, h, w, iters, *sweep_args(damping),
                _build.stream())
    per_launch = _build.constant("fn_jacobi3_max_sweeps")
    solve_jacobi3.launches += 1 + -(-iters // per_launch)
    return p


solve_jacobi3.launches = 0
