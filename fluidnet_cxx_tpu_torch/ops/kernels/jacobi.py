"""Kernel F: fixed-count Jacobi pressure sweeps.

Replaces ``fluidnet_cxx_tpu/ops/pallas/jacobi_pallas.py::
solve_jacobi_pallas`` with the CUDA kernels in ``csrc/jacobi.cu``: one
launch for the per-cell mask byte, then one launch per
``fn_jacobi_max_sweeps()`` sweeps (temporal blocking in shared memory,
ping-ponging two pressure buffers), all issued by one C call. No launch
waits on another block. The plain version is
``ops/jacobi.py::solve_jacobi_fixed``; a CPU tensor runs it, a CUDA tensor
the kernels.
"""
import torch

from ..jacobi import solve_jacobi_fixed
from . import _build

def sweep_args(damping: float):
    """(damped, keep, damping) as the sweep kernels take them."""
    w_ = float(damping)
    return int(w_ != 1.0), 1.0 - w_, w_


def solve_jacobi(flags, div, iters: int, p0=None, damping: float = 1.0):
    """``iters`` Jacobi sweeps. flags (b,h,w) int32, div (b,h,w) the RHS,
    p0 (b,h,w) optional warm start (default 0). Returns p."""
    if not _build.on_cuda(div):
        return solve_jacobi_fixed(flags, div, iters, p0=p0, damping=damping)
    b, h, w = flags.shape
    dev = div.device
    _build.check(flags, "flags", torch.int32, (b, h, w), dev)
    _build.check(div, "div", torch.float32, (b, h, w), dev)
    if p0 is not None:
        _build.check(p0, "p0", torch.float32, (b, h, w), dev)
    if iters < 0:
        raise ValueError("solve_jacobi needs iters >= 0")
    if iters == 0:
        return torch.zeros_like(div) if p0 is None else p0
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    tmp, p = torch.empty_like(div), torch.empty_like(div)
    _build.call("fn_jacobi_solve", flags.data_ptr(), div.data_ptr(),
                _build.ptr(p0), mask.data_ptr(), tmp.data_ptr(), p.data_ptr(),
                b, h, w, iters, *sweep_args(damping), _build.stream())
    per_launch = _build.constant("fn_jacobi_max_sweeps")
    solve_jacobi.launches += 1 + -(-iters // per_launch)
    return p


solve_jacobi.launches = 0
