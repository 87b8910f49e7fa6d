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

Under autograd, with a ``p0`` that needs a gradient (FluidNet3's polish in
training), ``solve_jacobi3`` is ``JacobiPolish3``: forward kernel I,
backward ``jacobi3_adjoint``, the transposed damped sweeps on I's z-march
(``fn_jacobi3_adjoint`` in the same source; one C call, a mask launch and
one launch per ``fn_jacobi3_max_sweeps()`` sweeps). It replaces no TPU
kernel: JAX differentiates the "xla" polish (``ops/ops3d.py``'s
``fori_loop``) with XLA. Plain version ``ops/ops3d.py::
jacobi_adjoint_fixed3``.
"""
import torch

from ..ops3d import jacobi_adjoint_fixed3, solve_jacobi_fixed3
from . import _build
from .jacobi import sweep_args


def solve_jacobi3(flags, div, iters: int, p0=None, damping: float = 1.0):
    """``iters`` Jacobi sweeps. flags (b,d,h,w) int32, div (b,d,h,w) the
    RHS, p0 (b,d,h,w) optional warm start (default 0; zeroed on
    obstacles), ``damping`` the weighted-Jacobi factor. Returns p. While
    autograd records and ``p0`` needs a gradient, ``JacobiPolish3``
    (``div`` may not need one)."""
    if p0 is not None and torch.is_grad_enabled() and p0.requires_grad:
        if div.requires_grad:
            raise ValueError("solve_jacobi3 gives p0 a gradient, not div "
                             "(the polish's RHS comes from data)")
        return JacobiPolish3.apply(flags, div, p0, iters, damping)
    return _solve3(flags, div, iters, p0, damping)


def _check3(flags, t, name):
    b, d, h, w = flags.shape
    _build.check(flags, "flags", torch.int32, (b, d, h, w), t.device)
    _build.check(t, name, torch.float32, (b, d, h, w), t.device)
    if min(d, h, w) < 3:
        raise ValueError("kernel I needs d, h, w >= 3")


def _solve3(flags, div, iters, p0, damping):
    """Kernel I on CUDA tensors, its plain version on CPU tensors."""
    if not _build.on_cuda(div):
        return solve_jacobi_fixed3(flags, div, iters, p0=p0, damping=damping)
    b, d, h, w = flags.shape
    dev = div.device
    _check3(flags, div, "div")
    if p0 is not None:
        _build.check(p0, "p0", torch.float32, (b, d, h, w), dev)
    if iters < 0:
        raise ValueError("solve_jacobi3 needs iters >= 0")
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


def jacobi3_adjoint(flags, g, iters: int, damping: float = 1.0):
    """``iters`` transposed damped sweeps of ``g`` (b, d, h, w): the
    gradient of kernel I's output with respect to its ``p0``. On a CUDA
    tensor ``fn_jacobi3_adjoint`` (a mask launch, then I's z-march on the
    transposed sweep, 3 sweeps a launch, in the plain version's float32
    order), else ``jacobi_adjoint_fixed3``."""
    if not _build.on_cuda(g):
        return jacobi_adjoint_fixed3(flags, g, iters, damping)
    _check3(flags, g, "g")
    if iters < 0:
        raise ValueError("jacobi3_adjoint needs iters >= 0")
    if iters == 0:
        return jacobi_adjoint_fixed3(flags, g, 0)
    mask = torch.empty(g.shape, dtype=torch.uint8, device=g.device)
    tmp, out = torch.empty_like(g), torch.empty_like(g)
    _build.call("fn_jacobi3_adjoint", flags.data_ptr(), g.data_ptr(),
                mask.data_ptr(), tmp.data_ptr(), out.data_ptr(),
                *g.shape, iters, *sweep_args(damping), _build.stream())
    per_launch = _build.constant("fn_jacobi3_max_sweeps")
    jacobi3_adjoint.launches += 1 + -(-iters // per_launch)
    return out


jacobi3_adjoint.launches = 0


class JacobiPolish3(torch.autograd.Function):
    """``solve_jacobi3`` with a gradient for ``p0``: forward kernel I (or
    its plain version), backward ``jacobi3_adjoint`` of the upstream
    gradient. The output is affine in ``p0``, so the backward needs only
    the flags."""

    @staticmethod
    def forward(ctx, flags, div, p0, iters, damping):
        ctx.save_for_backward(flags)
        ctx.iters, ctx.damping = iters, damping
        return _solve3(flags, div, iters, p0, damping)

    @staticmethod
    def backward(ctx, gp):
        (flags,) = ctx.saved_tensors
        return (None, None,
                jacobi3_adjoint(flags, gp.contiguous(), ctx.iters,
                                ctx.damping), None, None)
