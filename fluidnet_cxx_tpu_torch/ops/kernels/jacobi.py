"""Kernel F: fixed-count Jacobi pressure sweeps.

Replaces ``fluidnet_cxx_tpu/ops/pallas/jacobi_pallas.py::
solve_jacobi_pallas`` with the CUDA kernels in ``csrc/jacobi.cu``: one
launch for the per-cell mask byte, then one launch per
``fn_jacobi_max_sweeps()`` sweeps (temporal blocking in shared memory,
ping-ponging two pressure buffers), all issued by one C call. No launch
waits on another block. The plain version is
``ops/jacobi.py::solve_jacobi_fixed``; a CPU tensor runs it, a CUDA tensor
the kernels.

Under autograd, with a ``p0`` that needs a gradient (the learned
projection's polish in training), ``solve_jacobi`` is ``JacobiPolish``:
forward kernel F, backward ``jacobi_adjoint``, the transposed damped
sweeps on F's 64^2 tiles (``fn_jacobi_adjoint`` in the same source; one C
call, a mask launch and one launch per ``fn_jacobi_max_sweeps()``
sweeps). It replaces no TPU kernel: JAX differentiates the "xla" polish
(``ops/jacobi.py``'s ``fori_loop``) with XLA, and no Pallas polish.
Plain version ``ops/jacobi.py::jacobi_adjoint_fixed``.
"""
import torch

from ..jacobi import jacobi_adjoint_fixed, solve_jacobi_fixed
from . import _build

def sweep_args(damping: float):
    """(damped, keep, damping) as the sweep kernels take them."""
    w_ = float(damping)
    return int(w_ != 1.0), 1.0 - w_, w_


def solve_jacobi(flags, div, iters: int, p0=None, damping: float = 1.0):
    """``iters`` Jacobi sweeps. flags (b,h,w) int32, div (b,h,w) the RHS,
    p0 (b,h,w) optional warm start (default 0). Returns p. While autograd
    records and ``p0`` needs a gradient, ``JacobiPolish`` (``div`` may not
    need one)."""
    if (p0 is not None and torch.is_grad_enabled() and p0.requires_grad):
        if div.requires_grad:
            raise ValueError("solve_jacobi gives p0 a gradient, not div "
                             "(the polish's RHS comes from data)")
        return JacobiPolish.apply(flags, div, p0, iters, damping)
    return _solve(flags, div, iters, p0, damping)


def _solve(flags, div, iters, p0, damping):
    """Kernel F on CUDA tensors, its plain version on CPU tensors."""
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


def _check_flags(flags, t, name):
    b, h, w = flags.shape
    _build.check(flags, "flags", torch.int32, (b, h, w), t.device)
    _build.check(t, name, torch.float32, (b, h, w), t.device)


def jacobi_adjoint(flags, g, iters: int, damping: float = 1.0):
    """``iters`` transposed damped sweeps of ``g`` (b, h, w): the gradient
    of kernel F's output with respect to its ``p0``. On a CUDA tensor
    ``fn_jacobi_adjoint`` (a mask launch, then F's tiles: 64^2 with a halo
    of 8, 8 sweeps a launch, the per-cell c = (w * cont * g) * 0.25 in
    shared memory, in the plain version's float32 order), else
    ``jacobi_adjoint_fixed``."""
    if not _build.on_cuda(g):
        return jacobi_adjoint_fixed(flags, g, iters, damping)
    b, h, w = flags.shape
    _check_flags(flags, g, "g")
    if iters < 0:
        raise ValueError("jacobi_adjoint needs iters >= 0")
    if iters == 0:
        return g
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=g.device)
    tmp, out = torch.empty_like(g), torch.empty_like(g)
    _, keep, w_ = sweep_args(damping)
    _build.call("fn_jacobi_adjoint", flags.data_ptr(), g.data_ptr(),
                mask.data_ptr(), tmp.data_ptr(), out.data_ptr(), b, h, w,
                iters, keep, w_, _build.stream())
    per_launch = _build.constant("fn_jacobi_max_sweeps")
    jacobi_adjoint.launches += 1 + -(-iters // per_launch)
    return out


jacobi_adjoint.launches = 0


class JacobiPolish(torch.autograd.Function):
    """``solve_jacobi`` with a gradient for ``p0``: forward kernel F (or
    its plain version), backward ``jacobi_adjoint`` of the upstream
    gradient. The output is affine in ``p0``, so the backward needs only
    the flags."""

    @staticmethod
    def forward(ctx, flags, div, p0, iters, damping):
        ctx.save_for_backward(flags)
        ctx.iters, ctx.damping = iters, damping
        return _solve(flags, div, iters, p0, damping)

    @staticmethod
    def backward(ctx, gp):
        (flags,) = ctx.saved_tensors
        return (None, None,
                jacobi_adjoint(flags, gp.contiguous(), ctx.iters,
                               ctx.damping), None, None)
