"""Kernels K, L and M: 3-D MacCormack advection on the window engine.

* K ``advect_scalar3``: the scalar alone; replaces
  ``fluidnet_cxx_tpu/ops/pallas/advect3_pallas.py::advect_scalar3_pallas``.
* L ``advect_all3``: scalar + MAC velocity from the same pre-advection U;
  replaces ``advect3_pallas.py::advect_all3_pallas``.
* M ``advect_velocity3``: the MAC velocity alone; replaces
  ``advect3_pallas.py::advect_velocity3_pallas``.

All three run the CUDA kernels of ``csrc/advect3.cu`` in two launches
(forward samples into scratch, then backward samples, correction and
clamps). K and L run one thread a cell; their first-hit trace walks the
pruned box of ``line_trace3.firsthit_box3``, whose margin the wrapper
passes. M's two launches march each column tile along z with U (and, in
the backward launch, the forward field) in rings of planes in shared
memory, built for ``max_disp`` up to ``fn_advect3_velocity_max_disp(0)``;
a larger one raises. With ``orig`` (the viscous field) M advects orig
along U's MAC vectors and keeps a third ring, orig's, which fits up to
``fn_advect3_velocity_max_disp(1)``. Their plain versions are the window
engine of ``ops/ops3d.py`` (``advect_scalar3``, ``advect_velocity3``): a
CPU tensor runs it, a CUDA tensor the kernel.
"""
import functools
import types

import torch

from .. import ops3d
from ..line_trace3 import firsthit_slack3
from . import _build

_SCALAR, _VELOCITY = 1, 2
# The launches of M's viscous route (M with orig), which also count on
# advect_velocity3.
velocity_orig = types.SimpleNamespace(launches=0)


def advect_all3_plain(dt, rho, U, flags, maccormack_strength=0.75,
                      max_disp=2, line_trace=False):
    """(advect_scalar3, advect_velocity3) on the window engine, both from
    the same pre-advection U. Returns (rho', U')."""
    rho_out = ops3d.advect_scalar3(dt, rho, U, flags, maccormack_strength,
                                   max_disp=max_disp, line_trace=line_trace)
    U_out = ops3d.advect_velocity3(dt, U, flags, maccormack_strength,
                                   max_disp=max_disp)
    return rho_out, U_out


@functools.lru_cache(maxsize=None)
def _velocity_max_disp(with_orig: int) -> int:
    """The largest max_disp M's rings are built for, without or with
    orig: a constant of the built library, asked once a process."""
    return _build.query("fn_advect3_velocity_max_disp", with_orig)


def _launch(owner, parts, dt, rho, U, flags, maccormack_strength, max_disp,
            line_trace, orig=None):
    """Run the forward and backward kernels of ``parts`` on CUDA tensors;
    count both launches on ``owner``. Returns (rho', U'), None for a part
    not asked for."""
    b, d, h, w = flags.shape
    dev = U.device
    _build.check(U, "U", torch.float32, (b, 3, d, h, w), dev)
    _build.check(flags, "flags", torch.int32, (b, d, h, w), dev)
    if parts & _SCALAR:
        _build.check(rho, "rho", torch.float32, (b, d, h, w), dev)
    if orig is not None:
        _build.check(orig, "orig", torch.float32, (b, 3, d, h, w), dev)
    if min(d, h, w) < 3 or max_disp < 1:
        raise ValueError("3-D advection needs d, h, w >= 3 and max_disp >= 1")
    if parts == _VELOCITY:
        with_orig = int(orig is not None)
        most = _velocity_max_disp(with_orig)
        if max_disp > most:
            raise ValueError(
                f"advect_velocity3: max_disp {max_disp} exceeds {most}, the "
                "largest its shared-memory rings are built for"
                + (" with orig" if with_orig else ""))
    planes = (4 if parts & _SCALAR else 0) + (3 if parts & _VELOCITY else 0)
    scratch = torch.empty((planes, b, d, h, w), dtype=torch.float32,
                          device=dev)
    rho_out = torch.empty_like(rho) if parts & _SCALAR else None
    U_out = torch.empty_like(U) if parts & _VELOCITY else None
    dims_m = (w - 1e-5, h - 1e-5, d - 1e-5)
    slack = firsthit_slack3((d, h, w), max_disp)
    s = _build.stream()
    _build.call("fn_advect3_forward", parts, _build.ptr(rho), U.data_ptr(),
                _build.ptr(orig), flags.data_ptr(), scratch.data_ptr(), b, d,
                h, w, float(dt), *dims_m, slack, int(max_disp),
                int(line_trace), s)
    owner.launches += 1
    velocity_orig.launches += orig is not None
    _build.call("fn_advect3_backward", parts, _build.ptr(rho), U.data_ptr(),
                _build.ptr(orig), flags.data_ptr(), scratch.data_ptr(),
                _build.ptr(rho_out),
                _build.ptr(U_out), b, d, h, w, float(dt),
                maccormack_strength * 0.5, *dims_m, slack, int(max_disp),
                int(line_trace), s)
    owner.launches += 1
    velocity_orig.launches += orig is not None
    return rho_out, U_out


def advect_all3(dt, rho, U, flags, maccormack_strength=0.75, max_disp=2,
                line_trace=False):
    """Advect density ``rho`` (b, d, h, w) and the MAC velocity ``U``
    (b, 3, d, h, w) by U over ``flags`` (b, d, h, w) int32. Returns
    (rho', U')."""
    if not _build.on_cuda(U):
        return advect_all3_plain(dt, rho, U, flags, maccormack_strength,
                                 max_disp, line_trace)
    return _launch(advect_all3, _SCALAR | _VELOCITY, dt, rho, U, flags,
                   maccormack_strength, max_disp, line_trace)


def advect_scalar3(dt, src, U, flags, maccormack_strength=0.75, max_disp=2,
                   line_trace=False):
    """Advect scalar ``src`` (b, d, h, w) by ``U`` (b, 3, d, h, w) over
    ``flags``. Returns src'."""
    if not _build.on_cuda(U):
        return ops3d.advect_scalar3(dt, src, U, flags, maccormack_strength,
                                    max_disp=max_disp, line_trace=line_trace)
    return _launch(advect_scalar3, _SCALAR, dt, src, U, flags,
                   maccormack_strength, max_disp, line_trace)[0]


def advect_velocity3(dt, U, flags, maccormack_strength=0.75, max_disp=2,
                     orig=None):
    """Advect the MAC velocity ``orig`` (b, 3, d, h, w; U itself when None)
    by ``U`` (b, 3, d, h, w) over ``flags``. Returns the advected field."""
    if not _build.on_cuda(U):
        return ops3d.advect_velocity3(dt, U, flags, maccormack_strength,
                                      max_disp=max_disp, orig=orig)
    return _launch(advect_velocity3, _VELOCITY, dt, None, U, flags,
                   maccormack_strength, max_disp, False, orig)[1]


advect_all3.launches = 0
advect_scalar3.launches = 0
advect_velocity3.launches = 0
