"""Kernels A, D and E: MacCormack advection on the window engine.

* A ``advect_all``: scalar + MAC velocity from the same pre-advection U;
  replaces ``fluidnet_cxx_tpu/ops/pallas/advect_pallas.py::
  advect_all_pallas``.
* D ``advect_scalar``: the scalar alone (first-hit trace); replaces
  ``advect_pallas.py::advect_scalar_pallas``.
* E ``advect_velocity``: the MAC velocity alone; replaces
  ``advect_pallas.py::advect_velocity_pallas``.

All three run the CUDA kernels of ``csrc/advect_all.cu`` in two launches
(forward samples into scratch, then backward samples, correction and
clamps). A and E take an optional ``orig``, the field that U advects (the
viscous field); without it U advects itself. Their plain versions are the
window engine of ``ops/advection.py``: a CPU tensor runs it, a CUDA tensor
the kernel.
"""
import torch

from .. import advection
from . import _build


def _check(U, flags, max_disp, orig=None):
    """Check the shared inputs; return (b, h, w)."""
    b, h, w = flags.shape
    _build.check(U, "U", torch.float32, (b, 2, h, w), U.device)
    _build.check(flags, "flags", torch.int32, (b, h, w), U.device)
    if orig is not None:
        _build.check(orig, "orig", torch.float32, (b, 2, h, w), U.device)
    if h < 2 or w < 2 or max_disp < 1:
        raise ValueError("advection needs h, w >= 2 and max_disp >= 1")
    return b, h, w


def advect_all_plain(dt, rho, U, flags, maccormack_strength=0.75,
                     sample_outside_fluid=False, max_disp=4,
                     line_trace=True, orig=None):
    """(advect_scalar, advect_velocity) on the window engine, both from the
    same pre-advection U. Returns (rho', U')."""
    rho_out = advection.advect_scalar(
        dt, rho, U, flags, maccormack_strength=maccormack_strength,
        sample_outside_fluid=sample_outside_fluid, line_trace=line_trace,
        max_disp=max_disp)
    U_out = advection.advect_velocity(
        dt, U if orig is None else orig, U, flags,
        maccormack_strength=maccormack_strength, max_disp=max_disp)
    return rho_out, U_out


def advect_all(dt, rho, U, flags, maccormack_strength=0.75,
               sample_outside_fluid=False, max_disp=4, line_trace=True,
               orig=None):
    """Advect density ``rho`` (b, h, w) and velocity ``orig`` (default U)
    (b, 2, h, w) by ``U`` over ``flags`` (b, h, w) int32. Returns
    (rho', U')."""
    if not _build.on_cuda(U):
        return advect_all_plain(dt, rho, U, flags, maccormack_strength,
                                sample_outside_fluid, max_disp, line_trace,
                                orig)
    b, h, w = _check(U, flags, max_disp, orig)
    _build.check(rho, "rho", torch.float32, (b, h, w), U.device)
    scratch = torch.empty((5, b, h, w), dtype=torch.float32, device=U.device)
    rho_out = torch.empty_like(rho)
    U_out = torch.empty_like(U)
    wm, hm = w - 1e-5, h - 1e-5
    s = _build.stream()
    _build.call("fn_advect_forward", rho.data_ptr(), U.data_ptr(),
                _build.ptr(orig), flags.data_ptr(), scratch.data_ptr(), b, h,
                w, float(dt), wm, hm, int(max_disp), int(line_trace),
                int(sample_outside_fluid), s)
    advect_all.launches += 1
    _build.call("fn_advect_backward", rho.data_ptr(), U.data_ptr(),
                _build.ptr(orig), flags.data_ptr(), scratch.data_ptr(),
                rho_out.data_ptr(), U_out.data_ptr(), b, h, w, float(dt),
                maccormack_strength * 0.5, wm, hm, int(max_disp),
                int(line_trace), int(sample_outside_fluid), s)
    advect_all.launches += 1
    return rho_out, U_out


def advect_scalar(dt, src, U, flags, maccormack_strength=0.75,
                  sample_outside_fluid=False, max_disp=4, line_trace=True):
    """Advect scalar ``src`` (b, h, w) by ``U`` (b, 2, h, w) over ``flags``
    (b, h, w) int32. Returns src'."""
    if not _build.on_cuda(U):
        return advection.advect_scalar(
            dt, src, U, flags, maccormack_strength=maccormack_strength,
            sample_outside_fluid=sample_outside_fluid, line_trace=line_trace,
            max_disp=max_disp)
    b, h, w = _check(U, flags, max_disp)
    _build.check(src, "src", torch.float32, (b, h, w), U.device)
    scratch = torch.empty((3, b, h, w), dtype=torch.float32, device=U.device)
    out = torch.empty_like(src)
    wm, hm = w - 1e-5, h - 1e-5
    s = _build.stream()
    _build.call("fn_advect_scalar_forward", src.data_ptr(), U.data_ptr(),
                flags.data_ptr(), scratch.data_ptr(), b, h, w, float(dt), wm,
                hm, int(max_disp), int(line_trace),
                int(sample_outside_fluid), s)
    advect_scalar.launches += 1
    _build.call("fn_advect_scalar_backward", src.data_ptr(), U.data_ptr(),
                flags.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, h, w,
                float(dt), maccormack_strength * 0.5, wm, hm, int(max_disp),
                int(line_trace), int(sample_outside_fluid), s)
    advect_scalar.launches += 1
    return out


def advect_velocity(dt, U, flags, maccormack_strength=0.75, max_disp=4,
                    orig=None):
    """Advect MAC velocity ``orig`` (default U) by ``U`` (b, 2, h, w) over
    ``flags`` (b, h, w) int32. Returns the advected velocity."""
    if not _build.on_cuda(U):
        return advection.advect_velocity(
            dt, U if orig is None else orig, U, flags,
            maccormack_strength=maccormack_strength, max_disp=max_disp)
    b, h, w = _check(U, flags, max_disp, orig)
    scratch = torch.empty((2, b, h, w), dtype=torch.float32, device=U.device)
    out = torch.empty_like(U)
    s = _build.stream()
    _build.call("fn_advect_velocity_forward", U.data_ptr(), _build.ptr(orig),
                flags.data_ptr(), scratch.data_ptr(), b, h, w, float(dt),
                int(max_disp), s)
    advect_velocity.launches += 1
    _build.call("fn_advect_velocity_backward", U.data_ptr(),
                _build.ptr(orig), flags.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), b, h, w, float(dt),
                maccormack_strength * 0.5, int(max_disp), s)
    advect_velocity.launches += 1
    return out


advect_all.launches = 0
advect_scalar.launches = 0
advect_velocity.launches = 0
