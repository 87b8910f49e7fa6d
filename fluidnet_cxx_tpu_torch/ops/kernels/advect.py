"""Kernel A: merged scalar + MAC-velocity MacCormack advection.

Replaces ``fluidnet_cxx_tpu/ops/pallas/advect_pallas.py::advect_all_pallas``
with the CUDA kernel in ``csrc/advect_all.cu`` (two launches: forward
samples into scratch, then backward samples, correction and clamps). Its
plain version, ``advect_all_plain``, is the window engine of
``ops/advection.py``; a CPU tensor runs it, a CUDA tensor the kernel.
"""
import torch

from ..advection import advect_scalar, advect_velocity
from . import _build


def advect_all_plain(dt, rho, U, flags, maccormack_strength=0.75,
                     sample_outside_fluid=False, max_disp=4,
                     line_trace=True):
    """(advect_scalar, advect_velocity) on the window engine, both from the
    same pre-advection U. Returns (rho', U')."""
    rho_out = advect_scalar(
        dt, rho, U, flags, maccormack_strength=maccormack_strength,
        sample_outside_fluid=sample_outside_fluid, line_trace=line_trace,
        max_disp=max_disp)
    U_out = advect_velocity(dt, U, U, flags,
                            maccormack_strength=maccormack_strength,
                            max_disp=max_disp)
    return rho_out, U_out


def advect_all(dt, rho, U, flags, maccormack_strength=0.75,
               sample_outside_fluid=False, max_disp=4, line_trace=True):
    """Advect density ``rho`` (b, h, w) and velocity ``U`` (b, 2, h, w) by
    ``U`` over ``flags`` (b, h, w) int32. Returns (rho', U')."""
    if not _build.on_cuda(U):
        return advect_all_plain(dt, rho, U, flags, maccormack_strength,
                                sample_outside_fluid, max_disp, line_trace)
    b, h, w = flags.shape
    dev = U.device
    _build.check(rho, "rho", torch.float32, (b, h, w), dev)
    _build.check(U, "U", torch.float32, (b, 2, h, w), dev)
    _build.check(flags, "flags", torch.int32, (b, h, w), dev)
    if h < 2 or w < 2 or max_disp < 1:
        raise ValueError("advect_all needs h, w >= 2 and max_disp >= 1")
    scratch = torch.empty((5, b, h, w), dtype=torch.float32, device=dev)
    rho_out = torch.empty_like(rho)
    U_out = torch.empty_like(U)
    wm, hm = w - 1e-5, h - 1e-5
    s = _build.stream()
    _build.call("fn_advect_forward", rho.data_ptr(), U.data_ptr(),
                flags.data_ptr(), scratch.data_ptr(), b, h, w, float(dt), wm,
                hm, int(max_disp), int(line_trace), int(sample_outside_fluid),
                s)
    advect_all.launches += 1
    _build.call("fn_advect_backward", rho.data_ptr(), U.data_ptr(),
                flags.data_ptr(), scratch.data_ptr(), rho_out.data_ptr(),
                U_out.data_ptr(), b, h, w, float(dt),
                maccormack_strength * 0.5, wm, hm, int(max_disp),
                int(line_trace), int(sample_outside_fluid), s)
    advect_all.launches += 1
    return rho_out, U_out


advect_all.launches = 0
