"""Kernels A, D and E: MacCormack advection on the window engine.

* A ``advect_all``: scalar + MAC velocity from the same pre-advection U;
  replaces ``fluidnet_cxx_tpu/ops/pallas/advect_pallas.py::
  advect_all_pallas``.
* D ``advect_scalar``: the scalar alone (first-hit trace); replaces
  ``advect_pallas.py::advect_scalar_pallas``.
* E ``advect_velocity``: the MAC velocity alone; replaces
  ``advect_pallas.py::advect_velocity_pallas``.

E runs ``csrc/advect_all.cu::advect_tile`` in one launch: a block copies
the halo its output tile reads into shared memory, computes the forward
field over the tile and D + 1 cells around it, and runs the backward
samples, correction and Selle clamp from there. The tile comes from
``plan_tile``; the kernel is built for ``max_disp`` up to
``fn_advect_max_disp()`` (8), and a larger one raises, in D too. A and D
run two launches (forward samples into scratch, then backward samples,
correction and clamps), one thread a cell; their first-hit trace walks
the pruned box of ``line_trace.firsthit_box2``, whose margin the wrapper
passes. A and E take an optional ``orig``, the field that U advects (the
viscous field); without it U advects itself. Their plain versions are
the window engine of ``ops/advection.py``: a CPU tensor runs it, a CUDA
tensor the kernel.
"""
import math

import torch

from .. import advection
from ..line_trace import firsthit_slack2
from . import _build

SMS = 132  # an H100's SMs: each main path's grid gets at least this many
# Output tiles (width, height) of advect_tile, largest first: widths are
# multiples of 32 (a warp a row), heights of 8 (the block's 8 warps).
TILES = ((64, 32), (64, 16), (32, 16), (32, 8))
# csrc/advect_all.cu's halos (a, lo, hi): a * D + lo cells before the
# tile, a * D + hi after it; the columns a copied row starts and ends on;
# the shared memory a block may have.
IN_HALO, FWD_HALO = (2, 0, 2), (1, 0, 1)
ALIGN = 4
SMEM_MAX = 232448


def _region(halo, tw, th, D, copied):
    """(width, height) of a halo's region (``csrc/advect_all.cu::region``):
    a copied one's rows start and end on multiples of ALIGN columns."""
    a, lo, hi = halo
    before, after = a * D + lo, a * D + hi
    side = (lambda n: -(-n // ALIGN) * ALIGN) if copied else (lambda n: n)
    return tw + side(before) + side(after), th + before + after


def tile_smem(tw, th, D):
    """Bytes of dynamic shared memory of one block of kernel E
    (``csrc/advect_all.cu::layout``): orig's two components copied over
    IN_HALO and the forward field's two over FWD_HALO, 4 bytes a cell,
    then the fluid bytes over FWD_HALO, widened as a copied region."""
    return (4 * 2 * (math.prod(_region(IN_HALO, tw, th, D, True))
                     + math.prod(_region(FWD_HALO, tw, th, D, False)))
            + math.prod(_region(FWD_HALO, tw, th, D, True)))


def plan_tile(b, h, w, D):
    """The output tile (tw, th) of kernel E for a (b, h, w) grid: the
    largest of TILES whose grid has at least SMS blocks and whose shared
    memory fits a block, else the smallest that fits. A larger tile
    recomputes less of the forward field in its halo (64 x 32: 1.46x at
    D = 4; 32 x 8: 2.7x); a grid short of SMS blocks leaves SMs idle."""
    fits = [t for t in TILES if tile_smem(*t, D) <= SMEM_MAX]
    for tw, th in fits:
        if b * -(-w // tw) * -(-h // th) >= SMS:
            return tw, th
    return fits[-1]


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
    slack = firsthit_slack2((h, w), max_disp)
    s = _build.stream()
    _build.call("fn_advect_forward", rho.data_ptr(), U.data_ptr(),
                _build.ptr(orig), flags.data_ptr(), scratch.data_ptr(), b, h,
                w, float(dt), wm, hm, slack, int(max_disp), int(line_trace),
                int(sample_outside_fluid), s)
    advect_all.launches += 1
    _build.call("fn_advect_backward", rho.data_ptr(), U.data_ptr(),
                _build.ptr(orig), flags.data_ptr(), scratch.data_ptr(),
                rho_out.data_ptr(), U_out.data_ptr(), b, h, w, float(dt),
                maccormack_strength * 0.5, wm, hm, slack, int(max_disp),
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
    _check_max_disp("advect_scalar", max_disp)
    scratch = torch.empty((3, b, h, w), dtype=torch.float32, device=U.device)
    out = torch.empty_like(src)
    wm, hm = w - 1e-5, h - 1e-5
    slack = firsthit_slack2((h, w), max_disp)
    s = _build.stream()
    _build.call("fn_advect_scalar_forward", src.data_ptr(), U.data_ptr(),
                flags.data_ptr(), scratch.data_ptr(), b, h, w, float(dt), wm,
                hm, slack, int(max_disp), int(line_trace),
                int(sample_outside_fluid), s)
    advect_scalar.launches += 1
    _build.call("fn_advect_scalar_backward", src.data_ptr(), U.data_ptr(),
                flags.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, h, w,
                float(dt), maccormack_strength * 0.5, wm, hm, slack,
                int(max_disp), int(line_trace), int(sample_outside_fluid), s)
    advect_scalar.launches += 1
    return out


def _check_max_disp(name, max_disp):
    """Raise above the largest max_disp E's tiles are built for (D is held
    to the same limit)."""
    most = _build.constant("fn_advect_max_disp")
    if max_disp > most:
        raise ValueError(f"{name}: max_disp {max_disp} exceeds {most}, the "
                         "largest the 2-D advection kernels are built for")


def advect_velocity(dt, U, flags, maccormack_strength=0.75, max_disp=4,
                    orig=None):
    """Advect MAC velocity ``orig`` (default U) by ``U`` (b, 2, h, w) over
    ``flags`` (b, h, w) int32. Returns the advected velocity."""
    if not _build.on_cuda(U):
        return advection.advect_velocity(
            dt, U if orig is None else orig, U, flags,
            maccormack_strength=maccormack_strength, max_disp=max_disp)
    b, h, w = _check(U, flags, max_disp, orig)
    _check_max_disp("advect_velocity", max_disp)
    tw, th = plan_tile(b, h, w, max_disp)
    out = torch.empty_like(U)
    _build.call("fn_advect_velocity", U.data_ptr(), _build.ptr(orig),
                flags.data_ptr(), out.data_ptr(), b, h, w, float(dt),
                maccormack_strength * 0.5, int(max_disp), tw, th,
                _build.stream())
    advect_velocity.launches += 1
    return out


advect_all.launches = 0
advect_scalar.launches = 0
advect_velocity.launches = 0
