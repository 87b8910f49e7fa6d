"""Semi-Lagrangian advection (twin of the JAX package's
``ops/advection.py``): Euler (``EULER``) or MacCormack (``MACCORMACK``),
on the gather engine (``impl="gather"``: bilinear samples read at any
distance, ops/grid.py) or the bounded-window engine (``impl="window"``:
the back-traced position clamped to its cell's centre +- ``max_disp``,
ops/window.py). Scalar advection back-traces with the iterative march
(``line_trace_impl="march"``, ops/line_trace.py::calc_line_trace) or, on
the window engine, the first-hit obstacle trace (``"firsthit"``);
velocity advection samples each MAC component at its own face with a
straight back-trace. Both read the same pre-advection U.

The defaults are the window engine, MacCormack and the first-hit trace:
the plain version of the advection kernels (ops/kernels/advect.py), which
compute that function. The JAX package's defaults are the gather engine
and the march; the step passes the config's choice. The velocity's
solid-cell passthrough is per channel (the reference's passes channel 1
into channel 0 twice).
"""
import torch

from ..celltype import FLUID
from .common import F32, border_mask, cell_index_grid, nb, where0
from .grid import (get_at_mac_x, get_at_mac_y, get_centered, interpol,
                   interpol_with_fluid)
from .line_trace import calc_line_trace, line_trace_firsthit
from .window import (
    clamp_bounds_scalar_window,
    clamp_component_mac_window,
    corner_clamp,
    interpol_window,
    interpol_with_fluid_window,
    make_blocked_lookup_window,
    neighbourhood_bounds,
)

EULER = "eulerFluidNet"
MACCORMACK = "maccormackFluidNet"


def _centers(b, h, w, device):
    xx, yy = cell_index_grid(b, h, w, device)
    return torch.stack([xx.to(F32) + 0.5, yy.to(F32) + 0.5], dim=1)


def advect_scalar(dt, src, U, flags, sample_outside_fluid: bool = False,
                  maccormack_strength: float = 0.75, line_trace: bool = True,
                  max_disp: int = 4, *, method: str = MACCORMACK,
                  bnd: int = 1, impl: str = "window",
                  line_trace_impl: str = "firsthit"):
    """Advect scalar ``src`` (b, h, w) by ``U``. Solid cells keep their
    source value. Euler returns the forward sample with the ``bnd``-wide
    border ring zeroed; MacCormack corrects it and clamps the result to
    the source's extrema around the forward landing cell, and its border
    ring keeps the corrected value."""
    D = max_disp
    b, h, w = src.shape
    window = impl == "window"
    fluid = flags == FLUID
    start = _centers(b, h, w, src.device)
    ring1 = border_mask(h, w, 1, src.device)
    border = border_mask(h, w, bnd, src.device)
    cc = get_centered(U)
    lookup = (make_blocked_lookup_window(flags, D)
              if window and line_trace and line_trace_impl != "firsthit"
              else None)

    def semi_lagrange(field, sdt):
        disp = where0(~ring1[None, None], -sdt * cc)
        if window:
            disp = torch.clamp(disp, -D, D)
        if line_trace and window and line_trace_impl == "firsthit":
            back = line_trace_firsthit(start, disp, flags, D)
        else:
            back = calc_line_trace(start, disp, flags, line_trace,
                                   blocked_lookup=lookup)
        if sample_outside_fluid:
            val = (interpol_window(field, back, D) if window
                   else interpol(field, back))
        else:
            val = (interpol_with_fluid_window(field, flags, back, D)
                   if window else interpol_with_fluid(field, flags, back))
        return torch.where(fluid, val, field), back

    fwd_val, fwd_back = semi_lagrange(src, dt)
    fwd = where0(~border, fwd_val)
    if method == EULER:
        return fwd
    fwd_pos = torch.where(fluid[:, None], fwd_back, start)
    bwd_val, _ = semi_lagrange(fwd, -dt)
    bwd = where0(~border, bwd_val)
    dst = torch.where(fluid, fwd + maccormack_strength * 0.5 * (src - bwd),
                      fwd)
    if window:
        do_clamp, minv, maxv = clamp_bounds_scalar_window(
            src, fwd_pos, flags, sample_outside_fluid, D)
    else:
        do_clamp, minv, maxv = neighbourhood_bounds(
            src, fwd_pos, flags, sample_outside_fluid)
    clamped = torch.where(do_clamp,
                          torch.maximum(minv, torch.minimum(maxv, dst)), fwd)
    return torch.where(border, dst, clamped)


def advect_velocity(dt, orig, U, flags, maccormack_strength: float = 0.75,
                    max_disp: int = 4, *, method: str = MACCORMACK,
                    bnd: int = 1, impl: str = "window"):
    """Advect MAC velocity ``orig`` by ``U``: each component sampled along
    its face's full velocity vector; MacCormack adds the correction where
    the face lies between fluid cells and the Selle clamp. The output's
    ``bnd``-wide border ring is zeroed."""
    D = max_disp
    b, _, h, w = U.shape
    window = impl == "window"
    fluid = flags == FLUID
    start = _centers(b, h, w, U.device)
    keep1 = ~border_mask(h, w, 1, U.device)
    keep = ~border_mask(h, w, bnd, U.device)
    mac_x = where0(keep1[None, None], get_at_mac_x(U))
    mac_y = where0(keep1[None, None], get_at_mac_y(U))

    def sample(field_c, pos):
        return interpol_window(field_c, pos, D) if window else \
            interpol(field_c, pos)

    def semi_lagrange_mac(field, sdt):
        vx = sample(field[:, 0], start + (-sdt) * mac_x)
        vy = sample(field[:, 1], start + (-sdt) * mac_y)
        return torch.where(fluid[:, None], torch.stack([vx, vy], dim=1),
                           field)

    fwd = where0(keep[None, None], semi_lagrange_mac(orig, dt))
    if method == EULER:
        return fwd
    bwd = where0(keep[None, None], semi_lagrange_mac(fwd, -dt))

    xx, yy = cell_index_grid(b, h, w, U.device)
    fl_xm = nb(flags, 0, -1) == FLUID
    fl_ym = nb(flags, -1, 0) == FLUID
    skip_u = (~fluid) | ((xx > 0) & (~fl_xm))
    skip_v = (~fluid) | ((yy > 0) & (~fl_ym))

    def correct(c, skip):
        return torch.where(
            skip, fwd[:, c],
            fwd[:, c] + maccormack_strength * 0.5 * (orig[:, c] - bwd[:, c]))

    if window:
        clamp_u = clamp_component_mac_window(correct(0, skip_u), orig[:, 0],
                                             mac_x * dt, D)
        clamp_v = clamp_component_mac_window(correct(1, skip_v), orig[:, 1],
                                             mac_y * dt, D)
    else:
        clamp_u = corner_clamp(correct(0, skip_u), orig[:, 0], mac_x * dt)
        clamp_v = corner_clamp(correct(1, skip_v), orig[:, 1], mac_y * dt)
    return torch.stack([where0(keep, clamp_u), where0(keep, clamp_v)], dim=1)
