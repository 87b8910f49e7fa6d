"""MacCormack semi-Lagrangian advection, bounded-window engine (twin of the
JAX package's ``ops/advection.py`` with ``impl='window'``).

MacCormack only, border width 1. Scalar advection back-traces with the
first-hit obstacle trace (``line_trace_impl='firsthit'``, the formulation
the fused kernels run); velocity advection samples each MAC component at
its own face with a straight back-trace. Together they are the plain version of the advection
kernel (ops/kernels/advect.py); both read the same pre-advection U.
"""
import torch

from ..celltype import FLUID
from .common import F32, border_mask, cell_index_grid, nb, where0
from .grid import get_at_mac_x, get_at_mac_y, get_centered
from .line_trace import line_trace_firsthit
from .window import (
    clamp_bounds_scalar_window,
    clamp_component_mac_window,
    interpol_window,
    interpol_with_fluid_window,
)


def _centers(b, h, w, device):
    xx, yy = cell_index_grid(b, h, w, device)
    return torch.stack([xx.to(F32) + 0.5, yy.to(F32) + 0.5], dim=1)


def advect_scalar(dt, src, U, flags, sample_outside_fluid: bool = False,
                  maccormack_strength: float = 0.75, line_trace: bool = True,
                  max_disp: int = 4):
    """Advect scalar ``src`` (b, h, w) by ``U``. The border ring keeps the
    corrected value; solid cells keep their source value."""
    D = max_disp
    b, h, w = src.shape
    fluid = flags == FLUID
    start = _centers(b, h, w, src.device)
    border = border_mask(h, w, 1, src.device)
    cc = get_centered(U)

    def semi_lagrange(field, sdt):
        disp = torch.clamp(where0(~border[None, None], -sdt * cc), -D, D)
        if line_trace:
            back = line_trace_firsthit(start, disp, flags, D)
        else:
            back = start + disp
        if sample_outside_fluid:
            val = interpol_window(field, back, D)
        else:
            val = interpol_with_fluid_window(field, flags, back, D)
        return torch.where(fluid, val, field), back

    fwd_val, fwd_back = semi_lagrange(src, dt)
    fwd = where0(~border, fwd_val)
    fwd_pos = torch.where(fluid[:, None], fwd_back, start)
    bwd_val, _ = semi_lagrange(fwd, -dt)
    bwd = where0(~border, bwd_val)
    dst = torch.where(fluid, fwd + maccormack_strength * 0.5 * (src - bwd),
                      fwd)
    do_clamp, minv, maxv = clamp_bounds_scalar_window(
        src, fwd_pos, flags, sample_outside_fluid, D)
    clamped = torch.where(do_clamp,
                          torch.maximum(minv, torch.minimum(maxv, dst)), fwd)
    return torch.where(border, dst, clamped)


def advect_velocity(dt, orig, U, flags, maccormack_strength: float = 0.75,
                    max_disp: int = 4):
    """Advect MAC velocity ``orig`` by ``U`` with the Selle clamp; the
    output border ring is zeroed."""
    D = max_disp
    b, _, h, w = U.shape
    fluid = flags == FLUID
    start = _centers(b, h, w, U.device)
    keep = ~border_mask(h, w, 1, U.device)
    mac_x = where0(keep[None, None], get_at_mac_x(U))
    mac_y = where0(keep[None, None], get_at_mac_y(U))

    def semi_lagrange_mac(field, sdt):
        vx = interpol_window(field[:, 0], start + (-sdt) * mac_x, D)
        vy = interpol_window(field[:, 1], start + (-sdt) * mac_y, D)
        return torch.where(fluid[:, None], torch.stack([vx, vy], dim=1),
                           field)

    fwd = where0(keep[None, None], semi_lagrange_mac(orig, dt))
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

    clamp_u = clamp_component_mac_window(correct(0, skip_u), orig[:, 0],
                                         mac_x * dt, D)
    clamp_v = clamp_component_mac_window(correct(1, skip_v), orig[:, 1],
                                         mac_y * dt, D)
    return torch.stack([where0(keep, clamp_u), where0(keep, clamp_v)], dim=1)
