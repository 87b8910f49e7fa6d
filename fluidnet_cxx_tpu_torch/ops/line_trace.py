"""Continuous first-hit obstacle trace (twin of the JAX package's
``ops/line_trace.py::line_trace_firsthit``, PARITY item 8).

The stopping point of a ray from a cell centre is the first intersection of
the segment [pos, pos+delta] with a blocked cell's HIT_MARGIN-expanded box
inside the (2D+1)^2 window or with the domain's margin planes. Positions in
non-fluid cells, and zero-length rays, return ``pos`` unchanged.
"""
import torch

from ..celltype import FLUID
from .common import F32, cell_index_grid, nb

HIT_MARGIN = 1e-5
EPSILON = 1e-12
_INF = 3e38


def _const(ref, value):
    return torch.full((), value, dtype=F32, device=ref.device)


def firsthit_axis_slabs(p0, d, lo, hi):
    """Per-axis slab entry/exit parameters of a ray p0 + t*d against
    [lo, hi]."""
    inf, ninf = _const(p0, _INF), _const(p0, -_INF)
    ok = d.abs() > EPSILON
    inv = 1.0 / torch.where(ok, d, torch.ones_like(d))
    t1 = (lo - p0) * inv
    t2 = (hi - p0) * inv
    inside = (p0 >= lo) & (p0 <= hi)
    t_lo = torch.where(ok, torch.minimum(t1, t2),
                       torch.where(inside, ninf, inf))
    t_hi = torch.where(ok, torch.maximum(t1, t2),
                       torch.where(inside, inf, ninf))
    return t_lo, t_hi


def firsthit_border_t(p0, d, dim: int):
    """First non-negative t at which the coordinate reaches the domain's
    HIT_MARGIN / dim-HIT_MARGIN planes moving outward."""
    inf = _const(p0, _INF)
    ok = d.abs() > EPSILON
    inv = 1.0 / torch.where(ok, d, torch.ones_like(d))
    t1 = (HIT_MARGIN - p0) * inv
    t2 = (dim - HIT_MARGIN - p0) * inv
    t1 = torch.where(ok & (t1 >= 0), t1, inf)
    t2 = torch.where(ok & (t2 >= 0), t2, inf)
    return torch.minimum(t1, t2)


def line_trace_firsthit(pos, delta, flags, D: int = 4):
    """Trace ``pos`` (b, 2, h, w) along ``delta`` (b, 2, h, w), stopping at
    the first blocked cell box or domain margin within the window."""
    b, h, w = flags.shape
    xx, yy = cell_index_grid(b, h, w, pos.device)
    px0, py0 = pos[:, 0], pos[:, 1]
    dx, dy = delta[:, 0], delta[:, 1]
    length = torch.sqrt(dx * dx + dy * dy)
    can = (length > EPSILON) & (flags == FLUID)
    inv_len = 1.0 / torch.clamp(length, min=EPSILON)
    dirx, diry = dx * inv_len, dy * inv_len

    t_stop = torch.minimum(firsthit_border_t(px0, dirx, w),
                           firsthit_border_t(py0, diry, h))
    t_stop = torch.minimum(t_stop, length)

    blockedf = (flags != FLUID).to(F32)
    for oy in range(-D, D + 1):
        for ox in range(-D, D + 1):
            if ox == 0 and oy == 0:
                continue
            bl = nb(blockedf, oy, ox) > 0.5
            valid = ((xx + ox >= 0) & (xx + ox < w)
                     & (yy + oy >= 0) & (yy + oy < h))
            loX = (xx + ox).to(F32) - HIT_MARGIN
            loY = (yy + oy).to(F32) - HIT_MARGIN
            tx_lo, tx_hi = firsthit_axis_slabs(
                px0, dirx, loX, loX + 1.0 + 2.0 * HIT_MARGIN)
            ty_lo, ty_hi = firsthit_axis_slabs(
                py0, diry, loY, loY + 1.0 + 2.0 * HIT_MARGIN)
            t_in = torch.maximum(tx_lo, ty_lo)
            t_out = torch.minimum(tx_hi, ty_hi)
            hit = bl & valid & (t_in <= t_out) & (t_in >= 0)
            t_stop = torch.where(hit, torch.minimum(t_stop, t_in), t_stop)

    t_stop = torch.clamp(t_stop, min=0.0)
    traced = torch.stack([px0 + t_stop * dirx, py0 + t_stop * diry], dim=1)
    return torch.where(can[:, None], traced, pos)
