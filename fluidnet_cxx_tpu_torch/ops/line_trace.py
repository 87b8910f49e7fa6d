"""Continuous first-hit obstacle trace (twin of the JAX package's
``ops/line_trace.py::line_trace_firsthit``, PARITY item 8).

The stopping point of a ray from a cell centre is the first intersection of
the segment [pos, pos+delta] with a blocked cell's HIT_MARGIN-expanded box
inside the (2D+1)^2 window or with the domain's margin planes. Positions in
non-fluid cells, and zero-length rays, return ``pos`` unchanged.

Kernels A and D (``csrc/advect_all.cu``) trace from cell centres and walk
only the pruned box of ``firsthit_box2`` instead of the whole window; the
cells they leave out cannot lower the stopping point, so the result is
the same to the bit (the proof is in the kernel's note).
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


def firsthit_slack2(dims, D: int) -> float:
    """The pruned box's margin for a grid of ``dims`` (h, w) and window D:
    2^-12 + (max(dims) + D) * 2^-21. It must exceed the 1e-5 hit margin
    plus the rounding of lo = x - 1e-5 (half an ulp of x: up to x * 2^-24,
    2^-12 at x = 8000, where the 1e-5 rounds away entirely), of 0.5 + disp
    and of lo - (x + 0.5), and the few ulp of 1/dir against len/disp:
    with max(dims) up to 2^23 it does, by more than 2^-12 - 1e-5. The
    wrapper of kernels A and D passes it to the kernel as a float32."""
    return 2.0 ** -12 + (max(dims) + D) * 2.0 ** -21


def firsthit_box(delta, D: int, slack: float):
    """The cells that the pruned first-hit walk visits for a ray from a
    cell centre along ``delta`` (b, k, ...), clipped to +-D: for each of
    the k components the (lowest, highest) offset from the ray's cell as
    int32 tensors, [floor(0.5 + delta - slack), 0] for delta < 0 and [0,
    floor(0.5 + delta + slack)] for delta > 0, within [-D, D]; [0, 0] for
    delta == 0 (the kernels also clip the box to the grid). Same float32
    expressions as the kernels'."""
    s = torch.tensor(slack, dtype=F32, device=delta.device)
    zero = torch.zeros((), dtype=F32, device=delta.device)
    box = []
    for c in range(delta.shape[1]):
        dc = delta[:, c]
        e = 0.5 + dc
        lo = torch.where(dc < 0, torch.clamp(torch.floor(e - s), min=-D),
                         zero)
        hi = torch.where(dc > 0, torch.clamp(torch.floor(e + s), max=D),
                         zero)
        box.append((lo.to(torch.int32), hi.to(torch.int32)))
    return box


def firsthit_box2(delta, D: int, slack: float):
    """``firsthit_box`` of 2-D rays ``delta`` (b, 2, h, w): the x and y
    offset ranges that kernels A and D walk."""
    return firsthit_box(delta, D, slack)


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
