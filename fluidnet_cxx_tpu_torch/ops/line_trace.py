"""Obstacle-aware back-traces (twin of the JAX package's
``ops/line_trace.py``): the iterative march ``calc_line_trace`` and the
continuous first-hit trace ``line_trace_firsthit`` (PARITY item 8).

The march steps a ray one cell length at a time; a step that leaves the
domain backs off to the border, and one that enters a blocked (non-fluid)
cell backs off to that cell's HIT_MARGIN-expanded box in up to four
spins. It runs JAX's ``while_loop``: while some ray is live, at most
floor(the longest ray) + 3 iterations. The host reads that bound once a
call and tests for a live ray before each iteration and each spin (an
iteration or a spin without one changes nothing), so a step that runs
the march synchronises with the card a few times and cannot be captured
in a CUDA graph.

The first-hit stopping point of a ray from a cell centre is the first intersection of
the segment [pos, pos+delta] with a blocked cell's HIT_MARGIN-expanded box
inside the (2D+1)^2 window or with the domain's margin planes. Positions in
non-fluid cells, and zero-length rays, return ``pos`` unchanged.

Kernels A and D (``csrc/advect_all.cu``) trace from cell centres and walk
only the pruned box of ``firsthit_box2`` instead of the whole window; the
cells they leave out cannot lower the stopping point, so the result is
the same to the bit (the proof is in the kernel's note).
"""
import math

import torch

from ..celltype import FLUID
from .common import F32, I32, cell_index_grid, gather2d, nb

HIT_MARGIN = 1e-5
EPSILON = 1e-12
_INF = 3e38


def _const(ref, value):
    return torch.full((), value, dtype=F32, device=ref.device)


def _is_out_of_domain(pos, h, w):
    """True where ``pos`` (b, 2, h, w) lies on or beyond a domain wall."""
    x, y = pos[:, 0], pos[:, 1]
    return (x <= 0) | (x >= w) | (y <= 0) | (y >= h)


def _is_blocked_cell(pos, flags):
    """True where ``pos`` falls in a non-fluid cell; False outside the
    domain."""
    _, h, w = flags.shape
    out = _is_out_of_domain(pos, h, w)
    zero = torch.zeros((), dtype=I32, device=pos.device)
    ix = torch.where(out, zero, torch.trunc(pos)[:, 0].to(I32))
    iy = torch.where(out, zero, torch.trunc(pos)[:, 1].to(I32))
    return (gather2d(flags, iy, ix) != FLUID) & (~out)


def _where2(mask, a, b):
    """``a`` where ``mask`` (b, ...) else ``b``, over the channel axis."""
    return torch.where(mask[:, None], a, b)


def _ray_border_intersection(pos, next_pos, dims, m_out):
    """Where ``m_out``: the step t along pos -> next_pos at which the ray
    meets the domain's HIT_MARGIN planes (the smallest over the planes
    next_pos lies beyond), as (hit, pos + t * (next_pos - pos)).
    ``dims`` are the extents of the position's channels, (w, h[, d])."""
    min_step = torch.full(pos.shape[:1] + pos.shape[2:], float("inf"),
                          dtype=F32, device=pos.device)
    one = _const(pos, 1.0)
    for c, dim in enumerate(dims):
        pc, nc = pos[:, c], next_pos[:, c]
        d = nc - pc
        movable = (d.abs() >= EPSILON) & m_out
        for beyond, plane in ((nc <= HIT_MARGIN, HIT_MARGIN),
                              (nc >= dim - HIT_MARGIN, dim - HIT_MARGIN)):
            applicable = beyond & movable
            step = (plane - pc) / torch.where(applicable, d, one)
            min_step = torch.where(applicable,
                                   torch.minimum(min_step, step), min_step)
    hit = (min_step >= 0) & torch.isfinite(min_step)
    step = torch.where(hit, min_step, _const(pos, 0.0))[:, None]
    return hit, step * (next_pos - pos) + pos


def _ray_box_intersection(origin, direction, ctr, mask):
    """Slab test of the unit box centred at ``ctr`` (expanded by
    HIT_MARGIN) against the ray from ``origin`` along ``direction``:
    (hit, coord). An origin inside the expanded box returns itself (the
    reference's intent); a hit whose other coordinates leave the box by
    more than 1e-6 is rejected. 2-D or 3-D by the channel count."""
    box_min = ctr - 0.5 - HIT_MARGIN
    box_max = ctr + 0.5 + HIT_MARGIN
    err_tol = 1e-6
    n = origin.shape[1]
    below = origin < box_min
    above = origin > box_max
    outside_dim = below | above
    inside = ~outside_dim.any(dim=1)
    zero = _const(origin, 0.0)
    candidate = torch.where(below, box_min, torch.where(above, box_max, zero))
    dir_ok = direction.abs() > 0
    maxT = torch.where(
        outside_dim & dir_ok,
        (candidate - origin) / torch.where(dir_ok, direction,
                                           _const(origin, 1.0)),
        _const(origin, -1.0))
    # argmax with the first index on ties, as jnp.argmax.
    which = torch.zeros(maxT.shape[:1] + maxT.shape[2:], dtype=torch.long,
                        device=origin.device)
    final = maxT[:, 0]
    for c in range(1, n):
        more = maxT[:, c] > final
        which = torch.where(more, c, which)
        final = torch.where(more, maxT[:, c], final)
    hit = inside | (final >= 0)
    coord = origin + final[:, None] * direction
    coord = torch.stack([torch.where(which == c, candidate[:, c], coord[:, c])
                         for c in range(n)], dim=1)
    oob = (coord < box_min - err_tol) | (coord > box_max + err_tol)
    bad = torch.zeros_like(hit)
    for c in range(n):
        bad = bad | ((which != c) & oob[:, c])
    hit = hit & (~bad) & mask
    coord = _where2(inside & mask, origin, coord)
    return hit, coord


def march(pos, delta, dims, blocked_lookup, out_of_domain):
    """The march of ``calc_line_trace`` and ``calc_line_trace3``: ``pos``
    and ``delta`` (b, k, ...) with k channels of extents ``dims`` (w, h[,
    d]), ``blocked_lookup(q)`` and ``out_of_domain(q)`` boolean (b, ...)
    tests of positions."""
    m_cont = (~out_of_domain(pos)) & (~blocked_lookup(pos))
    length = delta[:, 0] * delta[:, 0]
    for c in range(1, delta.shape[1]):
        length = length + delta[:, c] * delta[:, c]
    # Rounded once from float64: torch's float32 sqrt on the CPU is off by
    # an ulp on a few values, and a ray's length sets its last step.
    length = torch.sqrt(length.to(torch.float64)).to(F32)
    m_cont = m_cont & (length > EPSILON)
    direction = _where2(m_cont, delta / torch.clamp(length, min=EPSILON)
                        [:, None], _const(pos, 0.0))
    top = float(length.max()) if length.numel() else 0.0
    # JAX's bound, floor(max length) + 3 (an int32 that saturates).
    iters = int(math.floor(top)) + 3 if math.isfinite(top) else math.inf
    new_pos = pos
    cur_length = torch.zeros_like(length)
    one = _const(pos, 1.0)
    it = 0
    # JAX's loop condition; an iteration (or a back-off spin) without a
    # live ray would change nothing, and each test costs one sync.
    while it < iters and bool(m_cont.any()):
        it += 1
        m_cont = m_cont & ~(cur_length >= length - HIT_MARGIN)
        cur_step = torch.minimum(length - cur_length, one)
        next_pos = _where2(m_cont, new_pos + direction * cur_step[:, None],
                           new_pos)
        # Leaving the grid: back off to the border.
        m_out = out_of_domain(next_pos) & m_cont
        hit_b, ipos = _ray_border_intersection(pos, next_pos, dims, m_out)
        # The rare no-hit: clamp inside the domain (the clamp the
        # reference meant; its clampToDomain is a no-op).
        no_hit = (~hit_b) & m_out
        clamped = torch.stack([torch.clamp(next_pos[:, c], HIT_MARGIN,
                                           dim - HIT_MARGIN)
                               for c, dim in enumerate(dims)], dim=1)
        ipos = _where2(no_hit, clamped, ipos)
        ipos_blocked = blocked_lookup(ipos)
        blocked_i = ipos_blocked & m_out
        against_border = (~ipos_blocked) & m_out
        new_pos = _where2(against_border, ipos, new_pos)
        m_cont = m_cont & ~against_border
        next_pos = _where2(blocked_i & m_cont, ipos, next_pos)
        # Entering a blocked cell: back off to its box, four spins.
        m_block = blocked_lookup(next_pos) & m_cont
        count_mask = m_block
        for _ in range(4):
            if not bool(count_mask.any()):
                break
            count_mask = count_mask & blocked_lookup(next_pos)
            ctr = torch.trunc(next_pos) + 0.5
            hit, coord = _ray_box_intersection(new_pos, direction, ctr,
                                               count_mask)
            m_cont = m_cont & ~((~hit) & count_mask)
            count_mask = count_mask & hit
            next_pos = _where2(hit & count_mask, coord, next_pos)
        new_pos = _where2(m_block & m_cont, next_pos, new_pos)
        m_cont = m_cont & ~m_block
        new_pos = _where2(m_cont, next_pos, new_pos)
        cur_length = torch.where(m_cont, cur_length + cur_step, cur_length)
        m_cont = m_cont & ~(cur_length >= length - HIT_MARGIN)
    return new_pos


def calc_line_trace(pos, delta, flags, do_line_trace: bool = True,
                    blocked_lookup=None):
    """March from ``pos`` (b, 2, h, w) along ``delta``, stopping at walls
    and obstacles; ``pos + delta`` when ``do_line_trace`` is off (the
    velocity's straight back-trace). ``blocked_lookup`` replaces the
    gather lookup of a position's cell (the window engine passes
    ``window.make_blocked_lookup_window``'s)."""
    if not do_line_trace:
        return pos + delta
    if blocked_lookup is None:
        def blocked_lookup(q):
            return _is_blocked_cell(q, flags)
    _, h, w = flags.shape
    return march(pos, delta, (w, h), blocked_lookup,
                 lambda q: _is_out_of_domain(q, h, w))


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
