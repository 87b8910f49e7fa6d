"""Halo exchange over the mesh's sx axis and the width-sharded Jacobi solves
(the twin of the JAX package's ``parallel/halo.py``).

``pad_columns`` gives each rank its slab with up to ``g`` columns of its
neighbours on each side: as many as the global grid holds there, so a slab
on a global domain edge has no halo on that side and position-dependent
code (the border ring, the clamps at the array's edge) runs there as on one
device. The fields go in one message a direction: float32 and int32
tensors (the int32 ones as their float32 bits) side by side. A halo wider
than a neighbour's slab takes several hops.

``solve_jacobi_sharded`` keeps JAX's semantics (``halo.py:39-99``: the
border ring pinned by global position, the obstacle-Neumann substitution)
with another communication pattern. JAX exchanges one column a sweep; here
each rank holds a ghost zone of ``g = k + 1`` columns and runs ``k`` sweeps
of kernel F (``ops/kernels/jacobi.py::solve_jacobi``, ``p0`` the padded
pressure) between two exchanges of p. F pins the padded slab's outer
columns as border; that error creeps inward one column a sweep, so after
``k`` sweeps the halo's columns 0..k are stale and every owned cell holds
the single-device value, to the bit: each cell's arithmetic and its order
are the same. With F's 8 sweeps a launch, k = 8: Jacobi-34 is one exchange
of flags and div, four of p and five F calls. The flags' halo is exchanged
once a solve.

``solve_jacobi3_sharded`` is the 3-D counterpart on kernel I
(``ops/kernels/jacobi3.py::solve_jacobi3``, 3 sweeps a z-march), split
along w with k = 9. JAX's 3-D sharded step gets it from GSPMD.

On the CPU the same code runs F's and I's plain versions.
"""
import math

import torch
import torch.distributed as dist

from ..ops.jacobi import _sweep_maker
from ..ops.kernels.jacobi import solve_jacobi
from ..ops.kernels.jacobi3 import solve_jacobi3

# Sweeps between two exchanges of p: kernel F's sweeps a launch, and a
# multiple of kernel I's 3 sweeps a z-march.
SWEEPS = 8
SWEEPS3 = 9


def _pack(tensors):
    """(rows, w) float32: each tensor's leading axes folded into rows, an
    int32 one as its bits."""
    rows = []
    for t in tensors:
        if t.dtype == torch.int32:
            t = t.view(torch.float32)
        elif t.dtype != torch.float32:
            raise ValueError(f"the halo exchange carries float32 and int32, "
                             f"not {t.dtype}")
        rows.append(t.reshape(-1, t.shape[-1]))
    return torch.cat(rows, 0)


def _unpack(packed, tensors):
    out, i = [], 0
    for t in tensors:
        n = t.numel() // t.shape[-1]
        part = packed[i:i + n].reshape(*t.shape[:-1], packed.shape[-1])
        out.append(part.view(torch.int32) if t.dtype == torch.int32
                   else part)
        i += n
    return out


def _p2p(mesh, sends, recvs):
    """Send each (tensor, rank) of ``sends`` and receive each (shape,
    rank) of ``recvs``; returns the received tensors on the mesh's device.
    Under gloo with CUDA tensors through pinned host buffers."""
    staged = mesh.staged
    if staged:
        host = []
        for t, peer in sends:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            host.append((buf, peer))
        torch.cuda.current_stream(mesh.device).synchronize()
        sends = host
    where = dict(pin_memory=True) if staged else dict(device=mesh.device)
    bufs = [(torch.empty(shape, dtype=torch.float32, **where), peer)
            for shape, peer in recvs]
    ops = ([dist.P2POp(dist.isend, t, peer) for t, peer in sends]
           + [dist.P2POp(dist.irecv, t, peer) for t, peer in bufs])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [t.to(mesh.device) if staged else t for t, _ in bufs]


def pad_columns(mesh, tensors, g: int, periodic: bool = False):
    """Each of ``tensors`` (this rank's slabs, the same width w in the last
    axis) with up to ``g`` neighbouring columns on each side, fewer at a
    global domain edge; one message a direction and hop. ``periodic``:
    the sx ranks form a ring, and every rank gets ``g`` columns on each
    side, those past a domain edge from the other edge (the multigrid
    levels, whose rolls wrap there). Returns (padded tensors, left width,
    right width)."""
    n, i = mesh.sx, mesh.sx_index
    wl = tensors[0].shape[-1]
    if n == 1 or g == 0:
        return list(tensors), 0, 0
    mesh.exchanges += 1
    x = _pack(tensors)
    rows = x.shape[0]
    left = x[:, :0]
    right = x[:, :0]
    has_left, has_right = periodic or i > 0, periodic or i < n - 1
    left_peer = mesh.rank_of(mesh.dp_index, (i - 1) % n)
    right_peer = mesh.rank_of(mesh.dp_index, (i + 1) % n)
    hops = math.ceil(g / wl) if periodic else min(math.ceil(g / wl), n - 1)
    for k in range(1, hops + 1):
        sends, recvs = [], []
        if has_right:
            ext = torch.cat([left, x], 1)
            sends.append((ext[:, -min(g, ext.shape[1]):].contiguous(),
                          right_peer))
        if has_left:
            ext = torch.cat([x, right], 1)
            sends.append((ext[:, :min(g, ext.shape[1])].contiguous(),
                          left_peer))
        reach_l = k if periodic else min(i, k)
        reach_r = k if periodic else min(n - 1 - i, k)
        if has_left:
            recvs.append(((rows, min(g, reach_l * wl)), left_peer))
        if has_right:
            recvs.append(((rows, min(g, reach_r * wl)), right_peer))
        got = _p2p(mesh, sends, recvs)
        if has_left:
            left = got.pop(0)
        if has_right:
            right = got.pop(0)
    padded = torch.cat([left, x, right], 1)
    return _unpack(padded, tensors), left.shape[1], right.shape[1]


def crop(t, left: int, wl: int):
    """The ``wl`` owned columns of a padded tensor with ``left`` halo
    columns."""
    return t[..., left:left + wl].contiguous()


def _solve_sharded(solve, flags, div, iters, mesh, sweeps, p0=None,
                   damping: float = 1.0):
    """``iters`` sweeps of ``solve`` (kernel F or I) on the ghost-zone
    slabs from ``p0`` (this rank's slab; default 0), ``sweeps`` between
    exchanges of p."""
    if mesh.sx == 1:
        mesh.solver_calls += 1
        return solve(flags, div, iters, p0=p0, damping=damping)
    if iters < 0:
        raise ValueError("the Jacobi solve needs iters >= 0")
    wl = div.shape[-1]
    g = sweeps + 1
    (flags_p, div_p), lw, _ = pad_columns(mesh, [flags, div], g)
    p = torch.zeros_like(div) if p0 is None else p0
    done = 0
    while done < iters:
        k = min(sweeps, iters - done)
        start = (None if done == 0 and p0 is None
                 else pad_columns(mesh, [p], g)[0][0])
        mesh.solver_calls += 1
        p = crop(solve(flags_p, div_p, k, p0=start, damping=damping), lw, wl)
        done += k
    return p


def solve_jacobi_sharded(flags, div, iters: int, mesh):
    """Fixed-iteration Jacobi with the width split over the mesh's sx axis:
    ``flags`` (b, h, w) int32 and ``div`` (b, h, w) are this rank's slabs
    (``state_sharding``); returns its slab of p, equal to the single-device
    ``solve_jacobi`` on the whole grid. ``SWEEPS`` sweeps of kernel F
    between two exchanges of p."""
    return _solve_sharded(solve_jacobi, flags, div, iters, mesh, SWEEPS)


def solve_jacobi3_sharded(flags, div, iters: int, mesh, p0=None,
                          damping: float = 1.0):
    """The 3-D twin: ``flags`` and ``div`` (b, d, h, w) this rank's slabs
    along w; ``SWEEPS3`` sweeps of kernel I between two exchanges of p,
    from ``p0`` (default 0) with ``damping`` (``solve_mg3``'s smoother)."""
    return _solve_sharded(solve_jacobi3, flags, div, iters, mesh, SWEEPS3,
                          p0, damping)


def _global_residual(mesh, p_new, p_old, lw, wl):
    """``ops/jacobi.py::_residual`` over the whole grid: each batch
    entry's sum of squares over the owned cells, summed over the sx ranks,
    its square root, the max over the batch, then over every rank."""
    d = crop(p_new - p_old, lw, wl).reshape(p_new.shape[0], -1)
    sq = torch.sum(d * d, dim=1)
    if mesh.sx > 1:
        dist.all_reduce(sq, group=mesh.row)
    res = torch.sqrt(sq).max()
    dist.all_reduce(res, op=dist.ReduceOp.MAX)
    return res


def solve_jacobi_tol_sharded(flags, div, p_tol: float, max_iter: int,
                             mesh):
    """``ops/jacobi.py::solve_jacobi`` (the early exit at ``p_tol``) on the
    slabs: plain sweeps, as on one device, the halo of p exchanged every
    ``SWEEPS`` sweeps, and after each sweep the residual over the whole
    grid (one all_reduce of sums over sx, one max over the world). The
    sums run in another order than on one device, so near ``p_tol`` the
    sweep count may differ. Returns (p, residual)."""
    wl = div.shape[-1]
    g = SWEEPS + 1
    (flags_p, div_p), lw, _ = pad_columns(mesh, [flags, div], g)
    sweep = _sweep_maker(flags_p, div_p)
    p = torch.zeros_like(div_p)
    res = torch.tensor(float("inf"), dtype=torch.float32, device=div.device)
    it = 0
    while it < max_iter and bool(res >= p_tol):
        if it and it % SWEEPS == 0:
            p = pad_columns(mesh, [crop(p, lw, wl)], g)[0][0]
        p_new = sweep(p)
        res = _global_residual(mesh, p_new, p, lw, wl)
        p, it = p_new, it + 1
    return crop(p, lw, wl), res
