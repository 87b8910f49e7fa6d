"""Jacobi pressure sweeps (twin of the JAX package's ``ops/jacobi.py``):
pressure pinned to 0 on the border ring and in obstacles, obstacle
neighbours replaced by the centre value (homogeneous Neumann), optional
warm start ``p0`` and weighted-Jacobi ``damping``; the residual is
``max_b ||p - p_prev||_2``.

``solve_jacobi_fixed`` runs a fixed count of sweeps (the plain version of
kernel F, ``ops/kernels/jacobi.py``); ``solve_jacobi`` stops early once the
residual drops below ``p_tol``. Both are plain tensor code, as in JAX.
``jacobi_adjoint_fixed`` runs the transposed sweeps: the gradient of
``solve_jacobi_fixed``'s output with respect to ``p0`` (the plain version
of ``fn_jacobi_adjoint``).
"""
import torch

from ..celltype import OBSTACLE
from .common import border_mask, nb, where0


def _sweep_maker(flags, div, damping: float = 1.0, border=None):
    """One sweep's function; ``border`` (h, w) replaces the array's own
    border ring (a slab of a width-sharded grid pins the grid's)."""
    _, h, w = flags.shape
    obstacle = flags == OBSTACLE
    if border is None:
        border = border_mask(h, w, 1, div.device)
    cont = ~(border[None] | obstacle)
    ob_xm, ob_xp = nb(obstacle, 0, -1), nb(obstacle, 0, 1)
    ob_ym, ob_yp = nb(obstacle, -1, 0), nb(obstacle, 1, 0)
    w_ = float(damping)

    def sweep(p):
        p1 = torch.where(ob_xm, p, nb(p, 0, -1))
        p2 = torch.where(ob_xp, p, nb(p, 0, 1))
        p3 = torch.where(ob_ym, p, nb(p, -1, 0))
        p4 = torch.where(ob_yp, p, nb(p, 1, 0))
        upd = (p1 + p2 + p3 + p4 + div) * 0.25
        if w_ != 1.0:
            upd = (1.0 - w_) * p + w_ * upd
        return where0(cont, upd)

    return sweep


def _residual(p_new, p_old):
    d = (p_new - p_old).reshape(p_new.shape[0], -1)
    return torch.sqrt(torch.sum(d * d, dim=1)).max()


def solve_jacobi_fixed(flags, div, iters: int, with_residual: bool = False,
                       p0=None, damping: float = 1.0, border=None):
    """Run exactly ``iters`` sweeps from ``p0`` (default 0). With
    ``with_residual`` returns ``(p, residual of the last sweep)`` (inf
    after no sweep). ``border``: see ``_sweep_maker``."""
    sweep = _sweep_maker(flags, div, damping, border)
    p = torch.zeros_like(div) if p0 is None else p0
    res = torch.tensor(float("inf"), dtype=torch.float32, device=div.device)
    for _ in range(iters):
        p_new = sweep(p)
        if with_residual:
            res = _residual(p_new, p)
        p = p_new
    return (p, res) if with_residual else p


def solve_jacobi(flags, div, p_tol: float = 1e-5, max_iter: int = 1000):
    """Sweep from 0 until the residual drops below ``p_tol`` or
    ``max_iter`` sweeps ran. Returns (p, residual). ``p_tol <= 0`` runs
    all ``max_iter`` sweeps."""
    if p_tol <= 0.0:
        return solve_jacobi_fixed(flags, div, max_iter, with_residual=True)
    sweep = _sweep_maker(flags, div)
    p = torch.zeros_like(div)
    res = torch.tensor(float("inf"), dtype=torch.float32, device=div.device)
    it = 0
    while it < max_iter and bool(res >= p_tol):
        p_new = sweep(p)
        res = _residual(p_new, p)
        p, it = p_new, it + 1
    return p, res


def _adjoint_sweep_maker(flags, damping: float = 1.0):
    """The transpose of the sweep's linear part in p: with a = cont * g and
    c = (w * a) * 0.25,
    g'[j] = keep * a[j] + n_obst(j) * c[j]
            + (1 - obstacle[j]) * sum_d c[j - d],
    the obstacle-neighbour terms of j added first (x-1, x+1, y-1, y+1),
    then the four neighbours' c (x+1, x-1, y+1, y-1), each in its own
    float32 add. The border ring, pinned by the sweep, still receives
    gradient from the cells next to it."""
    _, h, w = flags.shape
    obstacle = flags == OBSTACLE
    cont = ~(border_mask(h, w, 1, flags.device)[None] | obstacle)
    obs = (nb(obstacle, 0, -1), nb(obstacle, 0, 1), nb(obstacle, -1, 0),
           nb(obstacle, 1, 0))
    w_ = float(damping)
    keep = 1.0 - w_

    def sweep(g):
        a = where0(cont, g)
        c = (w_ * a) * 0.25
        t = keep * a
        for ob in obs:
            t = t + where0(ob, c)
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            t = t + where0(~obstacle, nb(c, dy, dx))
        return t

    return sweep


def jacobi_adjoint_fixed(flags, g, iters: int, damping: float = 1.0):
    """``iters`` transposed sweeps of the upstream gradient ``g`` (b, h, w):
    the gradient with respect to ``p0`` of ``solve_jacobi_fixed(flags, div,
    iters, p0=p0, damping=damping)``, whatever ``div``."""
    sweep = _adjoint_sweep_maker(flags, damping)
    for _ in range(iters):
        g = sweep(g)
    return g
