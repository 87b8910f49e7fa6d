"""Fixed-count Jacobi pressure sweeps (twin of the JAX package's
``ops/jacobi.py::solve_jacobi_fixed``): pressure pinned to 0 on the border
ring and in obstacles, obstacle neighbours replaced by the centre value
(homogeneous Neumann), optional warm start ``p0`` and weighted-Jacobi
``damping``."""
import torch

from ..celltype import OBSTACLE
from .common import border_mask, nb, where0


def _sweep_maker(flags, div, damping: float = 1.0):
    _, h, w = flags.shape
    obstacle = flags == OBSTACLE
    cont = ~(border_mask(h, w, 1, div.device)[None] | obstacle)
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


def solve_jacobi_fixed(flags, div, iters: int, p0=None,
                       damping: float = 1.0):
    """Run exactly ``iters`` sweeps from ``p0`` (default 0)."""
    sweep = _sweep_maker(flags, div, damping)
    p = torch.zeros_like(div) if p0 is None else p0
    for _ in range(iters):
        p = sweep(p)
    return p
