"""Physics and training diagnostics (the port of the JAX package's
``utils/diagnostics.py``): the Rayleigh-Taylor interface and mean density,
``divergence_norms``, the drivers' ``div_stats`` and ``LossLogger``.
"""
import os

import numpy as np
import torch

from ..celltype import FLUID
from ..ops.stencils import velocity_divergence


def rt_interface_distance(density, res_y: int):
    """Rayleigh-Taylor interface position: where the centre column's
    density first crosses zero upward (linear interpolation), relative to
    mid-height, as a 0-d tensor (no host sync)."""
    rho = density[0]
    col = rho[:, rho.shape[1] // 2]
    crossing = (col[:-1] < 0) & (col[1:] > 0)
    idx = torch.argmax(crossing.to(torch.int32))
    r1, r2 = col[idx], col[idx + 1]
    m = r1 - r2
    frac = torch.where(m.abs() > 1e-12, r1 / m, torch.full_like(m, 0.5))
    return (idx.to(torch.float32) + frac) - res_y // 2


def mean_density(density):
    return torch.mean(density)


def divergence_norms(U, flags):
    """{"div_max": max|div|, "div_l2": sqrt(mean div^2)} as 0-d tensors."""
    div = velocity_divergence(U, flags)
    return {"div_max": torch.max(torch.abs(div)),
            "div_l2": torch.sqrt(torch.mean(div ** 2))}


def div_stats(U, flags):
    """{"mean_div", "max_div"}: mean and max |div U| over the fluid cells,
    as floats."""
    fluid = flags == FLUID
    div = velocity_divergence(U, flags).abs() * fluid
    return {"mean_div": float(div.sum() / fluid.sum()),
            "max_div": float(div.max())}


class LossLogger:
    """Per-epoch loss rows kept in an .npy file in the reference's layout
    (7 float64 columns: epoch, total, pL2, divL2, pL1, divL1, divLT), the
    file the JAX package writes and ``scripts/plot_loss.py`` reads. An
    existing file's rows are kept and appended to."""

    def __init__(self, path: str):
        self.path = path
        self.rows = list(np.load(path)) if os.path.isfile(path) else []

    def append(self, epoch: int, terms):
        self.rows.append(np.array(
            [epoch, float(terms.total), float(terms.p_l2),
             float(terms.div_l2), float(terms.p_l1), float(terms.div_l1),
             float(terms.div_lt)], np.float64))

    def save(self):
        np.save(self.path, np.stack(self.rows))
