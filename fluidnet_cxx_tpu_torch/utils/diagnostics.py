"""Training diagnostics (the port of the JAX package's
``utils/diagnostics.py``: ``LossLogger`` and ``divergence_norms``; its RT
interface and density helpers live in ``run_rayleigh_taylor.py``).
"""
import os

import numpy as np
import torch

from ..ops.stencils import velocity_divergence


def divergence_norms(U, flags):
    """{"div_max": max|div|, "div_l2": sqrt(mean div^2)} as 0-d tensors."""
    div = velocity_divergence(U, flags)
    return {"div_max": torch.max(torch.abs(div)),
            "div_l2": torch.sqrt(torch.mean(div ** 2))}


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
