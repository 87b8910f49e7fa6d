"""Physics and training diagnostics (the port of the JAX package's
``utils/diagnostics.py``): the Rayleigh-Taylor interface and mean density,
``divergence_norms``, the drivers' ``div_stats``, ``StepTimer``,
``profile_trace`` and ``LossLogger``.
"""
import contextlib
import os
import time

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


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree if x is not None for t in _tensors(x)]
    return []


class StepTimer:
    """Steps a second since ``start``; ``rate(pending)`` first waits for
    the devices that ``pending`` (a tensor, or a NamedTuple or list of
    them) lives on, since CUDA launches return before the work is done."""

    def __init__(self):
        self.t0 = None
        self.steps = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n: int = 1):
        self.steps += n

    def rate(self, pending=None):
        for dev in {t.device for t in _tensors(pending)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self.t0
        return self.steps / dt if dt > 0 else float("inf")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` over the block (the CPU, and CUDA where there is
    a card); writes ``<logdir>/trace.json``, a Chrome trace (chrome://
    tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
