"""Matplotlib field plots (the port of the JAX package's
``utils/plotting.py``): the drivers' live snapshot, the out / target /
error panels of ``scripts/print_output.py``, the density dump and the loss
curves of ``scripts/plot_loss.py``. Matplotlib is imported lazily with the
Agg backend, so a run that plots nothing never needs it; a driver that is
asked for plots where matplotlib is not installed raises before its first
step (``require_matplotlib``).
"""
import numpy as np
import torch

from ..ops.grid import get_centered
from ..ops.stencils import velocity_divergence


def require_matplotlib():
    """Raise ImportError, naming matplotlib and ``realTimePlot: false``,
    when matplotlib cannot be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the run asks for PNG snapshots (realTimePlot, true by default) "
            "but matplotlib is not installed: install it, or set "
            "'realTimePlot: false' in the YAML config") from e


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_sim_snapshot(state, filename: str, it: int = 0, crop=None):
    """5-panel live view of batch 0: density, u, v, p, divergence.
    ``crop=(y0, y1, x0, x1)`` zooms a region (e.g. the cylinder wake in a
    long channel). One copy to the host."""
    plt = _plt()
    with torch.no_grad():
        cc = get_centered(state.U)[0]
        div = velocity_divergence(state.U, state.flags)[0]
        fields = torch.stack([state.density[0], cc[0], cc[1], state.p[0],
                              div, (state.flags[0] == 2).to(torch.float32)])
        if crop is not None:
            y0, y1, x0, x1 = crop
            fields = fields[:, y0:y1, x0:x1]
        rho, u, v, p, div, mask = fields.cpu().numpy()
    mask = mask > 0.5

    fig, axes = plt.subplots(1, 5, figsize=(20, 4))
    panels = [(rho, "density"), (u, "u"), (v, "v"), (p, "pressure"),
              (div, "divergence")]
    for ax, (data, name) in zip(axes, panels):
        im = ax.imshow(np.ma.masked_where(mask, data), origin="lower",
                       cmap="jet")
        im.cmap.set_bad("gray")
        ax.set_title(f"{name} (it={it})")
        fig.colorbar(im, ax=ax, shrink=0.6)
    fig.tight_layout()
    fig.savefig(filename, dpi=100)
    plt.close(fig)


def _host(a):
    """A tensor or array as a numpy array on the host."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def plot_field(out, target, flags, filename: str, title: str = ""):
    """3-panel out / target / error image of a scalar (h, w) field,
    obstacles masked grey."""
    plt = _plt()
    out, target = _host(out), _host(target)
    mask = _host(flags) == 2
    o = np.ma.masked_where(mask, out)
    t = np.ma.masked_where(mask, target)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, data, name in zip(axes, [o, t, o - t],
                              ["output", "target", "error"]):
        im = ax.imshow(data, origin="lower", cmap="jet")
        im.cmap.set_bad("gray")
        ax.set_title(f"{name} {title}")
        fig.colorbar(im, ax=ax, shrink=0.7)
    fig.tight_layout()
    fig.savefig(filename, dpi=100)
    plt.close(fig)


def save_density_png(state, filename: str):
    """Density-only image of batch 0 (magma colour map)."""
    plt = _plt()
    plt.imsave(filename, _host(state.density[0]), origin="lower",
               cmap="magma")


def plot_loss_history(path_npy: str, filename: str, labels=None):
    """Loss curves (log scale) from the (n, 7) history array that
    ``utils/diagnostics.py::LossLogger`` writes; columns that stay 0 are
    left out."""
    plt = _plt()
    hist = np.load(path_npy)
    labels = labels or ["total", "pL2", "divL2", "pL1", "divL1", "divLT"]
    fig, ax = plt.subplots(figsize=(8, 5))
    for col, lab in enumerate(labels, start=1):
        if col < hist.shape[1] and np.any(hist[:, col] != 0):
            ax.semilogy(hist[:, 0], hist[:, col], label=lab)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    fig.tight_layout()
    fig.savefig(filename, dpi=100)
    plt.close(fig)
