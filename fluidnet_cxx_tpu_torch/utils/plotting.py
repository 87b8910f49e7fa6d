"""Matplotlib field plots (the port of the JAX package's
``utils/plotting.py``): the drivers' live snapshot. Matplotlib is
imported lazily with the Agg backend, so a run that plots nothing never
needs it; a driver that is asked for plots where matplotlib is not
installed raises before its first step (``require_matplotlib``).
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
