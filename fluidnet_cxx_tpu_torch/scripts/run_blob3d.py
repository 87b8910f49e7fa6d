"""The 3-D buoyant-blob demo, the twin of the JAX package's
``scripts/run_blob3d.py``:

    python -m fluidnet_cxx_tpu_torch.scripts.run_blob3d [--res 48]
        [--maxIter 200] [--statIter 25] [--jacobiIter 60] [--dt 0.25]
        [--buoyancy 0.5] [--outputFolder out/blob3d] [--device cpu]

A hot blob (density 1 in a sphere of radius max(res/8, 2) centred at
(res/2, res/5, res/2)) rises in a closed res^3 box under JAX's config:
``plume_config(dt, jacobi_iter, buoyancy_scale, gravity_vec=(0, -1, 0),
max_disp=2)``, so ``use_pallas`` off, the window engine and the march
trace. The step (sim/step3d.py) runs the density on the torch engine
(the march with the window lookup), the velocity on kernel M and the
Jacobi solve on kernel I. Steps run in chunks of ``statIter``, as JAX's
scan does (the last chunk may pass ``maxIter``); after each it prints
JAX's line ``it=<it>: mass=<sum> y-com=<centre of mass in y>`` and, where
matplotlib is installed, writes the two mid-plane slices
``slice_<it>.png`` (nothing otherwise, as JAX's script). The last line is
a JSON object: ms/step over the run (CUDA events on the card), the last
mass and y-com, max|div| over the grid and whether the fields are finite.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from ..ops.ops3d import velocity_divergence3
from ..run_plume import resolve_device
from ..sim.scenes import plume_config
from ..sim.step3d import create_state3, simulate_step3
from . import finite


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.scripts.run_blob3d",
        description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--maxIter", type=int, default=200)
    ap.add_argument("--statIter", type=int, default=25)
    ap.add_argument("--jacobiIter", type=int, default=60)
    ap.add_argument("--dt", type=float, default=0.25)
    ap.add_argument("--buoyancy", type=float, default=0.5)
    ap.add_argument("--outputFolder", default="out/blob3d")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def blob_state(n: int, device):
    """The empty n^3 box with the density blob."""
    rho = np.zeros((1, n, n, n), np.float32)
    c, r = n // 2, max(n // 8, 2)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    blob = (xx - c) ** 2 + (yy - n // 5) ** 2 + (zz - c) ** 2 <= r * r
    rho[0][blob] = 1.0
    return create_state3(1, n, n, n, device)._replace(
        density=torch.from_numpy(rho).to(device))


def blob_config(args):
    return plume_config(dt=args.dt, jacobi_iter=args.jacobiIter,
                        buoyancy_scale=args.buoyancy,
                        gravity_vec=(0.0, -1.0, 0.0), max_disp=2)


def save_slices(r, c, it, out):
    """The z and x mid-plane slices of density ``r``, where matplotlib is
    installed; any failure is ignored, as in JAX's script."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(9, 4))
        axes[0].imshow(r[c], origin="lower", cmap="magma")
        axes[0].set_title(f"density z-midplane (it={it})")
        axes[1].imshow(r[:, :, c].T, origin="lower", cmap="magma")
        axes[1].set_title("density x-midplane")
        fig.tight_layout()
        fig.savefig(os.path.join(out, f"slice_{it:05d}.png"), dpi=100)
        plt.close(fig)
    except Exception:  # noqa: BLE001 — the plot is optional, as in JAX's
        pass


@torch.no_grad()
def main(argv=None):
    """Run the blob; prints and returns the result (with the final
    ``state`` and the per-chunk ``stats``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    n = args.res
    out = args.outputFolder
    os.makedirs(out, exist_ok=True)
    state = blob_state(n, dev)
    cfg = blob_config(args)
    c = n // 2
    on_card = dev.type == "cuda"
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    t0 = time.perf_counter()
    stats = []
    it = 0
    while it < args.maxIter:
        for _ in range(args.statIter):
            state = simulate_step3(cfg, state)
        it += args.statIter
        r = state.density[0].cpu().numpy()
        com = (r.sum(axis=(0, 2)) * np.arange(n)).sum() / max(r.sum(), 1e-9)
        print(f"it={it}: mass={r.sum():8.1f} y-com={com:5.1f}", flush=True)
        stats.append((it, float(r.sum()), float(com)))
        save_slices(r, c, it, out)
    if on_card:
        end.record()
        end.synchronize()
        elapsed_ms = start.elapsed_time(end)
    else:
        elapsed_ms = 1e3 * (time.perf_counter() - t0)
    result = {"sim": "blob3d", "res": n, "it": it, "steps": it,
              "ms_per_step": elapsed_ms / it if it else None,
              "mass": stats[-1][1] if stats else None,
              "y_com": stats[-1][2] if stats else None,
              "max_div": float(velocity_divergence3(state.U, state.flags)
                               .abs().max()),
              "finite": finite(state)}
    print(json.dumps(result), flush=True)
    return {**result, "state": state, "stats": stats}


if __name__ == "__main__":
    main()
