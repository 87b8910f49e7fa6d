"""Run a trained model over the test split and plot out / target / error
fields, the twin of the JAX package's ``scripts/print_output.py``:

    python -m fluidnet_cxx_tpu_torch.scripts.print_output --modelDir DIR \\
        --dataDir DIR [--n 4] [--out DIR] [--device cpu]

Loads ``<modelDir>/model_config.json`` and the ``last_epoch/`` checkpoint
that ``python -m fluidnet_cxx_tpu_torch.train`` writes, projects the
first ``--n`` frames of ``<dataDir>/te`` (in order) with the model and
writes ``p_<i>.png``, ``u_<i>.png`` and ``div_<i>.png`` with
``utils/plotting.py::plot_field`` under ``--out`` (default
``<modelDir>/eval_plots``). Prints the mean |div| of the model's output
and of the target. Needs matplotlib.
"""
import argparse
import os

import numpy as np
import torch

from ..config import TrainConfig, load_model_config
from ..data.dataset import FluidDataset, sample_to_batch
from ..models.fluidnet import FluidNet
from ..ops.stencils import velocity_divergence
from ..run_plume import resolve_device
from ..train.checkpoint import load_train_checkpoint
from ..train.trainer import init_train_state
from ..utils.plotting import plot_field, require_matplotlib


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.scripts.print_output",
        description=__doc__.splitlines()[0])
    ap.add_argument("--modelDir", required=True)
    ap.add_argument("--dataDir", required=True)
    ap.add_argument("--n", type=int, default=4, help="frames to plot")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Plot the frames; returns {"p", "U", "div", "div_target"} of the
    batch (host arrays) and the plots' folder."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    require_matplotlib()
    out = args.out or os.path.join(args.modelDir, "eval_plots")
    os.makedirs(out, exist_ok=True)

    ds = FluidDataset(args.dataDir, "te")
    model = FluidNet(load_model_config(args.modelDir)).to(dev)
    ts = init_train_state(model, TrainConfig())
    ts, epoch, best = load_train_checkpoint(args.modelDir, ts)
    print(f"loaded checkpoint @ epoch {epoch} (best val {best:.5f})",
          flush=True)
    batch = sample_to_batch(next(ds.batches(args.n, shuffle=False)), dev)
    with torch.no_grad():
        p_out, U_out = model(batch.p_div, batch.U_div, batch.flags,
                             batch.density_div)
        div_out = velocity_divergence(U_out, batch.flags)
        div_tgt = velocity_divergence(batch.U_target, batch.flags)
    host = {k: v.cpu().numpy() for k, v in dict(
        p=p_out, U=U_out, div=div_out, div_target=div_tgt,
        flags=batch.flags, p_target=batch.p_target,
        U_target=batch.U_target).items()}
    for i in range(args.n):
        f = host["flags"][i]
        plot_field(host["p"][i], host["p_target"][i], f,
                   os.path.join(out, f"p_{i:03d}.png"), "pressure")
        plot_field(host["U"][i, 0], host["U_target"][i, 0], f,
                   os.path.join(out, f"u_{i:03d}.png"), "u")
        plot_field(host["div"][i], host["div_target"][i], f,
                   os.path.join(out, f"div_{i:03d}.png"), "divergence")
    print(f"mean|div| model={np.abs(host['div']).mean():.5f} "
          f"target={np.abs(host['div_target']).mean():.5f}; plots in {out}",
          flush=True)
    return {**host, "out": out}


if __name__ == "__main__":
    main()
