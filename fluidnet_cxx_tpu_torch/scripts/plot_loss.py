"""Plot the training and validation loss curves of a model folder, the
twin of the JAX package's ``scripts/plot_loss.py``:

    python -m fluidnet_cxx_tpu_torch.scripts.plot_loss --modelDir DIR

For each of ``train_loss.npy`` and ``val_loss.npy`` (the (n, 7) histories
that ``python -m fluidnet_cxx_tpu_torch.train`` writes) that exists,
writes ``train_loss.png`` / ``val_loss.png`` beside it with
``utils/plotting.py::plot_loss_history``. Runs on the host and needs
matplotlib; takes no ``--device``.
"""
import argparse
import os

from ..utils.plotting import plot_loss_history, require_matplotlib


def main(argv=None):
    """Write the plots; returns the paths written."""
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.scripts.plot_loss",
        description=__doc__.splitlines()[0])
    ap.add_argument("--modelDir", required=True)
    args = ap.parse_args(argv)
    require_matplotlib()
    written = []
    for split in ("train", "val"):
        npy = os.path.join(args.modelDir, f"{split}_loss.npy")
        if os.path.isfile(npy):
            png = os.path.join(args.modelDir, f"{split}_loss.png")
            plot_loss_history(npy, png)
            print("wrote", png, flush=True)
            written.append(png)
    return written


if __name__ == "__main__":
    main()
