"""One-time dataset preprocessing, the twin of the JAX package's
``scripts/preprocess_data.py``: Manta ``.bin`` scene dumps to the
trainer's ``.npz`` frames.

    python -m fluidnet_cxx_tpu_torch.scripts.preprocess_data \\
        --dataDir D --dataset NAME --out OUT [--saveDt 4]
        [--stepsPerScene 64] [--workers 4]

For each of ``<dataDir>/<dataset>/{tr,te}`` that exists it runs
``data/dataset.py::preprocess_manta_scenes``: every ``saveDt``-th frame
of each scene, ``NNNNNN.bin`` (the target) and ``NNNNNN_divergent.bin``
(the input), becomes ``<out>/<prefix>/<scene>/NNNNNN.npz``, and
``<out>/preprocessed_<dataset>_<prefix>.json`` describes them. It reads
and writes files only (numpy, ``--workers`` threads): no device runs.
"""
import argparse
import os

from ..data.dataset import preprocess_manta_scenes


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.scripts.preprocess_data",
        description=__doc__.splitlines()[0])
    ap.add_argument("--dataDir", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--saveDt", type=int, default=4)
    ap.add_argument("--stepsPerScene", type=int, default=64)
    ap.add_argument("--workers", type=int, default=4)
    return ap.parse_args(argv)


def main(argv=None):
    """Preprocess every split present; returns the prefixes done."""
    args = parse_args(argv)
    done = []
    for prefix in ("tr", "te"):
        if os.path.isdir(os.path.join(args.dataDir, args.dataset, prefix)):
            print(f"preprocessing {prefix}...")
            preprocess_manta_scenes(
                args.dataDir, args.dataset, prefix, args.out,
                save_dt=args.saveDt, steps_per_scene=args.stepsPerScene,
                n_workers=args.workers)
            done.append(prefix)
    print("done")
    return done


if __name__ == "__main__":
    main()
