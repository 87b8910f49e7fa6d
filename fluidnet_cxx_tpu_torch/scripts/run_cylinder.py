"""Flow-past-cylinder driver, the twin of the JAX package's
``scripts/run_cylinder.py``:

    python -m fluidnet_cxx_tpu_torch.scripts.run_cylinder [--resX 8000]
        [--resY 800] [--re 100] [--radius 80.5] [--centerX 500]
        [--inletVel 1] [--maxIter 5000] [--statIter 50] [--jacobiIter 34]
        [--outputFolder DIR] [--restartSim] [--simMethod X] [--modelDir DIR]
        [--realTimePlot false] [--fast] [--device cpu]

A no-slip (stick) disc in a channel with a left-wall inlet, viscosity
from Re (nu = |u| * 2 radius / Re), ``cylinder_config`` with
``--jacobiIter`` sweeps: the case of ``run_cylinder.py::cylinder_case``,
with ``use_pallas`` only under ``--fast``, as in the JAX script.
``--simMethod`` jacobi (kernel F), multigrid (kernel H) or convnet (the
network of ``--modelDir``, default ``trained_models/PUNetD2_128``, on the
flax path ``models/fluidnet.py::make_project_fn``, as the JAX script runs
its best checkpoint; the weights are ``<modelDir>/torch_state_dict.pt``,
converted from that checkpoint). At every ``--statIter`` steps it writes
``restart.npz`` (``--restartSim`` resumes from it) and, under
``--realTimePlot`` (true by default), ``snap_<it>.png`` and, in a channel
at least four times as long as it is high, ``wake_<it>.png`` cropped to
the wake. The JAX script plots unconditionally (see
``scripts/__init__.py``); this twin reads no YAML, so ``--realTimePlot``
(a YAML boolean: true/false, yes/no, on/off) is how plots are turned off.
The last line is a JSON object: ms/step over the run loop, the output
time, mean|div| and max|div| over fluid cells, max|U| and the last
``it``.
"""
import argparse
import dataclasses
import json
import os

from ..config import resolve_scalar
from ..run_cylinder import cylinder_case
from ..run_plume import MODEL_DIR, resolve_device
from ..train.checkpoint import save_sim_restart
from ..utils.diagnostics import div_stats
from ..utils.plotting import plot_sim_snapshot, require_matplotlib
from . import RESTART_FILE, finite, initial_state, timed_run


def yaml_bool(text: str) -> bool:
    """A flag's value read as a YAML boolean (true/false, yes/no, on/off)."""
    v = resolve_scalar(text)
    if not isinstance(v, bool):
        raise ValueError(f"{text!r} is not a YAML boolean")
    return v


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.scripts.run_cylinder",
        description=__doc__.splitlines()[0])
    ap.add_argument("--resX", type=int, default=8000)
    ap.add_argument("--resY", type=int, default=800)
    ap.add_argument("--re", type=float, default=100.0)
    ap.add_argument("--radius", type=float, default=80.5)
    ap.add_argument("--centerX", type=float, default=500.0)
    ap.add_argument("--inletVel", type=float, default=1.0)
    ap.add_argument("--maxIter", type=int, default=5000)
    ap.add_argument("--statIter", type=int, default=50)
    ap.add_argument("--jacobiIter", type=int, default=34)
    ap.add_argument("--outputFolder", default="out/cylinder")
    ap.add_argument("--restartSim", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="use_pallas: the advection kernels with the "
                         "first-hit trace")
    ap.add_argument("--simMethod", default="jacobi",
                    choices=["jacobi", "convnet", "multigrid"])
    ap.add_argument("--modelDir", default=str(MODEL_DIR),
                    help="checkpoint for --simMethod convnet")
    ap.add_argument("--realTimePlot", type=yaml_bool, default=True,
                    help="write the PNG snapshots (true/false)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the cylinder; prints and returns the result (with the final
    ``state``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.realTimePlot:
        require_matplotlib()
    out = args.outputFolder
    os.makedirs(out, exist_ok=True)
    cfg, scene, project = cylinder_case(
        args.resX, args.resY, dev, args.re, args.radius, args.centerX,
        args.inletVel, args.jacobiIter, args.simMethod, args.modelDir,
        flax_path=True)
    cfg = dataclasses.replace(cfg, use_pallas=args.fast)
    print(f"cylinder {args.resX}x{args.resY}, Re={args.re}, "
          f"nu={cfg.viscosity:.3f}", flush=True)
    state, it0 = initial_state(out, args.restartSim, scene, dev)

    def on_stats(state, it):
        if args.realTimePlot:
            plot_sim_snapshot(state, os.path.join(out, f"snap_{it:06d}.png"),
                              it)
            if args.resX >= 4 * args.resY:
                x0 = max(int(args.centerX - 3 * args.radius), 0)
                x1 = min(int(args.centerX + 20 * args.radius), args.resX)
                plot_sim_snapshot(
                    state, os.path.join(out, f"wake_{it:06d}.png"), it,
                    crop=(0, args.resY, x0, x1))
        save_sim_restart(os.path.join(out, RESTART_FILE), state, it)

    state, run = timed_run(cfg, state, args.maxIter, args.statIter, project,
                           on_stats, it0)
    result = {"sim": "cylinder", "res_x": args.resX, "res_y": args.resY,
              "sim_method": args.simMethod, "start_it": it0, **run,
              **div_stats(state.U, state.flags),
              "max_U": float(state.U.abs().max()), "finite": finite(state)}
    print(json.dumps(result), flush=True)
    return {**result, "state": state}


if __name__ == "__main__":
    main()
