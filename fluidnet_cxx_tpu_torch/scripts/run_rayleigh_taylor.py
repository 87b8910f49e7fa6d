"""Rayleigh-Taylor instability driver, the twin of the JAX package's
``scripts/run_rayleigh_taylor.py``:

    python -m fluidnet_cxx_tpu_torch.scripts.run_rayleigh_taylor \\
        --simConf configs/rayleighTaylor.yaml [--outputFolder DIR]
        [--restartSim] [--maxIter N] [--fast] [--device cpu]

Reads a rayleighTaylorConfig-style YAML and builds the case from it with
``run_rayleigh_taylor.py::rt_case_from_conf``: the RT defaults the JAX
script sets (``periodic-y`` true, ``periodic-x`` false, ``dt`` 0.5,
``buoyancyScale`` 1, ``gravityVec`` +y) filled in, the tanh interface from
``rho1``, ``rho2``, ``perturbThickness``, ``perturbAmplitude`` and
``height``, and the YAML's ``simMethod``: "jacobi" (kernel F) or
"multigrid" (kernel G, periodic in y); ``use_pallas`` only under
``--fast``, as in the JAX script. At every ``statIter`` steps it
appends (time, interface distance) to ``distance.npy`` and (time, mean
density) to ``avg_density.npy``, writes ``restart.npz`` (``--restartSim``
resumes from it; the two histories start afresh, as in JAX) and, under
``realTimePlot`` (true by default), ``snap_<it>.png``; the JAX script
plots unconditionally (see ``scripts/__init__.py``). The last line is a
JSON object: ms/step over the run loop, the output time, mean|div| and
max|div| over fluid cells, the interface distance, the mean density and
the last ``it``.
"""
import argparse
import dataclasses
import json
import os

import numpy as np

from ..config import load_yaml
from ..run_plume import resolve_device
from ..run_rayleigh_taylor import rt_case_from_conf
from ..train.checkpoint import save_sim_restart
from ..utils.diagnostics import (div_stats, mean_density,
                                 rt_interface_distance)
from ..utils.plotting import plot_sim_snapshot, require_matplotlib
from . import RESTART_FILE, finite, initial_state, timed_run


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.scripts.run_rayleigh_taylor",
        description=__doc__.splitlines()[0])
    ap.add_argument("--simConf", default=None)
    ap.add_argument("--outputFolder", default="out/rt")
    ap.add_argument("--restartSim", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="use_pallas: the advection kernels with the "
                         "first-hit trace")
    ap.add_argument("--maxIter", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the instability; prints and returns the result (with the final
    ``state``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    conf = (load_yaml(args.simConf) or {}) if args.simConf else {}
    if args.maxIter is not None:
        conf["maxIter"] = args.maxIter
    res_x = int(conf.get("resX", 128))
    res_y = int(conf.get("resY", 512))
    max_iter = int(conf.get("maxIter", 20000))
    stat_iter = int(conf.get("statIter", 10))
    out = args.outputFolder
    cfg, scene = rt_case_from_conf(conf, dev)
    cfg = dataclasses.replace(cfg, use_pallas=args.fast)
    save_png = bool(conf.get("realTimePlot", True))
    if save_png:
        require_matplotlib()
    os.makedirs(out, exist_ok=True)
    state, it0 = initial_state(out, args.restartSim, scene, dev)
    dist_hist, rho_hist = [], []

    def on_stats(state, it):
        d = float(rt_interface_distance(state.density, res_y))
        m = float(mean_density(state.density))
        dist_hist.append([it * cfg.dt, d])
        rho_hist.append([it * cfg.dt, m])
        np.save(os.path.join(out, "distance.npy"), np.array(dist_hist))
        np.save(os.path.join(out, "avg_density.npy"), np.array(rho_hist))
        if save_png:
            plot_sim_snapshot(state, os.path.join(out, f"snap_{it:06d}.png"),
                              it)
        save_sim_restart(os.path.join(out, RESTART_FILE), state, it)
        print(f"  interface distance={d:.3f}  mean rho={m:.6f}", flush=True)

    state, run = timed_run(cfg, state, max_iter, stat_iter, None, on_stats,
                           it0)
    result = {"sim": "rayleigh_taylor", "res_x": res_x, "res_y": res_y,
              "sim_method": cfg.sim_method, "start_it": it0, **run,
              **div_stats(state.U, state.flags),
              "interface_distance": float(rt_interface_distance(
                  state.density, res_y)),
              "mean_density": float(mean_density(state.density)),
              "finite": finite(state)}
    print(json.dumps(result), flush=True)
    return {**result, "state": state}


if __name__ == "__main__":
    main()
