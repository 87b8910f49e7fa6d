"""Buoyant-plume simulation driver, the twin of the JAX package's
``scripts/run_plume.py``:

    python -m fluidnet_cxx_tpu_torch.scripts.run_plume \\
        --simConf configs/plume.yaml [--modelDir DIR] [--outputFolder DIR]
        [--restartSim] [--simMethod X] [--resX N] [--resY N] [--maxIter N]
        [--fast] [--device cpu]

Reads a plumeConfig-style YAML (``config.py::load_yaml``), lets the flags
override it, builds the ``SimConfig`` with ``sim_config_from_mconf`` and
the inlet scene from ``injectionDensity``, ``injectionVelocity`` and
``sourceRadius``, and runs ``sim/driver.py::run_simulation``. Writes
``sim_config.yaml`` (the merged config), and at every ``statIter`` steps
``snap_<it>.png`` (``realTimePlot``, true by default), ``snap_<it>.vtk``
(``saveVTK``) and ``restart.npz``, from which ``--restartSim`` resumes.

The projections: "jacobi" (kernel F), "multigrid" (kernel H), "convnet"
(the network of ``modelDir`` on the flax path, ``models/fluidnet.py::
make_project_fn``: its convs on kernel B, its polish, the step's unfused
branch; the weights are ``<modelDir>/torch_state_dict.pt``, converted from
the orbax checkpoint) and "mg_learned" (``modelDir``'s MGCoarseNet as the
coarse solve of one V-cycle of kernel G, run as "convnet"). ``--fast``
sets ``use_pallas`` (kernels A, D and E with the first-hit trace), as in
the JAX script; without it the step runs the config's engine and trace
(see ``scripts/__init__.py``). ``--device`` is the port's own flag. The
last line is a JSON object: ms/step over the run loop (CUDA events on the
card), the output time, mean|div| and max|div| over the fluid cells
outside the inlet rows, the plume height and the last ``it``.
"""
import argparse
import dataclasses
import json
import os

from ..config import (dump_yaml, load_yaml, merge_cli_overrides,
                      sim_config_from_mconf)
from ..models.mg_coarse import load_mg_coarse, make_project_fn_mg_learned
from ..run_plume import learned_projection, quality, resolve_device
from ..sim.scenes import create_plume_scene
from ..train.checkpoint import save_sim_restart
from ..utils.plotting import plot_sim_snapshot, require_matplotlib
from ..utils.vtk_export import write_vtk
from . import RESTART_FILE, finite, initial_state, timed_run

OVERRIDES = ("simMethod", "modelDir", "outputFolder", "resX", "resY",
             "maxIter")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.scripts.run_plume",
        description=__doc__.splitlines()[0])
    ap.add_argument("--simConf", default=None, help="YAML sim config")
    ap.add_argument("--modelDir", default=None,
                    help="trained-model dir (for simMethod convnet and "
                         "mg_learned)")
    ap.add_argument("--outputFolder", default="out/plume")
    ap.add_argument("--restartSim", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="use_pallas: the advection kernels with the "
                         "first-hit trace")
    ap.add_argument("--simMethod", default=None,
                    choices=[None, "convnet", "jacobi", "multigrid",
                             "mg_learned"])
    ap.add_argument("--resX", type=int, default=None)
    ap.add_argument("--resY", type=int, default=None)
    ap.add_argument("--maxIter", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def projection(method: str, conf, cfg, dev):
    """(SimConfig, project_fn) of ``method``: None for the classical
    projections; "mg_learned" runs as "convnet"."""
    if method in ("convnet", "mg_learned") and not conf.get("modelDir"):
        raise ValueError(f"simMethod {method} needs modelDir (--modelDir "
                         "or the YAML's modelDir)")
    if method == "mg_learned":
        project = make_project_fn_mg_learned(
            load_mg_coarse(conf["modelDir"], dev))
        return dataclasses.replace(cfg, sim_method="convnet"), project
    if method == "convnet":
        return cfg, learned_projection(conf["modelDir"], None, dev,
                                       flax_path=True)
    return cfg, None


def main(argv=None):
    """Run the plume; prints and returns the result (with the final
    ``state``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    conf = (load_yaml(args.simConf) or {}) if args.simConf else {}
    conf = merge_cli_overrides(conf, {k: getattr(args, k)
                                      for k in OVERRIDES})
    res_x = int(conf.get("resX", 128))
    res_y = int(conf.get("resY", 128))
    max_iter = int(conf.get("maxIter", 20000))
    stat_iter = int(conf.get("statIter", 100))
    method = conf.get("simMethod", "jacobi")
    out = conf.get("outputFolder", "out/plume")
    save_vtk = bool(conf.get("saveVTK", False))
    save_png = bool(conf.get("realTimePlot", True))
    if save_png:
        require_matplotlib()
    os.makedirs(out, exist_ok=True)
    dump_yaml(conf, os.path.join(out, "sim_config.yaml"))

    cfg = dataclasses.replace(sim_config_from_mconf(conf), sim_method=method,
                              use_pallas=args.fast)
    cfg, project = projection(method, conf, cfg, dev)
    scene = create_plume_scene(
        res_x, res_y, density_val=float(conf.get("injectionDensity", 1.0)),
        u_scale=float(conf.get("injectionVelocity", 1.0)),
        rad=float(conf.get("sourceRadius", 0.2)), device=dev)
    state, it0 = initial_state(out, args.restartSim, scene, dev)

    def on_stats(state, it):
        if save_png:
            plot_sim_snapshot(state, os.path.join(out, f"snap_{it:06d}.png"),
                              it)
        if save_vtk:
            write_vtk(os.path.join(out, f"snap_{it:06d}.vtk"), state)
        save_sim_restart(os.path.join(out, RESTART_FILE), state, it)

    state, run = timed_run(cfg, state, max_iter, stat_iter, project,
                           on_stats, it0)
    result = {"sim": "plume", "res_x": res_x, "res_y": res_y,
              "sim_method": method, "start_it": it0, **run,
              **quality(state), "finite": finite(state)}
    print(json.dumps(result), flush=True)
    return {**result, "state": state}


if __name__ == "__main__":
    main()
