"""Run the 2-D flow past a cylinder.

    python -m fluidnet_cxx_tpu_torch.run_cylinder --steps 20
    python -m fluidnet_cxx_tpu_torch.run_cylinder --res-x 256 --res-y 64 \\
        --radius 8 --center-x 40 --steps 5 --device cpu
    python -m fluidnet_cxx_tpu_torch.run_cylinder --sim-method multigrid
    python -m fluidnet_cxx_tpu_torch.run_cylinder --sim-method convnet

The case is the JAX package's ``scripts/run_cylinder.py --fast``: the
reference's 8000 x 800 channel with a no-slip (stick) disc of radius 80.5
at x = 500 on the centre line, a left-wall inlet at speed 1, Re 100 (so
nu = |u| * 2 radius / Re = 1.61), ``cylinder_config`` (dt 0.1, MacCormack
0.6, no density field) and 34 Jacobi sweeps. A step runs the viscosity,
kernel E with the viscous field, the wall BCs with the stick disc and
kernel F. ``--sim-method multigrid`` projects with kernel H
(``cylinder_config``'s 2 warm V-cycles; the JAX step runs its XLA
``solve_mg`` at this size, where its TPU kernel does not fit), and
``--sim-method convnet`` with the learned projection of ``--model-dir``
(default ``trained_models/PUNetD2_128``, its trained weights, or seed
weights with ``--weight-seed N``; kernels B and C; ``run_plume.
learned_projection`` picks the fused or the flax path from the
checkpoint's model, as for the plume: ``--model-dir
trained_models/DataTrain_128`` runs the FluidNetTower, every conv on
kernel B), which the stick walls send through the step's unfused branch,
as in the JAX ``scripts/run_cylinder.py``. The run loop is
``sim/driver.py::run_simulation`` with its CFL guard, without plotting or
restarts (its twin with both is ``scripts/run_cylinder.py`` of this
package).

Prints ms/step (CUDA events on the card, the host clock on the CPU, over
the whole run loop), mean|div| and max|div| over fluid cells after the
last projection, max|U|, the largest back-trace displacement the CFL guard
saw, whether every field is finite and, under convnet, the net and its
weights (``"model"``, ``"weights"``). Runs on the card unless
``--device cpu`` is given.
"""
import argparse
import json

import torch

from .config import load_model_config
from .ops.window import max_displacement
from .run_plume import (MODEL_DIR, learned_projection, resolve_device,
                        weights_label)
from .scripts import finite, timed_run
from .sim.scenes import create_cylinder_scene, cylinder_config
from .utils.diagnostics import div_stats

SIM_METHODS = ("jacobi", "multigrid", "convnet")


def cylinder_case(res_x: int = 8000, res_y: int = 800, device="cuda",
                  reynolds: float = 100.0, radius: float = 80.5,
                  center_x: float = 500.0, inlet_vel: float = 1.0,
                  jacobi_iter: int = 34, sim_method: str = "jacobi",
                  model_dir=MODEL_DIR, weight_seed=None,
                  flax_path: bool = False):
    """(SimConfig, initial SimState, project_fn) of the cylinder case;
    project_fn is the learned projection of ``model_dir`` (its trained
    weights, or seed weights from ``weight_seed``; on the flax path under
    ``flax_path``, see ``run_plume.learned_projection``) for "convnet",
    else None."""
    if sim_method not in SIM_METHODS:
        raise ValueError(f"sim_method {sim_method!r}: the cylinder runs "
                         f"{', '.join(SIM_METHODS)}")
    dev = resolve_device(device)
    state, viscosity = create_cylinder_scene(
        res_x, res_y, center_x=center_x, radius=radius, inlet_vel=inlet_vel,
        reynolds=reynolds, device=dev)
    cfg = cylinder_config(viscosity, jacobi_iter=jacobi_iter,
                          use_pallas=True, sim_method=sim_method)
    project = None
    if sim_method == "convnet":
        project = learned_projection(model_dir, weight_seed, dev,
                                     flax_path)
    return cfg, state, project


@torch.no_grad()
def run_cylinder(res_x: int = 8000, res_y: int = 800, steps: int = 20,
                 device="cuda", reynolds: float = 100.0,
                 radius: float = 80.5, center_x: float = 500.0,
                 inlet_vel: float = 1.0, jacobi_iter: int = 34,
                 sim_method: str = "jacobi", stat_iter: int = 50,
                 verbose: bool = False, model_dir=MODEL_DIR,
                 weight_seed=None):
    """Run ``steps`` steps; returns a dict with the final ``state``,
    ``ms_per_step`` and the diagnostics."""
    cfg, state, project = cylinder_case(
        res_x, res_y, device, reynolds, radius, center_x, inlet_vel,
        jacobi_iter, sim_method, model_dir, weight_seed)
    disp = []

    def on_stats(st, it):
        disp.append(float(max_displacement(st.U, cfg.dt)))

    state, run = timed_run(cfg, state, steps, stat_iter, project, on_stats,
                           verbose=verbose)
    net = {}
    if project is not None:
        net = {"model": load_model_config(str(model_dir)).model,
               "weights": weights_label(weight_seed)}
    return {
        "state": state,
        "ms_per_step": run["ms_per_step"],
        **div_stats(state.U, state.flags),
        "max_U": float(state.U.abs().max()),
        "max_disp": max(disp, default=0.0),
        "finite": finite(state),
        **net,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res-x", type=int, default=8000)
    ap.add_argument("--res-y", type=int, default=800)
    ap.add_argument("--re", type=float, default=100.0)
    ap.add_argument("--radius", type=float, default=80.5)
    ap.add_argument("--center-x", type=float, default=500.0)
    ap.add_argument("--inlet-vel", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--stat-iter", type=int, default=50)
    ap.add_argument("--jacobi-iter", type=int, default=34)
    ap.add_argument("--sim-method", default="jacobi", choices=SIM_METHODS)
    ap.add_argument("--model-dir", default=str(MODEL_DIR),
                    help="checkpoint of --sim-method convnet")
    ap.add_argument("--weight-seed", type=int, default=None,
                    help="flax-initialised weights from this seed in "
                         "place of the trained ones")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_cylinder(args.res_x, args.res_y, args.steps, args.device,
                       args.re, args.radius, args.center_x, args.inlet_vel,
                       args.jacobi_iter, args.sim_method, args.stat_iter,
                       verbose=True, model_dir=args.model_dir,
                       weight_seed=args.weight_seed)
    out.pop("state")
    print(json.dumps({"res_x": args.res_x, "res_y": args.res_y,
                      "steps": args.steps, "sim_method": args.sim_method,
                      **out}))


if __name__ == "__main__":
    main()
