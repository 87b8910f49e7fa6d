"""Run the 2-D Rayleigh-Taylor instability.

    python -m fluidnet_cxx_tpu_torch.run_rayleigh_taylor --steps 20
    python -m fluidnet_cxx_tpu_torch.run_rayleigh_taylor \\
        --sim-method multigrid

The case is ``configs/rayleighTaylor.yaml`` (``rt_case_from_conf``, which
the twin ``scripts/run_rayleigh_taylor.py`` builds its case with): a 128
wide x 512 high box, dt 0.5, buoyancy 1.0 along +y, periodic in y, with
the Jacobi projection (``--jacobi-iter`` sweeps, 200 shipped) or
multigrid (``--mg-vcycles`` V-cycles), over the tanh density interface at
mid-height with a cosine perturbation. The JAX package's
``scripts/run_rayleigh_taylor.py`` without plotting or restarts (its
twin with both is ``scripts/run_rayleigh_taylor.py`` of this package).

Prints ms/step (CUDA events on the card, the host clock on the CPU), the
mean density (conserved up to the advection's clamps), mean and max|div|
over fluid cells, the interface's distance from mid-height and whether
every field is finite. Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import json

import torch

from .config import sim_config_from_mconf
from .run_plume import resolve_device
from .scripts import finite, timed_run
from .sim.scenes import create_rayleigh_taylor_scene
from .utils.diagnostics import div_stats, mean_density, rt_interface_distance

SIM_METHODS = ("jacobi", "multigrid")
# The keys the JAX scripts/run_rayleigh_taylor.py sets where its config
# does not.
RT_DEFAULTS = {"periodic-y": True, "periodic-x": False, "dt": 0.5,
               "buoyancyScale": 1.0,
               "gravityVec": {"x": 0.0, "y": 1.0, "z": 0.0}}


def rt_case_from_conf(conf, device="cuda"):
    """(SimConfig, initial SimState) of a rayleighTaylorConfig-style dict
    (``configs/rayleighTaylor.yaml``'s keys) with ``RT_DEFAULTS`` filled
    in: ``sim_config_from_mconf`` with its ``simMethod`` (jacobi or
    multigrid), and the tanh interface of ``resX`` x ``resY`` from
    ``rho1``, ``rho2``, ``perturbThickness``, ``perturbAmplitude`` and
    ``height``."""
    conf = {**RT_DEFAULTS, **conf}
    method = conf.get("simMethod", "jacobi")
    if method not in SIM_METHODS:
        raise ValueError(f"simMethod {method!r}: the Rayleigh-Taylor case "
                         f"runs {', '.join(SIM_METHODS)}")
    cfg = dataclasses.replace(sim_config_from_mconf(conf), sim_method=method,
                              use_pallas=True)
    scene = create_rayleigh_taylor_scene(
        int(conf.get("resX", 128)), int(conf.get("resY", 512)),
        rho1=float(conf.get("rho1", -0.01)),
        rho2=float(conf.get("rho2", 0.01)),
        perturb_thickness=float(conf.get("perturbThickness", 100)),
        perturb_amplitude=float(conf.get("perturbAmplitude", 0.01)),
        height=float(conf.get("height", 0.5)), device=resolve_device(device))
    return cfg, scene


def rt_case(res_x: int = 128, res_y: int = 512, device="cuda",
            sim_method: str = "jacobi", jacobi_iter: int = 200,
            mg_vcycles: int = 2):
    """(SimConfig, initial SimState) of the Rayleigh-Taylor case."""
    cfg, state = rt_case_from_conf(
        {"resX": res_x, "resY": res_y, "simMethod": sim_method,
         "jacobiIter": jacobi_iter}, device)
    return dataclasses.replace(cfg, mg_vcycles=mg_vcycles), state


@torch.no_grad()
def run_rayleigh_taylor(res_x: int = 128, res_y: int = 512, steps: int = 20,
                        device="cuda", sim_method: str = "jacobi",
                        jacobi_iter: int = 200, mg_vcycles: int = 2):
    """Run ``steps`` steps; returns a dict with the final ``state``,
    ``ms_per_step`` and the diagnostics."""
    cfg, state = rt_case(res_x, res_y, device, sim_method, jacobi_iter,
                         mg_vcycles)
    state, run = timed_run(cfg, state, steps, max(steps, 1),
                           verbose=False)
    return {
        "state": state,
        "ms_per_step": run["ms_per_step"],
        "mean_density": float(mean_density(state.density)),
        **div_stats(state.U, state.flags),
        "interface_distance": float(rt_interface_distance(state.density,
                                                          res_y)),
        "finite": finite(state),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res-x", type=int, default=128)
    ap.add_argument("--res-y", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sim-method", default="jacobi",
                    choices=("jacobi", "multigrid"))
    ap.add_argument("--jacobi-iter", type=int, default=200)
    ap.add_argument("--mg-vcycles", type=int, default=2)
    args = ap.parse_args(argv)
    out = run_rayleigh_taylor(args.res_x, args.res_y, args.steps,
                              args.device, args.sim_method, args.jacobi_iter,
                              args.mg_vcycles)
    out.pop("state")
    print(json.dumps({"res_x": args.res_x, "res_y": args.res_y,
                      "steps": args.steps, "sim_method": args.sim_method,
                      **out}))


if __name__ == "__main__":
    main()
