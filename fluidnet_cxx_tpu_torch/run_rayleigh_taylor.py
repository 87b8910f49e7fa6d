"""Run the 2-D Rayleigh-Taylor instability.

    python -m fluidnet_cxx_tpu_torch.run_rayleigh_taylor --steps 20
    python -m fluidnet_cxx_tpu_torch.run_rayleigh_taylor \\
        --sim-method multigrid

The case is ``configs/rayleighTaylor.yaml``: a 128 wide x 512 high box,
``rayleigh_taylor_config`` (dt 0.5, buoyancy 1.0 along +y, periodic in y)
with the Jacobi projection (``--jacobi-iter`` sweeps, 200 shipped) or
multigrid (``--mg-vcycles`` V-cycles), over the tanh density interface at
mid-height with a cosine perturbation. The JAX package's
``scripts/run_rayleigh_taylor.py`` without plotting or restarts.

Prints ms/step (CUDA events on the card, the host clock on the CPU), the
mean density (conserved up to the advection's clamps), max|div| over
fluid cells, the interface's distance from mid-height and whether every
field is finite. Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import json
import time

import torch

from .celltype import FLUID
from .ops.stencils import velocity_divergence
from .run_plume import resolve_device
from .sim.scenes import create_rayleigh_taylor_scene, rayleigh_taylor_config
from .sim.step import simulate_step


def rt_interface_distance(density, res_y: int) -> float:
    """Where the centre column's density first crosses zero upward
    (linear interpolation), relative to mid-height."""
    col = density[0][:, density.shape[-1] // 2]
    crossing = (col[:-1] < 0) & (col[1:] > 0)
    idx = int(torch.argmax(crossing.to(torch.int32)))
    r1, r2 = col[idx], col[idx + 1]
    m = r1 - r2
    frac = float(r1 / m) if float(m.abs()) > 1e-12 else 0.5
    return idx + frac - res_y // 2


def mean_density(density) -> float:
    return float(density.mean())


def rt_case(res_x: int = 128, res_y: int = 512, device="cuda",
            sim_method: str = "jacobi", jacobi_iter: int = 200,
            mg_vcycles: int = 2):
    """(SimConfig, initial SimState) of the Rayleigh-Taylor case."""
    dev = resolve_device(device)
    cfg = rayleigh_taylor_config(sim_method=sim_method, use_pallas=True,
                                 jacobi_iter=jacobi_iter,
                                 mg_vcycles=mg_vcycles)
    return cfg, create_rayleigh_taylor_scene(res_x, res_y, device=dev)


@torch.no_grad()
def run_rayleigh_taylor(res_x: int = 128, res_y: int = 512, steps: int = 20,
                        device="cuda", sim_method: str = "jacobi",
                        jacobi_iter: int = 200, mg_vcycles: int = 2):
    """Run ``steps`` steps; returns a dict with the final ``state``,
    ``ms_per_step`` and the diagnostics."""
    cfg, state = rt_case(res_x, res_y, device, sim_method, jacobi_iter,
                         mg_vcycles)
    on_card = state.U.device.type == "cuda"
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = simulate_step(cfg, state)
    if on_card:
        end.record()
        end.synchronize()
        elapsed_ms = start.elapsed_time(end)
    else:
        elapsed_ms = 1e3 * (time.perf_counter() - t0)
    fluid = state.flags == FLUID
    div = velocity_divergence(state.U, state.flags).abs() * fluid
    return {
        "state": state,
        "ms_per_step": elapsed_ms / max(steps, 1),
        "mean_density": mean_density(state.density),
        "max_div": float(div.max()),
        "interface_distance": rt_interface_distance(state.density, res_y),
        "finite": all(bool(torch.isfinite(t).all())
                      for t in (state.U, state.p, state.density)),
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
