"""Run the 3-D buoyant plume under the classical Jacobi projection.

    python -m fluidnet_cxx_tpu_torch.run_plume3d --res 128 --steps 20
    python -m fluidnet_cxx_tpu_torch.run_plume3d --fuse-advection \\
        --line-trace
    python -m fluidnet_cxx_tpu_torch.run_plume3d --res 32 --steps 5 \\
        --device cpu

The case is the JAX package's ``scripts/bench3d.py`` classical row at its
defaults: the res^3 plume ``create_plume_scene3(density_val=0.1,
u_scale=0.6*res/64)`` with ``plume_config(dt=0.25, jacobi_iter=60,
buoyancy_scale=0.5, gravity_vec=(0, -1, 0), max_disp=2,
advection_impl="window", use_pallas=True)``. Without flags a step runs
kernels K (density), M (velocity) and I (60 Jacobi sweeps);
``--fuse-advection`` runs kernel L in place of K and M, ``--line-trace``
the first-hit obstacle trace in the density's advection (bench3d's
``--fuseAdvection`` and ``--lineTrace``).

Prints ms/step (CUDA events on the card, the host clock on the CPU, over
all but the last step), the launches of each kernel per step and the
final state's quality: max|div| over interior cells (what bench3d
prints), mean|div| over fluid cells, the density sum and max|U|. Runs on
the card unless ``--device cpu`` is given.
"""
import argparse
import json
import time

import torch

from .celltype import FLUID
from .ops.kernels import advect3, jacobi3
from .ops.ops3d import velocity_divergence3
from .run_plume import resolve_device
from .sim.scenes import plume_config
from .sim.scenes3 import create_plume_scene3
from .sim.step3d import simulate_step3

# The kernels of the 3-D step, by their letter in the kernel table.
KERNELS = {"I": jacobi3.solve_jacobi3, "K": advect3.advect_scalar3,
           "L": advect3.advect_all3, "M": advect3.advect_velocity3}


def plume3d_case(res: int = 128, device="cuda", jacobi_iter: int = 60,
                 fuse_advection: bool = False, line_trace: bool = False):
    """(SimConfig, initial SimState3) of bench3d's classical plume case."""
    dev = resolve_device(device)
    cfg = plume_config(dt=0.25, jacobi_iter=jacobi_iter, buoyancy_scale=0.5,
                       gravity_vec=(0.0, -1.0, 0.0), line_trace=line_trace,
                       max_disp=2, advection_impl="window", use_pallas=True,
                       fuse_advection=fuse_advection)
    state = create_plume_scene3(res, res, res, density_val=0.1,
                                u_scale=0.6 * res / 64.0, device=dev)
    return cfg, state


def quality3(state):
    """max|div| over interior cells, mean|div| over fluid cells, the
    density sum and max|U| of a 3-D state."""
    div = velocity_divergence3(state.U, state.flags).abs()
    fluid = state.flags == FLUID
    return {"max_div": float(div.max()),
            "mean_div": float((div * fluid).sum() / fluid.sum()),
            "density_sum": float(state.density.sum()),
            "max_U": float(state.U.abs().max())}


@torch.no_grad()
def run_plume3d(res: int = 128, steps: int = 20, device="cuda",
                jacobi_iter: int = 60, fuse_advection: bool = False,
                line_trace: bool = False):
    """Run ``steps`` steps; returns a dict with the final ``state``,
    ``ms_per_step`` over all but the last step, the kernel launches per
    step and ``quality3(state)``."""
    cfg, state = plume3d_case(res, device, jacobi_iter, fuse_advection,
                              line_trace)
    on_card = state.U.device.type == "cuda"
    before = {k: fn.launches for k, fn in KERNELS.items()}
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state = simulate_step3(cfg, state)
    if on_card:
        end.record()
        end.synchronize()
        elapsed_ms = start.elapsed_time(end)
    else:
        elapsed_ms = 1e3 * (time.perf_counter() - t0)
    state = simulate_step3(cfg, state)
    per_step = {k: (fn.launches - before[k]) / steps
                for k, fn in KERNELS.items() if fn.launches > before[k]}
    return {"state": state,
            "ms_per_step": elapsed_ms / max(steps - 1, 1),
            "launches_per_step": per_step, **quality3(state)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--jacobi-iter", type=int, default=60)
    ap.add_argument("--fuse-advection", action="store_true")
    ap.add_argument("--line-trace", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_plume3d(args.res, args.steps, args.device, args.jacobi_iter,
                      args.fuse_advection, args.line_trace)
    st = out.pop("state")
    print(json.dumps({
        "res": args.res, "steps": args.steps,
        "jacobi_iter": args.jacobi_iter,
        "fuse_advection": args.fuse_advection,
        "line_trace": args.line_trace, **out,
        "finite": all(bool(torch.isfinite(t).all())
                      for t in (st.U, st.p, st.density))}))


if __name__ == "__main__":
    main()
