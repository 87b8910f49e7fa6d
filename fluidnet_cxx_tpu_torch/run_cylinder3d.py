"""Run the 3-D cylinder: flow past a z-extruded cylinder with stick walls
and viscosity (the JAX package's ``sim/scenes3.py::
create_cylinder_scene3``, the first 3-D scene with obstacles).

    python -m fluidnet_cxx_tpu_torch.run_cylinder3d --steps 20
    python -m fluidnet_cxx_tpu_torch.run_cylinder3d --sim-method multigrid
    python -m fluidnet_cxx_tpu_torch.run_cylinder3d \\
        --vorticity-confinement 0.1
    python -m fluidnet_cxx_tpu_torch.run_cylinder3d --d 8 --h 24 --w 48 \\
        --radius 4.5 --center-x 12 --steps 5 --device cpu

The scene is ``create_cylinder_scene3()`` at its defaults (32 x 128 x 384,
radius 12.5 at x 64, inlet velocity 1, Re 100: viscosity 0.25) and the
config of the JAX package's ``tests/test_ops3d.py::
test_cylinder3_scene_runs``: ``plume_config(dt=0.3, viscosity=<the
scene's>, buoyancy_scale=0, advect_density=False, max_disp=2,
line_trace=False)`` on the window engine. A step runs the viscosity
(torch), kernel M with the viscous field as its ``orig``, the stick walls
(torch), and the projection: Jacobi-``--jacobi-iter`` (34) on kernel I, or
``solve_mg3`` (``--mg-vcycles`` 2, at most 3 levels, 8 post sweeps) with
its sweeps on I; ``--vorticity-confinement`` adds the confinement force
(torch). Prints ms/step (CUDA events on the card, the host clock on the
CPU, over all but the last step), the launches of each kernel per step,
max|div| over interior cells, mean|div| over fluid cells, the density
sum (0: no density), max|U| and whether the fields are finite. Runs on
the card unless ``--device cpu`` is given.
"""
import argparse
import json

import torch

from .run_plume import resolve_device
from .run_plume3d import drive3
from .sim.scenes import plume_config
from .sim.scenes3 import create_cylinder_scene3


def cylinder3d_case(d: int = 32, h: int = 128, w: int = 384, device="cuda",
                    sim_method: str = "jacobi", jacobi_iter: int = 34,
                    mg_vcycles: int = 2, vorticity_confinement: float = 0.0,
                    radius: float = 12.5, center_x: float = 64.0):
    """(SimConfig, initial SimState3) of the 3-D cylinder case."""
    dev = resolve_device(device)
    state, visc = create_cylinder_scene3(d, h, w, center_x=center_x,
                                         radius=radius, device=dev)
    cfg = plume_config(dt=0.3, jacobi_iter=jacobi_iter, viscosity=visc,
                       buoyancy_scale=0.0, advect_density=False, max_disp=2,
                       line_trace=False, advection_impl="window",
                       use_pallas=True, sim_method=sim_method,
                       mg_vcycles=mg_vcycles,
                       vorticity_confinement=vorticity_confinement)
    return cfg, state


@torch.no_grad()
def run_cylinder3d(d: int = 32, h: int = 128, w: int = 384, steps: int = 20,
                   device="cuda", sim_method: str = "jacobi",
                   jacobi_iter: int = 34, mg_vcycles: int = 2,
                   vorticity_confinement: float = 0.0, radius: float = 12.5,
                   center_x: float = 64.0):
    """Run ``steps`` steps; returns ``run_plume3d.drive3``'s dict (the
    final ``state``, ms/step, launches per step, max|div|, mean|div|, the
    density sum, max|U|)."""
    cfg, state = cylinder3d_case(d, h, w, device, sim_method, jacobi_iter,
                                 mg_vcycles, vorticity_confinement, radius,
                                 center_x)
    return drive3(cfg, state, None, steps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--h", type=int, default=128)
    ap.add_argument("--w", type=int, default=384)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--sim-method", default="jacobi",
                    choices=("jacobi", "multigrid"))
    ap.add_argument("--jacobi-iter", type=int, default=34)
    ap.add_argument("--mg-vcycles", type=int, default=2)
    ap.add_argument("--vorticity-confinement", type=float, default=0.0)
    ap.add_argument("--radius", type=float, default=12.5)
    ap.add_argument("--center-x", type=float, default=64.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_cylinder3d(args.d, args.h, args.w, args.steps, args.device,
                         args.sim_method, args.jacobi_iter, args.mg_vcycles,
                         args.vorticity_confinement, args.radius,
                         args.center_x)
    st = out.pop("state")
    print(json.dumps({
        "shape": [args.d, args.h, args.w], "steps": args.steps,
        "sim_method": args.sim_method, "jacobi_iter": args.jacobi_iter,
        "mg_vcycles": args.mg_vcycles,
        "vorticity_confinement": args.vorticity_confinement, **out,
        "finite": all(bool(torch.isfinite(t).all())
                      for t in (st.U, st.p))}))


if __name__ == "__main__":
    main()
