"""Run the 3-D buoyant plume under the classical Jacobi projection, the
3-D multigrid or the learned one.

    python -m fluidnet_cxx_tpu_torch.run_plume3d --res 128 --steps 20
    python -m fluidnet_cxx_tpu_torch.run_plume3d --fuse-advection \\
        --line-trace
    python -m fluidnet_cxx_tpu_torch.run_plume3d --sim-method multigrid \\
        --fuse-advection
    python -m fluidnet_cxx_tpu_torch.run_plume3d --sim-method convnet \\
        --model-dir trained_models/PUNet3p8_64 [--path flax]
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
``--fuseAdvection`` and ``--lineTrace``). ``--sim-method multigrid`` is
bench3d's "pallas + multigrid" row: ``solve_mg3`` with ``--mg-vcycles``
V-cycles (2), at most 3 levels and 8 post sweeps, its sweeps on kernel I.

``--sim-method convnet`` is bench3d's learned row (``--modelDir``): the
same scene and config with the PUNet3 of ``--model-dir``'s
``model_config.json`` at its full widths (``PUNet3p8_64`` by default:
patch 8, widths 96/128, bfloat16, 16 polish sweeps; ``PUNet3_32``: patch
4, 8 sweeps; ``--polish-sweeps`` overrides the count), projecting with
kernels N (the PUNet3 forward, 9 conv launches) and J (the tail: RHS,
polish sweeps, velocity update, walls) after K and M: the fused forward
(``make_project_fn3_fused_forward``, bench3d's engine, ``polish_impl``
"fused"). ``--path flax`` runs the flax path instead
(``make_project_fn3``: the model as its ``model_config.json`` ships it,
N's flax route, the polish of its ``polish_impl``: "xla" and "pallas" on
kernel I, "fused" on J). The network runs the
trained weights of ``--model-dir`` (its ``torch_state_dict.pt``, converted
from the orbax checkpoint by ``scripts/torch_convert_checkpoints.py``);
``--weight-seed N`` asks for flax-initialised weights from seed N instead.
The output says which (``"weights": "trained"`` or ``"seed:N"``).

Prints ms/step (CUDA events on the card, the host clock on the CPU, over
all but the last step), the launches of each kernel per step and the
final state's quality: max|div| over interior cells (what bench3d
prints), mean|div| over fluid cells, the density sum and max|U|. Runs on
the card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from .celltype import FLUID
from .config import load_model_config
from .models.convert import (flax_to_state_dict3, load_state_dict_file,
                             random_flax_params3)
from .models.punet3d import (PUNet3, make_project_fn3,
                              make_project_fn3_fused_forward)
from .ops.kernels import advect3, jacobi3, proj_tail3, punet3
from .ops.ops3d import velocity_divergence3
from .run_plume import resolve_device, weights_label
from .sim.scenes import plume_config
from .sim.scenes3 import create_plume_scene3
from .sim.step3d import simulate_step3

# The kernels of the 3-D step, by their letter in the kernel table; "Mo"
# and "Nf" count the launches of M with orig and of N's flax route, which
# also count under M and N.
KERNELS = {"I": jacobi3.solve_jacobi3, "J": proj_tail3.project_tail3,
           "K": advect3.advect_scalar3, "L": advect3.advect_all3,
           "M": advect3.advect_velocity3, "Mo": advect3.velocity_orig,
           "N": punet3.conv3d_ndhwc, "Nf": punet3.flax_route}

MODELS = Path(__file__).resolve().parent.parent / "trained_models"
MODEL_DIR3 = MODELS / "PUNet3p8_64"


def plume3d_case(res: int = 128, device="cuda", jacobi_iter: int = 60,
                 fuse_advection: bool = False, line_trace: bool = False,
                 sim_method: str = "jacobi", mg_vcycles: int = 2):
    """(SimConfig, initial SimState3) of bench3d's plume case."""
    dev = resolve_device(device)
    cfg = plume_config(dt=0.25, jacobi_iter=jacobi_iter, buoyancy_scale=0.5,
                       gravity_vec=(0.0, -1.0, 0.0), line_trace=line_trace,
                       max_disp=2, advection_impl="window", use_pallas=True,
                       fuse_advection=fuse_advection, sim_method=sim_method,
                       mg_vcycles=mg_vcycles)
    state = create_plume_scene3(res, res, res, density_val=0.1,
                                u_scale=0.6 * res / 64.0, device=dev)
    return cfg, state


def build_punet3(mcfg, weight_seed=None, device="cpu",
                 model_dir=MODEL_DIR3, rounding: str = "fused") -> PUNet3:
    """The configured PUNet3 on ``rounding``'s route ("fused" or "flax")
    with the trained weights of ``model_dir`` (``weight_seed`` None) or
    flax-initialised weights from ``weight_seed``."""
    net = PUNet3.from_config(mcfg, rounding)
    net.load_state_dict(
        load_state_dict_file(model_dir) if weight_seed is None else
        flax_to_state_dict3(random_flax_params3(net.table, weight_seed)))
    return net.to(device).eval()


def learned3d_case(res: int = 128, device="cuda", model_dir=MODEL_DIR3,
                   polish_sweeps=None, weight_seed=None,
                   fuse_advection: bool = False, line_trace: bool = False,
                   compute_dtype=None, path: str = "fused"):
    """(SimConfig, initial SimState3, project_fn) of bench3d's learned
    plume case: the PUNet3 of ``model_dir`` (``polish_sweeps`` and
    ``compute_dtype`` overriding its own) with its trained weights, or
    weights from ``weight_seed``; ``path`` "fused" is bench3d's fused
    forward (``polish_impl`` "fused"), "flax" the flax path with the
    model's own ``polish_impl``."""
    if path not in ("fused", "flax"):
        raise ValueError(f"path {path!r}: 'fused' or 'flax'")
    cfg, state = plume3d_case(res, device, fuse_advection=fuse_advection,
                              line_trace=line_trace, sim_method="convnet")
    mcfg = load_model_config(str(model_dir))
    if polish_sweeps is not None:
        mcfg = dataclasses.replace(mcfg, polish_sweeps=polish_sweeps)
    if compute_dtype is not None:
        mcfg = dataclasses.replace(mcfg, compute_dtype=compute_dtype)
    if path == "fused":
        mcfg = dataclasses.replace(mcfg, polish_impl="fused")
    net = build_punet3(mcfg, weight_seed, state.U.device, model_dir, path)
    make = (make_project_fn3_fused_forward if path == "fused"
            else make_project_fn3)
    return cfg, state, make(mcfg, net)


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
                line_trace: bool = False, sim_method: str = "jacobi",
                model_dir=MODEL_DIR3, polish_sweeps=None,
                weight_seed=None, path: str = "fused", mg_vcycles: int = 2):
    """Run ``steps`` steps; returns a dict with the final ``state``,
    ``ms_per_step`` over all but the last step, the kernel launches per
    step, ``quality3(state)`` and, for the learned case, the weights it
    ran (``weights``: "trained" or "seed:N")."""
    if sim_method == "convnet":
        cfg, state, project = learned3d_case(
            res, device, model_dir, polish_sweeps, weight_seed,
            fuse_advection, line_trace, path=path)
    else:
        cfg, state = plume3d_case(res, device, jacobi_iter, fuse_advection,
                                  line_trace, sim_method, mg_vcycles)
        project = None
    out = drive3(cfg, state, project, steps)
    if project is not None:
        out["weights"] = weights_label(weight_seed)
    return out


def drive3(cfg, state, project, steps: int):
    """Run ``steps`` 3-D steps from ``state``; returns a dict with the
    final ``state``, ``ms_per_step`` over all but the last step, the
    kernel launches per step and ``quality3(state)``."""
    on_card = state.U.device.type == "cuda"
    before = {k: fn.launches for k, fn in KERNELS.items()}
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state = simulate_step3(cfg, state, project)
    if on_card:
        end.record()
        end.synchronize()
        elapsed_ms = start.elapsed_time(end)
    else:
        elapsed_ms = 1e3 * (time.perf_counter() - t0)
    state = simulate_step3(cfg, state, project)
    per_step = {k: (fn.launches - before[k]) / steps
                for k, fn in KERNELS.items() if fn.launches > before[k]}
    return {"state": state, "ms_per_step": elapsed_ms / max(steps - 1, 1),
            "launches_per_step": per_step, **quality3(state)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--jacobi-iter", type=int, default=60)
    ap.add_argument("--fuse-advection", action="store_true")
    ap.add_argument("--line-trace", action="store_true")
    ap.add_argument("--sim-method", default="jacobi",
                    choices=("jacobi", "multigrid", "convnet"))
    ap.add_argument("--mg-vcycles", type=int, default=2)
    ap.add_argument("--model-dir", default=str(MODEL_DIR3))
    ap.add_argument("--path", default="fused", choices=("fused", "flax"),
                    help="the learned projection: bench3d's fused forward "
                         "or the flax path")
    ap.add_argument("--polish-sweeps", type=int, default=None)
    ap.add_argument("--weight-seed", type=int, default=None,
                    help="flax-initialised weights from this seed in "
                         "place of the trained ones")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_plume3d(args.res, args.steps, args.device, args.jacobi_iter,
                      args.fuse_advection, args.line_trace, args.sim_method,
                      args.model_dir, args.polish_sweeps, args.weight_seed,
                      args.path, args.mg_vcycles)
    st = out.pop("state")
    method = {"jacobi": {"jacobi_iter": args.jacobi_iter},
              "multigrid": {"mg_vcycles": args.mg_vcycles},
              "convnet": {"model_dir": args.model_dir, "path": args.path,
                          "polish_sweeps": args.polish_sweeps}}[
                              args.sim_method]
    print(json.dumps({
        "res": args.res, "steps": args.steps,
        "sim_method": args.sim_method, **method,
        "fuse_advection": args.fuse_advection,
        "line_trace": args.line_trace, **out,
        "finite": all(bool(torch.isfinite(t).all())
                      for t in (st.U, st.p, st.density))}))


if __name__ == "__main__":
    main()
