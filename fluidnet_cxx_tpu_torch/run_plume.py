"""Run the 2-D buoyant plume with the learned projection.

    python -m fluidnet_cxx_tpu_torch.run_plume --res 512 --steps 20

The case is the JAX package's ``bench.py`` "cnn" row: ``plume_config``
(dt 0.1, MacCormack 0.6, buoyancy 0.25, ``max_disp`` 4, line trace and
merged advection on, convnet projection), the plume scene with inlet speed
2*res/128 and radius 0.145, and the PUNet of
``trained_models/PUNetD2_128/model_config.json`` at its full widths.
The weights are drawn from ``--seed`` with flax's initialiser: the trained
checkpoint is an orbax file that only a JAX installation can read.

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import json
import time
from pathlib import Path

import torch

from .celltype import FLUID
from .config import load_model_config
from .models.convert import flax_to_state_dict, random_flax_params
from .models.fluidnet import make_project_fn
from .models.punet import PUNet
from .ops.stencils import velocity_divergence
from .sim.scenes import create_plume_scene, plume_config
from .sim.step import simulate_step

MODEL_DIR = Path(__file__).resolve().parent.parent / "trained_models" / \
    "PUNetD2_128"


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


def build_punet(mcfg, seed: int = 0, device="cpu") -> PUNet:
    """The configured PUNet with flax-initialised weights from ``seed``."""
    net = PUNet.from_config(mcfg)
    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table,
                                                              seed)))
    return net.to(device).eval()


def plume_case(res: int = 512, device="cuda", seed: int = 0,
               model_dir=MODEL_DIR):
    """(SimConfig, initial SimState, project_fn) of the plume cnn case."""
    dev = resolve_device(device)
    cfg = plume_config(dt=0.1, line_trace=True, max_disp=4,
                       fuse_advection=True, sim_method="convnet")
    state = create_plume_scene(res, res, density_val=0.1,
                               u_scale=2.0 * res / 128.0, rad=0.145,
                               device=dev)
    mcfg = load_model_config(str(model_dir))
    project = make_project_fn(mcfg, build_punet(mcfg, seed, dev))
    return cfg, state, project


def fluid_mean_abs_div(state, U):
    """mean |div U| over fluid cells outside the inlet rows."""
    fl = (state.flags == FLUID) & (state.U_bc_inv_mask[:, 1] > 0.5)
    div = velocity_divergence(U, state.flags).abs()
    return float((div * fl).sum() / fl.sum())


@torch.no_grad()
def run_plume(res: int = 512, steps: int = 20, device="cuda", seed: int = 0,
              model_dir=MODEL_DIR):
    """Run ``steps`` steps; returns a dict with the final ``state``,
    ``ms_per_step`` over all but the last step (CUDA events on the card,
    the host clock on the CPU) and the mean |div| of the last step's
    projection input and output."""
    cfg, state, project = plume_case(res, device, seed, model_dir)
    on_card = state.U.device.type == "cuda"
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state = simulate_step(cfg, state, project)
    if on_card:
        end.record()
        end.synchronize()
        elapsed_ms = start.elapsed_time(end)
    else:
        elapsed_ms = 1e3 * (time.perf_counter() - t0)
    seen = {}

    def observed(p, U, flags, density, U_bc, U_bc_inv_mask):
        seen["div_in"] = fluid_mean_abs_div(state, U * U_bc_inv_mask + U_bc)
        return project(p, U, flags, density, U_bc, U_bc_inv_mask)

    observed.handles_const_vals = True
    state = simulate_step(cfg, state, observed)
    return {"state": state,
            "ms_per_step": elapsed_ms / max(steps - 1, 1),
            "div_in": seen["div_in"],
            "div_out": fluid_mean_abs_div(state, state.U)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run_plume(args.res, args.steps, args.device, args.seed)
    st = out["state"]
    print(json.dumps({
        "res": args.res, "steps": args.steps,
        "ms_per_step": out["ms_per_step"],
        "mean_abs_div_in": out["div_in"], "mean_abs_div_out": out["div_out"],
        "rho_max": float(st.density.max()),
        "finite": bool(torch.isfinite(st.U).all()),
    }))


if __name__ == "__main__":
    main()
