"""Run the 2-D buoyant plume.

    python -m fluidnet_cxx_tpu_torch.run_plume --res 512 --steps 20
    python -m fluidnet_cxx_tpu_torch.run_plume --sim-method jacobi \
        --jacobi-iter 200
    python -m fluidnet_cxx_tpu_torch.run_plume --sim-method multigrid \
        --mg-vcycles 2
    python -m fluidnet_cxx_tpu_torch.run_plume --sim-method jacobi \
        --no-fuse-advection
    python -m fluidnet_cxx_tpu_torch.run_plume --sim-method mg_learned

The cases are the JAX package's ``bench.py`` rows: ``plume_config`` (dt
0.1, MacCormack 0.6, buoyancy 0.25, ``max_disp`` 4, line trace and merged
advection on) with the plume scene (inlet speed 2*res/128, radius 0.145)
and one projection: "convnet" (the default, the "cnn" row) runs the PUNet
of ``trained_models/PUNetD2_128/model_config.json`` at its full widths
(or the network of ``--model-dir``, below),
"jacobi" ``--jacobi-iter`` sweeps (the jacobi-N rows), "multigrid"
``--mg-vcycles`` warm V-cycles (the mg-2v row), "mg_learned" one cold
V-cycle whose levels below side 128 are replaced by the
learned coarse solve of ``trained_models/MGCoarse_128`` (run as "convnet"
with ``models/mg_coarse.py::make_project_fn_mg_learned``, as the JAX
``scripts/run_plume.py`` does; kernel G split at the cut, kernel B for the
coarse net). ``--no-fuse-advection``
advects the density and the velocity separately (kernels D and E in place
of A; ``bench.py``'s ``BENCH_FUSE_ADV=0``). The PUNet runs the trained
weights (``trained_models/PUNetD2_128/torch_state_dict.pt``, converted
from the orbax checkpoint by ``scripts/torch_convert_checkpoints.py``);
``--weight-seed N`` asks for flax-initialised weights from seed N instead.
The output says which (``"weights": "trained"`` or ``"seed:N"``) and
which net ran (``"model"``). ``--model-dir`` points either at another
checkpoint directory; its ``model_config.json`` picks the projection: a
refine-free float32 PUNet keeps the fused path (``make_project_fn_fused_forward``,
kernels B and C), "FluidNet" (``DataTrain_128``'s FluidNetTower),
"ScaleNet" (the ``ScaleNet_*`` MultiScaleNets) and a PUNet with a
refinement stack go through the flax-path ``FluidNet``
(``models/fluidnet.py::make_project_fn``: every conv on kernel B, the
polish of ``polish_impl``, the step's unfused branch), as the JAX
``scripts/run_plume.py --simMethod convnet --modelDir`` runs them:

    python -m fluidnet_cxx_tpu_torch.run_plume \
        --model-dir trained_models/ScaleNet_jets_128

Prints ms/step and ``bench.py``'s quality stats of the final state:
mean|div| and max|div| over fluid cells outside the inlet rows, and the
plume height (the highest row whose density exceeds 5% of the maximum).
Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import json
import time
from pathlib import Path

import torch

from .celltype import FLUID
from .config import load_model_config
from .models.convert import (flax_to_state_dict, load_state_dict_file,
                             random_flax_params)
from .models.fluidnet import (make_net, make_project_fn,
                              make_project_fn_fused_forward)
from .models.mg_coarse import (MGCoarseNet, init_mg_coarse_params,
                               load_mg_coarse, load_mg_coarse_config,
                               make_project_fn_mg_learned)
from .models.punet import ConvNet
from .scripts import finite
from .ops.stencils import velocity_divergence
from .sim.scenes import create_plume_scene, plume_config
from .sim.step import simulate_step

MODEL_DIR = Path(__file__).resolve().parent.parent / "trained_models" / \
    "PUNetD2_128"
MG_COARSE_DIR = MODEL_DIR.parent / "MGCoarse_128"


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


def weights_label(weight_seed) -> str:
    """How a run's weights are named in its output: "trained" for the
    converted checkpoint (``weight_seed`` None), "seed:N" otherwise."""
    return "trained" if weight_seed is None else f"seed:{weight_seed}"


def build_net(mcfg, weight_seed=None, device="cpu",
              model_dir=MODEL_DIR) -> ConvNet:
    """The configured network (``models/fluidnet.py::make_net``: PUNet,
    MultiScaleNet or FluidNetTower) with the trained weights of
    ``model_dir`` (``weight_seed`` None) or flax-initialised weights from
    ``weight_seed``."""
    net = make_net(mcfg)
    net.load_state_dict(
        load_state_dict_file(model_dir) if weight_seed is None else
        flax_to_state_dict(random_flax_params(net.table, weight_seed)))
    return net.to(device).eval()


def build_mg_coarse(weight_seed=None, device="cpu",
                    model_dir=MG_COARSE_DIR,
                    dtype: str = "bfloat16") -> MGCoarseNet:
    """The ``MGCoarseNet`` of ``model_dir`` with its trained weights
    (``weight_seed`` None) or flax-initialised ones from ``weight_seed``,
    its PUNet in ``dtype`` (bfloat16, as JAX runs it, by default)."""
    if weight_seed is None:
        return load_mg_coarse(model_dir, device, dtype)
    net = MGCoarseNet(load_mg_coarse_config(model_dir), dtype)
    return init_mg_coarse_params(net, weight_seed).to(device).eval()


def learned_projection(model_dir, weight_seed=None, device="cpu",
                       flax_path: bool = False):
    """The project_fn of the checkpoint in ``model_dir``: the fused path
    for a refine-free PUNet, the flax path (``FluidNet``, as the JAX
    scene scripts run every network) for every other network, or for all
    under ``flax_path``."""
    mcfg = load_model_config(str(model_dir))
    net = build_net(mcfg, weight_seed, device, model_dir)
    fused = (mcfg.model == "PUNet" and mcfg.punet_refine_convs == 0
             and mcfg.compute_dtype == "float32" and not flax_path)
    make = make_project_fn_fused_forward if fused else make_project_fn
    return make(mcfg, net)


def plume_case(res: int = 512, device="cuda", weight_seed=None,
               model_dir=None, sim_method: str = "convnet",
               jacobi_iter: int = 200, mg_vcycles: int = 2,
               fuse_advection: bool = True, max_disp: int = 4,
               line_trace: bool = True):
    """(SimConfig, initial SimState, project_fn) of a plume case;
    project_fn is None for the classical projections. "mg_learned" runs
    as "convnet" with the learned coarse solve on the levels of side <=
    128. The networks' weights are the trained ones of ``model_dir`` (default:
    PUNetD2_128, or MGCoarse_128 for mg_learned) unless ``weight_seed``
    is given."""
    dev = resolve_device(device)
    learned_mg = sim_method == "mg_learned"
    cfg = plume_config(dt=0.1, line_trace=line_trace, max_disp=max_disp,
                       use_pallas=True, fuse_advection=fuse_advection,
                       sim_method="convnet" if learned_mg else sim_method,
                       jacobi_iter=jacobi_iter, mg_vcycles=mg_vcycles)
    state = create_plume_scene(res, res, density_val=0.1,
                               u_scale=2.0 * res / 128.0, rad=0.145,
                               device=dev)
    if learned_mg:
        net = build_mg_coarse(weight_seed, dev, model_dir or MG_COARSE_DIR)
        return cfg, state, make_project_fn_mg_learned(net)
    if sim_method != "convnet":
        return cfg, state, None
    return cfg, state, learned_projection(model_dir or MODEL_DIR,
                                          weight_seed, dev)


def _fluid_abs_div(state, U):
    """(|div U| masked to fluid cells outside the inlet rows, the mask)."""
    fl = (state.flags == FLUID) & (state.U_bc_inv_mask[:, 1] > 0.5)
    return velocity_divergence(U, state.flags).abs() * fl, fl


def fluid_mean_abs_div(state, U):
    """mean |div U| over fluid cells outside the inlet rows."""
    div, fl = _fluid_abs_div(state, U)
    return float(div.sum() / fl.sum())


def quality(state):
    """bench.py's quality stats of a plume state: mean and max |div U|
    over fluid cells outside the inlet rows, and the plume height."""
    div, fl = _fluid_abs_div(state, state.U)
    rho = state.density[0]
    present = rho.amax(dim=1) > 0.05 * rho.max()
    rows = torch.arange(rho.shape[0], device=rho.device)
    return {"mean_div": float(div.sum() / fl.sum()),
            "max_div": float(div.max()),
            "height": int(torch.where(present, rows, 0).max())}


@torch.no_grad()
def run_plume(res: int = 512, steps: int = 20, device="cuda",
              weight_seed=None, model_dir=None,
              sim_method: str = "convnet", jacobi_iter: int = 200,
              mg_vcycles: int = 2, fuse_advection: bool = True):
    """Run ``steps`` steps; returns a dict with the final ``state``,
    ``ms_per_step`` over all but the last step (CUDA events on the card,
    the host clock on the CPU), ``quality(state)`` and, for the learned
    projections, the weights they ran (``weights``: "trained" or
    "seed:N"), the net (``model``: the checkpoint's ``model``, or
    "MGCoarseNet") and the mean |div| of the last step's projection input
    (``div_in``)."""
    cfg, state, project = plume_case(res, device, weight_seed, model_dir,
                                     sim_method, jacobi_iter, mg_vcycles,
                                     fuse_advection)
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
    seen = {"div_in": None}

    def observed(p, U, flags, density, **bcs):
        # The fused projection gets U_bc and U_bc_inv_mask; the unfused
        # one a U with the inlet BCs already applied.
        U_in = U * bcs["U_bc_inv_mask"] + bcs["U_bc"] if bcs else U
        seen["div_in"] = fluid_mean_abs_div(state, U_in)
        return project(p, U, flags, density, **bcs)

    observed.handles_const_vals = getattr(project, "handles_const_vals",
                                          False)
    state = simulate_step(cfg, state, observed if project else None)
    weights = {}
    if project:
        model = ("MGCoarseNet" if sim_method == "mg_learned" else
                 load_model_config(str(model_dir or MODEL_DIR)).model)
        weights = {"weights": weights_label(weight_seed), "model": model}
    return {"state": state,
            "ms_per_step": elapsed_ms / max(steps - 1, 1), **weights,
            "div_in": seen["div_in"], **quality(state)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--weight-seed", type=int, default=None,
                    help="flax-initialised weights from this seed in "
                         "place of the trained ones")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sim-method", default="convnet",
                    choices=("convnet", "jacobi", "multigrid", "mg_learned"))
    ap.add_argument("--model-dir", default=None,
                    help="checkpoint directory (default: "
                         "trained_models/PUNetD2_128, or MGCoarse_128 for "
                         "mg_learned)")
    ap.add_argument("--jacobi-iter", type=int, default=200)
    ap.add_argument("--mg-vcycles", type=int, default=2)
    ap.add_argument("--no-fuse-advection", dest="fuse_advection",
                    action="store_false")
    args = ap.parse_args(argv)
    out = run_plume(args.res, args.steps, args.device, args.weight_seed,
                    args.model_dir, sim_method=args.sim_method,
                    jacobi_iter=args.jacobi_iter,
                    mg_vcycles=args.mg_vcycles,
                    fuse_advection=args.fuse_advection)
    st = out.pop("state")
    print(json.dumps({
        "res": args.res, "steps": args.steps, "sim_method": args.sim_method,
        "fuse_advection": args.fuse_advection,
        **out, "rho_max": float(st.density.max()), "finite": finite(st),
    }))


if __name__ == "__main__":
    main()
