"""Physics-parity evaluation, the twin of the JAX package's
``scripts/eval_parity.py``: the CNN projection against Jacobi-28, -100
and -200 on the plume (the reference's headline comparison).

    python -m fluidnet_cxx_tpu_torch.scripts.eval_parity \\
        [--modelDir trained_models/PUNetD2_128] [--res 128] [--iters 1500]
        [--statIter 50] [--out out/parity] [--device cpu]

The scene is ``create_plume_scene(res, res, density_val=0.1,
u_scale=2*res/128, rad=0.145)`` and each case runs JAX's config,
``plume_config(jacobi_iter=N)`` or ``plume_config(sim_method="convnet")``:
``use_pallas`` off, so the density is advected on the torch engine with
the march trace (ops/advection.py) and the velocity on kernel E; the
Jacobi cases solve on kernel F, the CNN (``--modelDir``'s converted
``torch_state_dict.pt`` on the flax path, ``models/fluidnet.py::
make_project_fn``, its polish as the model config says) on kernel B.
After every ``statIter`` steps it records the plume front height (the
highest row whose largest density exceeds 5% of the grid's) and the mean
and max |div| over fluid cells outside the inlet rows. It prints JAX's
line a case and the summary, and writes ``growth.npy`` (the heights, a
row a case), ``summary.json`` (final height, mean|div| and max|div| over
the stats points after the first; the CNN's mean|div| over Jacobi-100's)
and ``growth.png`` where matplotlib is installed (else it prints "plot
failed: ...", as JAX's script). ``--device`` is the port's own flag.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from ..celltype import FLUID
from ..ops.stencils import velocity_divergence
from ..run_plume import learned_projection, resolve_device
from ..sim.scenes import create_plume_scene, plume_config
from ..sim.step import simulate_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.scripts.eval_parity",
        description=__doc__.splitlines()[0])
    ap.add_argument("--modelDir", default=None)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--statIter", type=int, default=50)
    ap.add_argument("--out", default="out/parity")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def chunk_stats(s):
    """(height, mean|div|, max|div|) of state ``s``, as JAX's chunk
    computes them."""
    rho = s.density[0]
    present = rho.amax(dim=1) > 0.05 * rho.max()
    rows = torch.arange(rho.shape[0], device=rho.device)
    height = torch.where(present, rows, 0).max()
    div = velocity_divergence(s.U, s.flags)
    fluid = s.flags == FLUID
    if s.U_bc_inv_mask is not None:
        fluid = fluid & (s.U_bc_inv_mask[:, 1] > 0.5)
    ad = div.abs() * fluid
    return height, ad.sum() / fluid.sum(), ad.max()


@torch.no_grad()
def run_case(name, cfg, state, iters, stat_iter, project=None):
    """The heights and divergences of one case after every ``stat_iter``
    steps; prints JAX's line. Also returns ``ms_per_step`` (CUDA events
    on the card, the host clock on the CPU)."""
    heights, mean_divs, max_divs = [], [], []
    s = state
    on_card = s.U.device.type == "cuda"
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters // stat_iter):
        for _ in range(stat_iter):
            s = simulate_step(cfg, s, project_fn=project)
        height, mean_div, max_div = chunk_stats(s)
        heights.append(int(height))
        mean_divs.append(float(mean_div))
        max_divs.append(float(max_div))
    if on_card:
        end.record()
        end.synchronize()
        elapsed_ms = start.elapsed_time(end)
    else:
        elapsed_ms = 1e3 * (time.perf_counter() - t0)
    print(
        f"{name:12s} final height {heights[-1]:4d} "
        f"mean|div| {np.mean(mean_divs[1:]):.6f} "
        f"max|div| {np.max(max_divs[1:]):.5f}",
        flush=True,
    )
    steps = (iters // stat_iter) * stat_iter
    return dict(name=name, heights=heights, mean_divs=mean_divs,
                max_divs=max_divs, ms_per_step=elapsed_ms / max(steps, 1),
                state=s)


def plot_growth(results, stat_iter, out):
    """growth.png: each case's heights against the iteration."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    t = np.arange(1, len(results[0]["heights"]) + 1) * stat_iter
    for r in results:
        ax.plot(t, r["heights"], label=r["name"])
    ax.set_xlabel("iteration")
    ax.set_ylabel("plume front height (cells)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out, "growth.png"), dpi=110)


def main(argv=None):
    """Run the cases; prints JAX's output and returns (summary, the
    per-case results)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    res = args.res
    state = create_plume_scene(res, res, density_val=0.1,
                               u_scale=2.0 * res / 128.0, rad=0.145,
                               device=dev)

    results = []
    for ji in (28, 100, 200):
        cfg = plume_config(jacobi_iter=ji)
        results.append(
            run_case(f"jacobi-{ji}", cfg, state, args.iters, args.statIter))

    if args.modelDir:
        project = learned_projection(args.modelDir, None, dev,
                                     flax_path=True)
        cfg = plume_config(sim_method="convnet")
        results.append(run_case("convnet", cfg, state, args.iters,
                                args.statIter, project))

    np.save(os.path.join(args.out, "growth.npy"),
            np.array([r["heights"] for r in results]))
    summary = {r["name"]: {
        "final_height": r["heights"][-1],
        "mean_div": float(np.mean(r["mean_divs"][1:])),
        "max_div": float(np.max(r["max_divs"][1:])),
    } for r in results}
    j100 = summary.get("jacobi-100", {}).get("mean_div")
    if "convnet" in summary and j100:
        summary["convnet_vs_jacobi100_div_ratio"] = (
            summary["convnet"]["mean_div"] / j100)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))

    try:
        plot_growth(results, args.statIter, args.out)
    except Exception as e:  # noqa: BLE001 — JAX's script prints and goes on
        print("plot failed:", e)
    return summary, results


if __name__ == "__main__":
    main()
