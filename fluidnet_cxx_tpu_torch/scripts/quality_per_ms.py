"""Quality per ms, the twin of the JAX package's
``scripts/quality_per_ms.py``: the learned projection with K polish
sweeps against Jacobi-N and multigrid at one resolution.

    python -m fluidnet_cxx_tpu_torch.scripts.quality_per_ms \\
        --modelDir trained_models/PUNetD2_128 [--res 512] [--iters 600]
        [--statIter 100] [--jacobi 28,50,100,200,400] [--mg 1,2,4]
        [--polish 0,16,32,64,128] [--mgLearned DIR] [--out out/qpm.json]
        [--device cpu]

Each case rolls the plume (``create_plume_scene(res, res,
density_val=0.1, u_scale=2*res/128, rad=0.145)``) for ``iters`` steps in
chunks of ``statIter``, with JAX's configs: ``use_pallas`` on the card
only (on the CPU the density runs the march trace on the torch engine),
the line trace on unless ``QPM_LINE_TRACE=0``. Per case it reports:

* the marginal ms/step on the end state: a chunk of ``statIter`` steps
  and one of 4x that, each timed on its second run, differenced over
  3 x ``statIter`` steps (CUDA events on the card, the host clock on the
  CPU);
* mean|div| and max|div| over fluid cells outside the inlet rows, over
  the stats points after the first, and the final plume height;
* against a converged solve (30 V-cycles of ``solve_mg``) of the case's
  own pre-projection state: the mean-removed relative L2 pressure error
  and both post-projection max|div|.

The cases: Jacobi-N (kernel F on the card), multigrid with N V-cycles
(kernel H in the step, G in the scoring), ``mg_learned-1v`` with
``--mgLearned`` (the converted MGCoarseNet as G's coarse solve) and
``punet+K`` (``--modelDir``'s converted weights on the flax path, kernel
B, with K polish sweeps, ``polish_impl`` "pallas" on the card and "xla"
on the CPU). The record of every case goes to ``--out`` as JAX's JSON
list; ``--device`` is the port's own flag.
"""
import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..celltype import FLUID
from ..config import load_model_config
from ..models.fluidnet import make_project_fn
from ..models.mg_coarse import load_mg_coarse, make_project_fn_mg_learned
from ..ops.kernels.jacobi import solve_jacobi
from ..ops.kernels.mg import solve_mg
from ..ops.stencils import velocity_divergence, velocity_update
from ..run_plume import build_net, resolve_device
from ..sim.scenes import create_plume_scene, plume_config
from ..sim.step import _wall_bcs, apply_const_vals, simulate_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.scripts.quality_per_ms",
        description=__doc__.splitlines()[0])
    ap.add_argument("--modelDir", required=True)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--statIter", type=int, default=100)
    ap.add_argument("--jacobi", default="28,50,100,200,400")
    ap.add_argument("--mg", default="1,2,4")
    ap.add_argument("--polish", default="0,16,32,64,128")
    ap.add_argument("--mgLearned", default=None,
                    help="MGCoarse model dir: adds an mg_learned-1v row "
                         "(learned coarse-grid correction V-cycle)")
    ap.add_argument("--out", default="out/qpm.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _np(t):
    return t.detach().cpu().numpy()


@torch.no_grad()
def truth_error(cfg, s, project=None, truth_vcycles=30):
    """The case's projection against a converged solve on its own end
    state: advance to just before the projection (``output_div``), apply
    the step's own pre-projection walls and inlet BCs, then solve with 30
    V-cycles and with the case's projection. Returns the mean-removed
    relative L2 pressure error and both post-projection max|div| over
    fluid cells outside the inlet rows."""
    s_div = simulate_step(cfg, s, project_fn=project, output_div=True)
    U = _wall_bcs(cfg, s_div, s_div.U)
    U, _ = apply_const_vals(s_div, U, s_div.density)
    flags = s_div.flags
    div = velocity_divergence(U, flags)
    p_truth = solve_mg(flags, div, n_vcycles=truth_vcycles)
    U_truth = velocity_update(p_truth, U, flags)
    if cfg.sim_method == "convnet":
        p_case, U_case = project(s_div.p, U, flags, s_div.density)
    elif cfg.sim_method == "multigrid":
        p_case = solve_mg(flags, div, n_vcycles=cfg.mg_vcycles,
                          pre=cfg.mg_pre, post=cfg.mg_post,
                          coarse_iters=cfg.mg_coarse_iters)
        U_case = velocity_update(p_case, U, flags)
    else:
        p_case = solve_jacobi(flags, div, cfg.jacobi_iter)
        U_case = velocity_update(p_case, U, flags)

    fl = _np(flags == FLUID).astype(np.float32)
    n = np.sum(fl)
    dm = _np((flags == FLUID) & (s_div.U_bc_inv_mask[:, 1] > 0.5)).astype(
        np.float32)

    def centred(p):
        p = _np(p) * fl
        return p - (p.sum() / n) * fl

    pt, pc = centred(p_truth), centred(p_case)
    p_err = float(np.linalg.norm(pc - pt) / max(np.linalg.norm(pt), 1e-30))
    dmax_case = float(np.abs(_np(velocity_divergence(U_case, flags)) * dm)
                      .max())
    dmax_truth = float(np.abs(_np(velocity_divergence(U_truth, flags)) * dm)
                       .max())
    return dict(p_err_vs_truth=round(p_err, 5),
                max_div_one_shot=round(dmax_case, 6),
                max_div_truth=round(dmax_truth, 8))


class Clock:
    """Seconds of ``fn()``: CUDA events on the card, the host clock on
    the CPU (after a synchronisation)."""

    def __init__(self, device):
        self.card = device.type == "cuda"

    def __call__(self, fn):
        if self.card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0


@torch.no_grad()
def run_case(name, cfg, state0, iters, stat, project=None):
    """One case's record (JAX's keys), printed as JAX's line."""
    fl_mask = (state0.flags == FLUID) & (state0.U_bc_inv_mask[:, 1] > 0.5)
    clock = Clock(state0.U.device)

    def chunk(s, n):
        for _ in range(n):
            s = simulate_step(cfg, s, project_fn=project)
        return s

    def stats(s):
        ad = velocity_divergence(s.U, s.flags).abs() * fl_mask
        rho = s.density[0]
        present = rho.amax(dim=1) > 0.05 * rho.max()
        rows = torch.arange(rho.shape[0], device=rho.device)
        return (float(ad.sum() / fl_mask.sum()), float(ad.max()),
                int(torch.where(present, rows, 0).max()))

    s = state0
    means, maxs = [], []
    height = 0
    for _ in range(iters // stat):
        s = chunk(s, stat)
        m, mx, height = stats(s)
        means.append(m)
        maxs.append(mx)

    # Marginal ms/step on the end state (the busy plume).
    s1 = chunk(s, stat)
    _, t_a = clock(lambda: chunk(s1, stat))
    s2 = chunk(s, 4 * stat)
    _, t_b = clock(lambda: chunk(s2, 4 * stat))
    ms = 1e3 * max(t_b - t_a, 1e-9) / (3 * stat)

    rec = dict(
        name=name,
        ms_per_step=round(ms, 4),
        steps_per_sec=round(1e3 / ms, 1),
        mean_div=float(np.mean(means[1:])),
        max_div=float(np.max(maxs[1:])),
        final_height=int(height),
    )
    rec.update(truth_error(cfg, s, project))
    print(
        f"{name:24s} {ms:7.3f} ms/step ({1e3/ms:7.1f} steps/s)  "
        f"mean|div| {rec['mean_div']:.6f}  max|div| {rec['max_div']:.5f}  "
        f"height {rec['final_height']:4d}  "
        f"p_err_vs_truth {rec['p_err_vs_truth']:.4f}",
        flush=True,
    )
    return rec


def ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None):
    """Run the cases; writes and returns the records."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    res = args.res
    state0 = create_plume_scene(res, res, density_val=0.1,
                                u_scale=2.0 * res / 128.0, rad=0.145,
                                device=dev)
    # The trace on is the reference's advection (QPM_LINE_TRACE=0 for the
    # trace-off tables); the kernels on the card, as JAX's --fast.
    fast = dict(use_pallas=dev.type == "cuda",
                line_trace=os.environ.get("QPM_LINE_TRACE", "1") == "1")

    results = []
    for n in ints(args.jacobi):
        cfg = plume_config(jacobi_iter=n, **fast)
        results.append(run_case(f"jacobi-{n}", cfg, state0, args.iters,
                                args.statIter))
    for nv in ints(args.mg):
        cfg = plume_config(sim_method="multigrid", mg_vcycles=nv, **fast)
        results.append(run_case(f"mg-{nv}v", cfg, state0, args.iters,
                                args.statIter))
    if args.mgLearned:
        project = make_project_fn_mg_learned(
            load_mg_coarse(args.mgLearned, dev))
        cfg = plume_config(sim_method="convnet", **fast)
        results.append(run_case("mg_learned-1v", cfg, state0, args.iters,
                                args.statIter, project))

    mcfg = load_model_config(args.modelDir)
    net = build_net(mcfg, None, dev, args.modelDir)
    for k in ints(args.polish):
        mk = dataclasses.replace(
            mcfg, polish_sweeps=k,
            polish_impl="pallas" if fast["use_pallas"] else "xla")
        project = make_project_fn(mk, net)
        cfg = plume_config(sim_method="convnet", **fast)
        results.append(run_case(f"punet+{k}", cfg, state0, args.iters,
                                args.statIter, project))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
