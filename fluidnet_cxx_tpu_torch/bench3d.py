"""The port's 3-D bench: ``scripts/bench3d.py``'s buoyant plume on the card,
through the hand-written kernels.

    python -m fluidnet_cxx_tpu_torch.bench3d [--res 128] [--steps 10] \\
        [--jacobiIter 60] [--fuseAdvection] [--lineTrace] [--multigrid]
    python -m fluidnet_cxx_tpu_torch.bench3d \\
        --modelDir trained_models/PUNet3p8_64 --onlyModel
    python -m fluidnet_cxx_tpu_torch.bench3d \\
        --reference fluidnet_cxx_tpu_torch/bench_reference.json

The scene is bench3d's: ``create_plume_scene3(res, res, res,
density_val=0.1, u_scale=0.6*res/64)``, dt 0.25, buoyancy 0.5, gravity (0,
-1, 0), ``max_disp`` 2, window advection (``run_plume3d.plume3d_case``).
Rows: the classical row at Jacobi-``--jacobiIter`` (kernels K, M and I;
L in place of K and M with ``--fuseAdvection``; the first-hit trace with
``--lineTrace``); with ``--multigrid`` bench3d's "pallas + multigrid" row
(``mg2v``: ``solve_mg3`` with 2 V-cycles, at most 3 levels and 8 post
sweeps, its sweeps on kernel I, after the same advection); and with
``--modelDir`` the learned row: the model's trained weights
(``torch_state_dict.pt``) and polish sweeps on bench3d's fused forward,
kernels N and J after the advection (``--computeDtype float32`` runs the
network in float32, the variant the JAX reference can be held to).
``--onlyModel`` skips the classical and multigrid rows. bench3d's "window
(XLA)" and "gather" rows are not ported (ROADMAP A.6).

Speed: bench3d's marginal steps/s, n / (t(2n) - t(n)) with n =
``--steps``, the median of ``--reps`` runs (5) with spread and MAD, by CUDA
events, both as one step captured in a CUDA graph (``sps``, the headline:
no host work a step, as bench3d's jit-scanned runs) and as the Python step
(``eager_sps``); ``ms_per_step`` is 1000 / sps. Quality: bench3d reads
max|div| after its timing runs, 6n steps from t = 0; here a separate
rollout of exactly 6n steps gives max|div| over interior cells, mean|div|
over fluid cells, the density sum and max|U| (``run_plume3d.quality3``).
``--reference`` holds the four within 1% relative of the JAX package's
(``scripts/torch_bench_reference.py``); a row with no reference at the
same settings fails. The last line printed is one JSON object of at most
1.5 KB; the full table goes to ``--out-dir``/bench3d_torch_<time>.json.
Runs on the card unless ``--device cpu`` is given (plain versions, the
host clock, no graph).
"""
import argparse
import time
from pathlib import Path

import torch

from .bench import (OUT_DIR, card_info, check_reference, compact,
                    engine_of, launches_per_step, load_reference, log,
                    rounded, time_both, write_table)
from .run_plume import resolve_device
from .run_plume3d import KERNELS, learned3d_case, plume3d_case, quality3
from .sim.step3d import simulate_step3

LIMITS3 = {col: ("relative", 0.01)
           for col in ("max_div", "mean_div", "density_sum", "max_U")}


def settings3(steps, line_trace):
    """The settings a row's quality depends on
    (``scripts/torch_bench_reference.py::settings3d``); merged and
    separate advection compute the same fields."""
    return {"steps": steps, "max_disp": 2, "line_trace": line_trace}


@torch.no_grad()
def run_row(case, cfg, state0, project, device, args):
    """One row: quality after 6n steps from t = 0, graph and eager marginal
    steps/s, launches per eager step, engine."""
    n = args.steps

    def step(s):
        return simulate_step3(cfg, s, project)

    state = state0
    for _ in range(6 * n):
        state = step(state)
    launches = launches_per_step(step, state, KERNELS)
    times = time_both(step, state0, device, n, n, args.reps, longer=2)
    g, e = times["graph"], times["eager"]
    rec = {**quality3(state), "settings": settings3(6 * n, args.lineTrace),
           "sps": g and g["sps"], "sps_spread": g and g["spread"],
           "sps_mad": g and g["mad"],
           "ms_per_step": g and 1e3 / g["sps"],
           "eager_sps": e["sps"], "eager_spread": e["spread"],
           "eager_mad": e["mad"], "eager_ms_per_step": 1e3 / e["sps"],
           "n": n, "reps": args.reps, "launches_per_step": launches,
           "engine": engine_of(launches, device, "merged"
                               if args.fuseAdvection else "split")}
    sps = f"{g['sps']:8.2f}" if g else "    none"
    log(f"{case:24s} graph {sps} steps/s, eager {e['sps']:8.2f}; "
        f"max|div| {rec['max_div']:.5f} mean|div| {rec['mean_div']:.6f}; "
        f"{rec['engine']}")
    return rec


def rows_of(args, device):
    """{case: (cfg, initial state, project_fn)} of the rows asked for."""
    rows = {}
    if not args.onlyModel:
        cfg, state = plume3d_case(args.res, device, args.jacobiIter,
                                  args.fuseAdvection, args.lineTrace)
        rows[f"jacobi{args.jacobiIter}"] = (cfg, state, None)
        if args.multigrid:
            cfg, state = plume3d_case(args.res, device,
                                      fuse_advection=args.fuseAdvection,
                                      line_trace=args.lineTrace,
                                      sim_method="multigrid", mg_vcycles=2)
            rows["mg2v"] = (cfg, state, None)
    if args.modelDir:
        case = Path(args.modelDir).name
        if args.computeDtype:
            case += f"-{args.computeDtype}"
        rows[case] = learned3d_case(
            args.res, device, args.modelDir,
            fuse_advection=args.fuseAdvection, line_trace=args.lineTrace,
            compute_dtype=args.computeDtype)
    return rows


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--jacobiIter", type=int, default=60)
    ap.add_argument("--modelDir", default=None)
    ap.add_argument("--onlyModel", action="store_true")
    ap.add_argument("--computeDtype", default=None,
                    choices=("bfloat16", "float32"))
    ap.add_argument("--fuseAdvection", action="store_true")
    ap.add_argument("--lineTrace", action="store_true")
    ap.add_argument("--multigrid", action="store_true",
                    help="add bench3d's pallas + multigrid row (mg2v)")
    ap.add_argument("--reference", default=None)
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    return ap.parse_args(argv)


def run_bench3d(args):
    """The rows' table and summary; returns (summary dict, full table
    dict, reference failures or None)."""
    device = resolve_device(args.device)
    card = card_info(device)
    log(f"device: {card or device} | 3-D plume {args.res}^3")
    t0 = time.perf_counter()
    rows = {case: run_row(case, *row, device, args)
            for case, row in rows_of(args, device).items()}
    failures = None
    if args.reference:
        failures = check_reference({args.res: rows},
                                   load_reference(args.reference),
                                   "plume3d", LIMITS3)
    case0 = next(iter(rows))
    out = {"metric": f"plume3d_{args.res}_{case0}_steps_per_sec",
           "value": rounded(rows[case0]["sps"], 2), "unit": "steps/s",
           "device": card or "cpu",
           "weights": "trained" if args.modelDir else None,
           "graph": args.steps if device.type == "cuda" else None,
           "eager_n": args.steps,
           "clock": "cuda events" if device.type == "cuda" else
                    "host (cpu run: no graph, eager only)",
           "fuse_advection": args.fuseAdvection,
           "line_trace": args.lineTrace,
           "reference": (None if failures is None else
                         "pass" if not failures else "FAIL"),
           "rows": {c: {"sps": rounded(r["sps"], 2),
                        "ms_per_step": rounded(r["ms_per_step"], 3),
                        "eager_sps": rounded(r["eager_sps"], 2),
                        "max_div": rounded(r["max_div"], 5),
                        "engine": r["engine"]} for c, r in rows.items()}}
    full = {**out, "res": args.res, "seconds": time.perf_counter() - t0,
            "failures": failures, "table": rows}
    return out, full, failures


def main(argv=None):
    args = parse(argv)
    out, full, failures = run_bench3d(args)
    path = write_table(args.out_dir, "bench3d_torch", full)
    log(f"full table: {path} ({full['seconds']:.1f} s)")
    print(compact({**out, "artifact": path.name}), flush=True)
    if failures:
        raise SystemExit(f"reference check failed: {failures}")


if __name__ == "__main__":
    main()
