"""The port's main-path bench: the 2-D buoyant plume of the JAX package's
``bench.py`` on the card, through the hand-written kernels.

    python -m fluidnet_cxx_tpu_torch.bench
    python -m fluidnet_cxx_tpu_torch.bench \\
        --reference fluidnet_cxx_tpu_torch/bench_reference.json
    python -m fluidnet_cxx_tpu_torch.bench --device cpu --res 32 \\
        --cases jacobi28 --small-steps 4 --chunk 2 --n-eager 2 --reps 1

Cases, as ``bench.py``: cnn (the trained PUNetD2_128; kernels A, B, C),
jacobi28/100/200 (A, F) and mg2 (two warm V-cycles; A, H), at 512^2 then
128^2, on ``run_plume.plume_case``'s scene (dt 0.1, ``max_disp`` 4, the
first-hit trace, merged advection, inlet speed 2*res/128, radius 0.145).
``--max-disp``, ``--no-line-trace`` and ``--no-fuse-advection`` (kernels
D and E in place of A) are bench.py's BENCH_MAX_DISP, BENCH_LINE_TRACE and
BENCH_FUSE_ADV; ``--steps`` and ``--n-time`` its BENCH_STEPS and
BENCH_NTIME.

Quality, as bench.py's run_case: roll from t = 0 in chunks of ``--chunk``
(100) steps, ``--steps`` (300) at 512^2 and ``--small-steps`` (400) below;
after each chunk mean|div| and max|div| over the fluid cells outside the
inlet rows and the plume height (``run_plume.quality``). The columns leave
the first chunk out: the mean of the means, the max of the maxes, the last
height.

Speed: marginal steps/s, 3n / (t(4n) - t(n)) by CUDA events, the median of
``--reps`` runs (3 at 512^2, 5 below) with their spread and MAD, timed two
ways. ``sps`` replays one step captured in a CUDA graph that copies its
outputs back into its inputs: no host work a step, as bench.py's
jit-scanned chunks; n is ``--n-time`` (200 at 512^2, 2000 below).
``eager_sps`` runs the Python step, and so shows the host's cost; n is
``--n-eager`` (100 at 512^2, 200 below). Launches per step are read from
an eager step: a replay launches through no wrapper.

Projection: ``proj_ms`` is the device time of the cnn case's whole
projection (the input's assembly, B, its split-K reduces and C) at the
first resolution run, captured in a CUDA graph, on the rollout's last
state; ``proj_mfu`` is the forward's
FLOPs (two a multiply-add, counted from the shapes the forward hands its
convs) over proj_ms over the H100 SXM dense TF32 tensor-core peak, 494.7
TFLOP/s (B's products run on TF32 tensor cores).

``--reference`` holds each case's columns to the JAX package's
(``scripts/torch_bench_reference.py``): mean|div| and max|div| within 1%
relative, the height within 1 row. A case with no reference row at the
same settings fails. The last line printed is one JSON object of at most
1.5 KB; the full table goes to ``--out-dir``/bench_torch_<time>.json. The
bench exits non-zero if a case raises or misses its reference. With
``--device cpu`` the plain versions run, the times are the host clock's
and nothing is captured (``"graph": null``).
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from .config import load_model_config
from .models.punet import PUNet
from .ops.kernels import advect, jacobi, mg, proj_tail, punet
from .run_plume import MODEL_DIR, plume_case, quality, resolve_device
from .sim.step import simulate_step

HERE = Path(__file__).resolve().parent
REFERENCE = HERE / "bench_reference.json"
OUT_DIR = HERE.parent / "out"
TF32_PEAK = 494.7e12
PEAK_NAME = "H100 SXM dense TF32 tensor cores, 494.7 TFLOP/s"
CASES = {"cnn": dict(sim_method="convnet"),
         "jacobi28": dict(sim_method="jacobi", jacobi_iter=28),
         "jacobi100": dict(sim_method="jacobi", jacobi_iter=100),
         "jacobi200": dict(sim_method="jacobi", jacobi_iter=200),
         "mg2": dict(sim_method="multigrid", mg_vcycles=2)}
# The 2-D kernels, by their letter in the kernel table.
KERNELS = {"A": advect.advect_all, "B": punet.conv2d_nhwc,
           "C": proj_tail.project_tail, "D": advect.advect_scalar,
           "E": advect.advect_velocity, "F": jacobi.solve_jacobi,
           "G": mg.solve_mg, "H": mg.project_mg}
# column -> (kind, limit) of the --reference check.
LIMITS = {"mean_div": ("relative", 0.01), "max_div": ("relative", 0.01),
          "height": ("rows", 1)}
LINE_BYTES = 1500


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_info(device):
    """``nvidia-smi``'s "name, power.limit" of the card, None on the CPU."""
    if device.type != "cuda":
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


class Clock:
    """Milliseconds of a callable: CUDA events on the card, the host clock
    on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def ms(self, fn):
        if not self.cuda:
            t0 = time.perf_counter()
            fn()
            return 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)


def marginal(clock, run, n, reps, longer=4):
    """Marginal steps/s of ``run(k)`` (k steps): (longer - 1) n / (t(longer
    n) - t(n)) after one warm-up run, the median over ``reps`` runs, their
    relative spread and MAD, n and reps."""
    run(n)
    rates = []
    for _ in range(reps):
        ta = clock.ms(lambda: run(n))
        tb = clock.ms(lambda: run(longer * n))
        rates.append(1e3 * (longer - 1) * n / max(tb - ta, 1e-9))
    rates.sort()
    med = rates[len(rates) // 2]
    return {"sps": med, "spread": (rates[-1] - rates[0]) / med,
            "mad": statistics.median(abs(r - med) for r in rates) / med,
            "n": n, "reps": reps}


class EagerRun:
    """``run(k)`` advances a state by k Python steps."""

    def __init__(self, step, state):
        self.step, self.state = step, state

    def run(self, k):
        for _ in range(k):
            self.state = self.step(self.state)


class GraphRun:
    """One step captured in a CUDA graph over static copies of the state's
    evolving ``fields``; the graph copies the step's outputs back into
    them, so ``run(k)`` (k replays) advances the state by k steps. The
    kernels are built and the planners' caches filled by two warm-up steps
    on a side stream before the capture."""

    def __init__(self, step, state, fields=("p", "U", "density")):
        self.state = state._replace(
            **{f: getattr(state, f).clone() for f in fields})

        def once():
            out = step(self.state)
            for f in fields:
                getattr(self.state, f).copy_(getattr(out, f))

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                once()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            once()

    def run(self, k):
        for _ in range(k):
            self.graph.replay()


def launches_per_step(step, state, kernels):
    """Launches of each kernel in one eager step of ``state`` (letters
    whose counter moved)."""
    before = {k: fn.launches for k, fn in kernels.items()}
    step(state)
    return {k: fn.launches - before[k] for k, fn in kernels.items()
            if fn.launches > before[k]}


def engine_of(launches, device, adv):
    """A row's engine: the kernels one eager step launched (hand-cuda) or
    the plain versions (plain-cpu), and the advection's form."""
    kind = f"hand-cuda:{''.join(sorted(launches))}" if device.type == \
        "cuda" else "plain-cpu"
    return f"{kind}/adv={adv}"


def rollout_chunks(step, state, steps, chunk, stats_of):
    """``max(steps // chunk, 1)`` chunks of ``chunk`` steps from ``state``
    with ``stats_of(state)`` after each. Returns (last state, stats)."""
    out = []
    for _ in range(max(steps // chunk, 1)):
        for _ in range(chunk):
            state = step(state)
        out.append(stats_of(state))
    return state, out


def reduce_chunks(chunks):
    """bench.py's columns: the first chunk left out when there are more,
    the mean of the means, the max of the maxes, the last height."""
    kept = chunks[1:] if len(chunks) > 1 else chunks
    return {"mean_div": statistics.fmean(c["mean_div"] for c in kept),
            "max_div": max(c["max_div"] for c in kept),
            "height": chunks[-1]["height"]}


def settings(case, steps, chunk, max_disp, line_trace):
    """The settings a row's quality depends on; a reference row counts
    only at equal settings (``scripts/torch_bench_reference.py::
    settings2d``). Merged and separate advection compute the same fields,
    so the advection's form is not among them."""
    return {"steps": steps, "chunk": chunk, "max_disp": max_disp,
            "line_trace": line_trace,
            "weights": "trained" if case == "cnn" else None}


def time_both(step, state, device, n_graph, n_eager, reps, longer=4):
    """{"graph": marginal of the captured step (None off the card),
    "eager": marginal of the Python step}."""
    clock = Clock(device)
    graph = None
    if device.type == "cuda":
        g = GraphRun(step, state)
        graph = marginal(clock, g.run, n_graph, reps, longer)
        del g
    eager = marginal(clock, EagerRun(step, state).run, n_eager, reps, longer)
    return {"graph": graph, "eager": eager}


def defaults(res, args):
    """(rollout steps, graph n, eager n, reps) at ``res``."""
    big = res >= 512
    return ((args.steps if big else args.small_steps),
            args.n_time or (200 if big else 2000),
            args.n_eager or (100 if big else 200),
            args.reps or (3 if big else 5))


def case_setup(name, res, device, max_disp=4, line_trace=True,
               fuse_advection=True):
    """(step, initial state, project_fn) of case ``name`` at ``res``: the
    plume scene and config of ``run_plume.plume_case``, the trained weights
    for cnn; project_fn is None for the classical cases."""
    cfg, state0, project = plume_case(
        res, device, max_disp=max_disp, line_trace=line_trace,
        fuse_advection=fuse_advection, **CASES[name])

    def step(s):
        return simulate_step(cfg, s, project)

    return step, state0, project


@torch.no_grad()
def run_case(name, res, device, args):
    """One case at ``res``: its quality columns over the rollout, its graph
    and eager marginal steps/s, launches per eager step and engine.
    Returns (record, the rollout's last state, its project_fn)."""
    steps, n_graph, n_eager, reps = defaults(res, args)
    step, state0, project = case_setup(name, res, device, args.max_disp,
                                       args.line_trace, args.fuse_advection)
    last, chunks = rollout_chunks(step, state0, steps, args.chunk, quality)
    launches = launches_per_step(step, last, KERNELS)
    times = time_both(step, state0, device, n_graph, n_eager, reps)
    g, e = times["graph"], times["eager"]
    rec = {**reduce_chunks(chunks), "chunks": chunks,
           "settings": settings(name, steps, args.chunk, args.max_disp,
                                args.line_trace),
           "sps": g and g["sps"], "sps_spread": g and g["spread"],
           "sps_mad": g and g["mad"], "n_graph": g and g["n"],
           "eager_sps": e["sps"], "eager_spread": e["spread"],
           "eager_mad": e["mad"], "n_eager": e["n"], "reps": e["reps"],
           "launches_per_step": launches,
           "engine": engine_of(launches, device, "merged"
                               if args.fuse_advection else "split")}
    sps = f"{g['sps']:9.1f}" if g else "     none"
    log(f"{res}^2 {name:10s} graph {sps} steps/s, eager {e['sps']:8.1f}; "
        f"mean|div| {rec['mean_div']:.6f} max|div| {rec['max_div']:.5f} "
        f"height {rec['height']}; {rec['engine']}")
    return rec, last, project


def punet_flops(net, x):
    """FLOPs (two a multiply-add) of one PUNet forward of NHWC ``x``: each
    layer's output cells times k*k*c_in*c_out, from the shapes the forward
    hands its convolutions (run on zeros, no arithmetic)."""
    total = 0

    def conv(name, h, x2=None, relu=True, in_scale=None, scale_mod=1):
        nonlocal total
        k, stride, _ = net.geometry[name]
        ci = h.shape[-1] + (0 if x2 is None else x2.shape[-1])
        co = net.convs[name].out_channels
        b, hi, wi = h.shape[:3]
        ho, wo = -(-hi // stride), -(-wi // stride)
        total += 2 * b * ho * wo * k * k * ci * co
        return h.new_zeros((b, ho, wo, co))

    net(x, conv=conv)
    return total


@torch.no_grad()
def projection_share(state, project, reps=20):
    """(proj_ms, FLOPs, proj_mfu) of the cnn projection on ``state``:
    ``reps`` calls captured in one CUDA graph, replayed once between CUDA
    events (after a warm-up call and replay)."""
    res = state.flags.shape[-1]
    net = PUNet.from_config(load_model_config(str(MODEL_DIR)))
    flops = punet_flops(net, torch.zeros((1, res, res, 2)))

    def call():
        project(state.p, state.U, state.flags, state.density,
                U_bc=state.U_bc, U_bc_inv_mask=state.U_bc_inv_mask)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    graph.replay()
    ms = Clock(state.U.device).ms(graph.replay) / reps
    return ms, flops, flops / (ms * 1e-3) / TF32_PEAK


def check_reference(table, ref, kind="plume2d", limits=None):
    """Hold each row of ``table`` ({res: {case: record}}) to ``ref[kind]``
    at equal settings; prints each delta beside its limit. Returns the
    list of failures (empty when every row passes)."""
    limits = limits or LIMITS
    failures = []
    for res, rows in table.items():
        for case, rec in rows.items():
            want = ref.get(kind, {}).get(str(res), {}).get(case)
            label = f"{kind} {res} {case}"
            if want is None or want.get("settings") != rec["settings"]:
                print(f"reference {label}: no row at settings "
                      f"{rec['settings']}", flush=True)
                failures.append(f"{label}: no reference row")
                continue
            for col, (how, lim) in limits.items():
                got, exp = rec[col], want[col]
                delta = (abs(got - exp) / abs(exp) if how == "relative"
                         else abs(got - exp))
                ok = delta <= lim
                print(f"reference {label} {col}: {got:.6g} against "
                      f"{exp:.6g}, delta {delta:.3g} ({how}) limit {lim} "
                      f"{'ok' if ok else 'OUT'}", flush=True)
                if not ok:
                    failures.append(f"{label} {col}")
    return failures


def load_reference(path):
    with open(path) as f:
        return json.load(f)


def compact(out, limit=LINE_BYTES):
    """The one-line summary, the per-case dicts dropped last first until it
    fits in ``limit`` bytes."""
    line = json.dumps(out, separators=(",", ":"))
    for key in [k for k in out if k.startswith(("maxdiv_", "eager_"))][::-1]:
        if len(line) <= limit:
            break
        out = {k: v for k, v in out.items() if k != key}
        line = json.dumps(out, separators=(",", ":"))
    if len(line) > limit:
        raise ValueError(f"summary line of {len(line)} bytes: {line}")
    return line


def rounded(x, digits):
    return None if x is None else round(x, digits)


def write_table(out_dir, stem, table):
    """The full table as ``<out_dir>/<stem>_<time>.json``; returns its
    path."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / time.strftime(f"{stem}_%Y%m%d_%H%M%S.json")
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    return path


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, nargs="+", default=[512, 128])
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=list(CASES))
    ap.add_argument("--steps", type=int, default=300,
                    help="the rollout at 512^2 and above")
    ap.add_argument("--small-steps", type=int, default=400,
                    help="the rollout below 512^2")
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--max-disp", type=int, default=4)
    ap.add_argument("--no-line-trace", dest="line_trace",
                    action="store_false")
    ap.add_argument("--no-fuse-advection", dest="fuse_advection",
                    action="store_false")
    ap.add_argument("--n-time", type=int, default=None,
                    help="graph-replay n (200 at 512^2, 2000 below)")
    ap.add_argument("--n-eager", type=int, default=None,
                    help="eager n (100 at 512^2, 200 below)")
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--reference", default=None)
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    return ap.parse_args(argv)


def run_bench(args):
    """The bench's table, projection share and summary; returns (summary
    dict, full table dict, reference failures or None)."""
    device = resolve_device(args.device)
    card = card_info(device)
    log(f"device: {card or device}")
    t0 = time.perf_counter()
    table, proj = {}, None
    for res in args.res:
        table[res] = {}
        for name in args.cases:
            rec, last, project = run_case(name, res, device, args)
            table[res][name] = rec
            if project is not None and proj is None and \
                    device.type == "cuda":
                ms, flops, mfu = projection_share(last, project)
                proj = {"proj_res": res, "proj_ms": ms, "flops": flops,
                        "proj_mfu": mfu}
                log(f"projection at {res}^2: {ms:.4f} ms, "
                    f"{flops / 1e9:.3f} GFLOP, {100 * mfu:.2f}% of the "
                    f"{PEAK_NAME}")
    failures = None
    if args.reference:
        failures = check_reference(table, load_reference(args.reference))
    res0, case0 = args.res[0], args.cases[0]
    head = table[res0][case0]
    out = {"metric": f"plume_{res0}_{case0}_steps_per_sec",
           "value": rounded(head["sps"], 1), "unit": "steps/s",
           "device": card or "cpu",
           "weights": "trained" if "cnn" in args.cases else None,
           "graph": ({str(r): table[r][case0]["n_graph"] for r in table}
                     if device.type == "cuda" else None),
           "eager_n": {str(r): table[r][case0]["n_eager"] for r in table},
           "clock": "cuda events" if device.type == "cuda" else
                    "host (cpu run: no graph, eager only)",
           "proj_ms": rounded(proj and proj["proj_ms"], 4),
           "proj_mfu": rounded(proj and proj["proj_mfu"], 4),
           "peak": PEAK_NAME if proj else None,
           "max_disp": args.max_disp, "line_trace": args.line_trace,
           "engine": {c: table[res0][c]["engine"] for c in args.cases},
           "reference": (None if failures is None else
                         "pass" if not failures else "FAIL")}
    for r, rows in table.items():
        out[f"sps_{r}"] = {c: rounded(v["sps"], 1) for c, v in rows.items()}
        out[f"eager_{r}"] = {c: rounded(v["eager_sps"], 1)
                             for c, v in rows.items()}
        out[f"maxdiv_{r}"] = {c: rounded(v["max_div"], 5)
                              for c, v in rows.items()}
    full = {**out, "seconds": time.perf_counter() - t0,
            "projection": proj, "failures": failures,
            "table": {str(r): rows for r, rows in table.items()}}
    return out, full, failures


def main(argv=None):
    args = parse(argv)
    out, full, failures = run_bench(args)
    path = write_table(args.out_dir, "bench_torch", full)
    log(f"full table: {path} ({full['seconds']:.1f} s)")
    print(compact({**out, "artifact": path.name}), flush=True)
    if failures:
        raise SystemExit(f"reference check failed: {failures}")


if __name__ == "__main__":
    main()
