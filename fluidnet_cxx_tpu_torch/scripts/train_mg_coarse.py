"""Train the learned coarse-grid correction of the ``mg_learned``
projection (MGCoarseNet), the twin of the JAX package's
``scripts/train_mg_coarse.py``:

    python -m fluidnet_cxx_tpu_torch.scripts.train_mg_coarse [--res 512]
        [--frames 256] [--stride 2] [--warmup 50] [--synthFrac 0.3]
        [--steps 2000] [--bsz 16] [--lr 2e-3] [--labelCycles 8]
        [--coarseSize 128] [--modelDir trained_models/MGCoarse_128]
        [--evalEvery 250] [--device cuda] [--seed 0]

Data (``collect_buffer``): pre-projection frames of a ``--res`` plume under
multigrid (2 V-cycles, no line trace; ``--warmup`` steps first, then a
frame every ``--stride`` steps), each conditioned as the step conditions
its projection's input (walls, inlet values, divergence) and pushed down
the V-cycle's pre-smooth/restrict leg to the cut (``mg_cut_rhs``); a
``--synthFrac`` share of synthetic fields (smooth noise and Gaussian bumps
on random obstacles) down the same leg. Labels: ``--labelCycles``
V-cycles at the cut, 16 problems a solve. The step: MGCoarseNet in
bfloat16, as the flax net trains, its weights packed from the live
parameters on every step; the loss, the mean over the batch of the
relative squared error of the correction on the continuation cells; Adam
with optax's defaults under optax's cosine decay to 5% of ``--lr`` over
``--steps``. Every ``--evalEvery`` steps (and at the last) the max and mean
|div| after one learned V-cycle on held-out fine frames beside plain MG
with 1 and 2 V-cycles (``eval_params``), and a checkpoint
(``models/mg_coarse.py::save_mg_coarse``) whose dir ``run_plume
--simMethod mg_learned --modelDir DIR`` runs. The printed lines are the
JAX script's.

On the card the frames' steps run kernels A and H, the cut's leg is torch
glue (as JAX's is XLA), the labels and the eval's V-cycles kernel G, the
net's convs kernel B's bfloat16 route and their backward
``fn_conv2d_bf16_dgrad``, ``fn_conv2d_bf16_wgrad`` and
``fn_bias_grad_bf16``.

Differences from the JAX script: the weights start from flax's
initialisation drawn with numpy from ``--seed`` (``init_mg_coarse_params``)
and the synthetic fields from a ``torch.Generator`` seeded with it, not
from JAX's keys (the batches' indices come from numpy's generator of
``--seed``, JAX's of 0: the same at the default); the frames' leg goes
down to the ``--coarseSize`` cut, where JAX's goes to its default 128 cut
(the same at the default; at ``--res`` 128 or less JAX's has no level
below the finest); and ``--device`` (cuda by default; ``cpu`` runs the
plain versions).
"""
import argparse
import math
import time

import numpy as np
import torch

from ..celltype import FLUID
from ..data.synthetic import _bumps, _random_obstacles, _smooth_noise
from ..models.mg_coarse import (MGCoarseConfig, MGCoarseNet, _cont,
                                init_mg_coarse_params,
                                make_project_fn_mg_learned, save_mg_coarse)
from ..ops.kernels.mg import solve_mg
from ..ops.kernels.punet import pack_weights
from ..ops.multigrid import mg_cut_rhs
from ..ops.stencils import set_wall_bcs, velocity_divergence, velocity_update
from ..run_plume import resolve_device
from ..sim.scenes import create_plume_scene, plume_config
from ..sim.step import apply_const_vals, simulate_step

LABEL_BATCH = 16
ALPHA = 0.05   # optax.cosine_decay_schedule's alpha in the JAX script


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--synthFrac", type=float, default=0.3)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--bsz", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--labelCycles", type=int, default=8)
    ap.add_argument("--coarseSize", type=int, default=128)
    ap.add_argument("--modelDir", default="trained_models/MGCoarse_128")
    ap.add_argument("--evalEvery", type=int, default=250)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of the initial weights and of the "
                         "batches' indices, seed of the synthetic fields' "
                         "generator")
    return ap.parse_args(argv)


def frames_config():
    """The collector's step: the plume under multigrid, 2 V-cycles, no
    line trace (the port's kernels: ``use_pallas``)."""
    return plume_config(sim_method="multigrid", mg_vcycles=2,
                        line_trace=False, use_pallas=True)


def condition(d):
    """(U, div) of the divergent state ``d``, conditioned as the step
    conditions its projection's input: walls, then the inlet values."""
    U = set_wall_bcs(d.U, d.flags)
    U, _ = apply_const_vals(d, U, d.density)
    return U, velocity_divergence(U, d.flags)


@torch.no_grad()
def plume_frame(cfg, state, stride: int, coarse_size: int):
    """``stride`` steps, then the pre-projection frame of the next step:
    (the state after that step, flags_c, rhs_c at the ``coarse_size``
    cut, the conditioned U)."""
    for _ in range(stride):
        state = simulate_step(cfg, state)
    U, div = condition(simulate_step(cfg, state, output_div=True))
    fc, rc = mg_cut_rhs(state.flags, div, coarse_size)
    return simulate_step(cfg, state), fc, rc, U


def synth_fields(gen, res: int, dev):
    """(u, v, flags) of one synthetic frame drawn from ``gen``: smooth
    noise plus Gaussian bumps, each times 3, on random obstacles."""
    def comp():
        return (_smooth_noise(gen, 1, res, res, dev) * 3.0
                + _bumps(gen, 1, res, res, dev) * 3.0)
    u, v = comp(), comp()
    return u, v, _random_obstacles(gen, 1, res, res, dev)


@torch.no_grad()
def synth_frame(u, v, flags, coarse_size: int):
    """(flags_c, rhs_c, flags, U) of a synthetic frame: walls, divergence,
    the leg to the ``coarse_size`` cut."""
    U = set_wall_bcs(torch.stack([u, v], dim=1), flags)
    fc, rc = mg_cut_rhs(flags, velocity_divergence(U, flags), coarse_size)
    return fc, rc, flags, U


def collect_buffer(res, n_frames, stride, warmup, synth_frac, seed=0,
                   device="cpu", coarse_size: int = 128):
    """(flags_c (N, hc, wc), rhs_c, the held-out fine frames [(flags,
    U_pre)]) on ``device``: the plume's frames, then the synthetic ones,
    at the ``coarse_size`` cut."""
    cfg = frames_config()
    state = create_plume_scene(res, res, density_val=0.1,
                               u_scale=8.0 * res / 512.0, rad=0.145,
                               device=device)
    with torch.no_grad():
        for _ in range(warmup):
            state = simulate_step(cfg, state)
    flags_cs, rhs_cs, eval_fine = [], [], []
    n_plume = int(n_frames * (1 - synth_frac))
    t0 = time.time()
    for i in range(n_plume):
        state, fc, rc, U_pre = plume_frame(cfg, state, stride, coarse_size)
        flags_cs.append(fc[0])
        rhs_cs.append(rc[0])
        if i % max(n_plume // 8, 1) == 0:
            eval_fine.append((state.flags, U_pre))
            print(f"  plume frame {i}/{n_plume} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    n_synth = n_frames - n_plume
    gen = torch.Generator(device=device).manual_seed(seed + 77)
    for i in range(n_synth):
        fc, rc, flags_f, U_f = synth_frame(*synth_fields(gen, res, device),
                                           coarse_size)
        flags_cs.append(fc[0])
        rhs_cs.append(rc[0])
        if i % max(n_synth // 3, 1) == 0:
            eval_fine.append((flags_f, U_f))
    print(f"buffer: {len(rhs_cs)} coarse problems, "
          f"{len(eval_fine)} fine eval frames ({time.time()-t0:.0f}s)",
          flush=True)
    return torch.stack(flags_cs), torch.stack(rhs_cs), eval_fine


@torch.no_grad()
def make_labels(flags_c, rhs_c, cycles: int):
    """The converged coarse solves: ``cycles`` V-cycles, LABEL_BATCH
    problems a solve."""
    return torch.cat([solve_mg(flags_c[i:i + LABEL_BATCH],
                               rhs_c[i:i + LABEL_BATCH], n_vcycles=cycles)
                      for i in range(0, len(rhs_c), LABEL_BATCH)])


def coarse_loss(model, packed, fc, rc, e_star):
    """The JAX script's loss: the batch mean of sum((e - e*)^2) / (sum(e*^2)
    + 1e-12) over the continuation cells."""
    e = model(fc, rc, packed)
    cont = _cont(fc)
    num = torch.sum((e - e_star) ** 2 * cont, dim=(1, 2))
    den = torch.sum(e_star ** 2 * cont, dim=(1, 2)) + 1e-12
    return torch.mean(num / den)


def cosine_lr(lr: float, steps: int, t: int, alpha: float = ALPHA) -> float:
    """optax.cosine_decay_schedule(lr, steps, alpha) at update ``t`` (0 at
    the first): lr * ((1 - alpha) * (1 + cos(pi * min(t, steps) / steps))
    / 2 + alpha)."""
    frac = min(t, steps) / steps
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)


def make_train_step(model, opt, lr: float, steps: int):
    """``step(fc, rc, e_star) -> loss`` (a tensor, no host sync): the
    weights packed from the live parameters, the loss, its gradient, the
    schedule's learning rate of this update, one Adam update."""
    t = [0]

    def step(fc, rc, e_star):
        opt.zero_grad(set_to_none=True)
        loss = coarse_loss(model, pack_weights(model.punet), fc, rc, e_star)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = cosine_lr(lr, steps, t[0])
        opt.step()
        t[0] += 1
        return loss.detach()

    return step


def make_optimizer(params, lr: float):
    """Adam over ``params`` with optax's defaults (b1 0.9, b2 0.999, eps
    1e-8)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def eval_params(model, eval_fine, coarse_size: int):
    """{"learned1v", "mg1v", "mg2v": (max, mean) |div| over the fluid
    cells} after one learned V-cycle (``make_project_fn_mg_learned``,
    rebuilt here since it packs the weights once) and after plain MG with
    1 and 2 V-cycles, on the held-out fine frames."""
    project = make_project_fn_mg_learned(model, coarse_size=coarse_size)
    rows = {"learned1v": [], "mg1v": [], "mg2v": []}
    for flags_f, U_f in eval_fine:
        _, U_l = project(None, U_f, flags_f, None)
        rows["learned1v"].append(velocity_divergence(U_l, flags_f))
        div = velocity_divergence(U_f, flags_f)
        for name, nv in (("mg1v", 1), ("mg2v", 2)):
            p = solve_mg(flags_f, div, n_vcycles=nv)
            U_p = set_wall_bcs(velocity_update(p, U_f, flags_f), flags_f)
            rows[name].append(velocity_divergence(U_p, flags_f))
    m = torch.cat([f == FLUID for f, _ in eval_fine])
    out = {}
    for name, divs in rows.items():
        d = torch.cat(divs).abs()
        out[name] = (float(torch.where(m, d, 0.0).max()),
                     float(torch.sum(d * m) / torch.sum(m)))
    return out


def main(argv=None):
    """Run the training; returns {"losses": every step's loss, "evals":
    [(step, eval_params' rows)], "steps", "ms_per_step" (the steps'
    mean, evals included)}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    flags_c, rhs_c, eval_fine = collect_buffer(
        args.res, args.frames, args.stride, args.warmup, args.synthFrac,
        args.seed, dev, args.coarseSize)
    hc, wc = rhs_c.shape[1:]
    print(f"coarse problems at {hc}x{wc}")
    labels = make_labels(flags_c, rhs_c, args.labelCycles)
    print("labels done", flush=True)

    cfg = MGCoarseConfig()
    model = init_mg_coarse_params(MGCoarseNet(cfg).to(dev), args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"MGCoarseNet params: {n_params/1e3:.1f}k")
    opt = make_optimizer(model.parameters(), args.lr)
    step_fn = make_train_step(model, opt, args.lr, args.steps)

    rng = np.random.default_rng(args.seed)
    best = float("inf")
    losses, evals = [], []
    t0 = t_start = time.time()
    for step in range(1, args.steps + 1):
        idx = torch.from_numpy(rng.integers(0, len(rhs_c), args.bsz)).to(dev)
        losses.append(step_fn(flags_c[idx], rhs_c[idx], labels[idx]))
        if step % args.evalEvery == 0 or step == args.steps:
            ev = eval_params(model, eval_fine, args.coarseSize)
            metric = ev["learned1v"][1]
            is_best = metric < best
            best = min(best, metric)
            save_mg_coarse(args.modelDir, cfg, model, opt, step, best,
                           is_best=is_best)
            evals.append((step, ev))
            print(
                f"step {step}: loss {float(losses[-1]):.4f} | post-proj div "
                f"(max/mean) learned1v {ev['learned1v'][0]:.4f}/"
                f"{ev['learned1v'][1]:.6f}  mg1v {ev['mg1v'][0]:.4f}/"
                f"{ev['mg1v'][1]:.6f}  mg2v {ev['mg2v'][0]:.4f}/"
                f"{ev['mg2v'][1]:.6f}"
                f"{' *best*' if is_best else ''} "
                f"({time.time()-t0:.0f}s)", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.time() - t_start
    return {"losses": torch.stack(losses).cpu().tolist(), "evals": evals,
            "steps": args.steps,
            "ms_per_step": 1e3 * elapsed / max(args.steps, 1)}


if __name__ == "__main__":
    main()
