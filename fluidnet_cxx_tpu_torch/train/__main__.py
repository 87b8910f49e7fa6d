"""Training entry point, the twin of the JAX package's ``scripts/train.py``:

    python -m fluidnet_cxx_tpu_torch.train --onDevice 200 --res 128
    python -m fluidnet_cxx_tpu_torch.train --onDevice 200 --model PUNet \\
        --punetWidths 96,128,128 --punetDilation 2 --polishSweeps 32
    python -m fluidnet_cxx_tpu_torch.train --synthetic 16 --maxEpochs 2 \\
        [--dataDir DIR] [--modelDir DIR] [--resume]
    python -m fluidnet_cxx_tpu_torch.train --trainConfig configs/train.yaml \\
        --onDevice 200

``--onDevice N`` takes N steps on synthetic batches drawn on the card
(labels from ``--labelIters`` Jacobi sweeps), mixed with plume rollout
frames under ``--plumeFrames``; otherwise it trains by epochs on a
dataset of ``.npz`` scenes (``--synthetic N`` writes N synthetic scenes
first). The second line trains PUNetD2_128's architecture (its damped
"xla" polish differentiated by kernel F's transposed sweeps). The
configuration is the ``--trainConfig`` YAML's, read as the JAX
``scripts/train.py`` reads it (``train_config_from_yaml``, and
``model_config_from_mconf`` and ``sim_config_from_mconf`` of its
``modelParam``), or the defaults without one (``configs/train.yaml``'s
values), with the flags' overrides. Runs on the card unless ``--device
cpu`` is given. Writes ``train_loss.npy`` (and ``val_loss.npy``),
``last_epoch/``, ``best/`` and ``model_config.json`` under ``--modelDir``.
"""
import argparse
import dataclasses
import os
import time

import torch

from ..config import (load_yaml, model_config_from_mconf,
                      sim_config_from_mconf, train_config_from_yaml)
from ..data.dataset import FluidDataset, sample_to_batch
from ..data.synthetic import write_synthetic_dataset
from ..models.fluidnet import FluidNet, make_project_fn
from ..ops.stencils import velocity_divergence
from ..run_plume import resolve_device
from ..sim.scenes import create_plume_scene, plume_config
from ..sim.step import simulate_step
from ..utils.diagnostics import LossLogger
from .checkpoint import load_train_checkpoint, save_train_checkpoint
from .losses import LossTerms
from .trainer import (TrainState, check_trainable, collect_rollout_frames,
                      init_train_state, make_mixed_train_step,
                      make_on_device_train_step, make_optimizer,
                      make_train_step)

LOG_EVERY = 50


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m fluidnet_cxx_tpu_torch.train")
    ap.add_argument("--trainConfig", default=None,
                    help="a YAML training config (configs/train.yaml)")
    ap.add_argument("--dataDir", default=None)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="generate N synthetic scenes into dataDir first")
    ap.add_argument("--modelDir", default="out/model")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--resetOpt", action="store_true",
                    help="on resume, keep params but reinitialise optimizer")
    ap.add_argument("--maxEpochs", type=int, default=None)
    ap.add_argument("--bsz", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--res", type=int, default=128,
                    help="grid size for synthetic data")
    ap.add_argument("--model", default=None,
                    choices=["FluidNet", "ScaleNet", "PUNet"])
    ap.add_argument("--punetWidths", default=None,
                    help="comma-separated PUNet level widths, e.g. 96,128,128")
    ap.add_argument("--punetDilation", type=int, default=None,
                    help="PUNet bottleneck conv dilation")
    ap.add_argument("--polishSweeps", type=int, default=None,
                    help="Jacobi polish sweeps inside the learned projection")
    ap.add_argument("--evalRes", type=int, default=None,
                    help="plume resolution for --evalSelect (default: --res)")
    ap.add_argument("--onDevice", type=int, default=0,
                    help="train N steps with batches generated on the card")
    ap.add_argument("--plumeFrames", type=int, default=0,
                    help="collect N pre-projection plume rollout frames and "
                         "mix them into training")
    ap.add_argument("--synthFrac", type=float, default=0.5,
                    help="fraction of synthetic samples when --plumeFrames")
    ap.add_argument("--pL2", type=float, default=None,
                    help="pressure-matching loss weight")
    ap.add_argument("--labelIters", type=int, default=600,
                    help="Jacobi iterations for on-device labels")
    ap.add_argument("--evalSelect", action="store_true",
                    help="select the best checkpoint by a closed-loop plume "
                         "rollout divergence metric instead of train loss")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def configs(args):
    """(ModelConfig, TrainConfig, SimConfig) of the ``--trainConfig`` YAML
    (the defaults without one) with the flags' overrides, as the JAX
    ``scripts/train.py`` builds them."""
    conf = (load_yaml(args.trainConfig) or {}) if args.trainConfig else {}
    mconf = dict(conf.get("modelParam") or {})
    tc = train_config_from_yaml(conf)
    over = {"max_epochs": args.maxEpochs, "batch_size": args.bsz,
            "lr": args.lr, "p_l2_lambda": args.pL2}
    tc = dataclasses.replace(tc, **{k: v for k, v in over.items()
                                    if v is not None})
    if args.model:
        mconf["model"] = args.model
    if args.polishSweeps is not None:
        mconf["polishSweeps"] = args.polishSweeps
    if args.punetWidths:
        mconf["punetWidths"] = [int(v) for v in args.punetWidths.split(",")]
    if args.punetDilation is not None:
        mconf["punetBottleneckDilation"] = args.punetDilation
    return (model_config_from_mconf(mconf), tc,
            sim_config_from_mconf(mconf))


def mean_terms(terms_list):
    """LossTerms of Python floats: the mean of each term (one sync)."""
    stacked = torch.stack([torch.stack(list(t)) for t in terms_list])
    return LossTerms(*stacked.mean(dim=0).tolist())


def plume_height(density):
    """The highest row whose largest density exceeds 5% of the field's."""
    rho = density[0]
    present = torch.max(rho, dim=1).values > 0.05 * torch.max(rho)
    rows = torch.arange(rho.shape[0], device=rho.device)
    return float(torch.max(torch.where(present, rows, 0)))


def make_eval_rollout(mcfg, res, dev):
    """Closed-loop selection metric of ``--evalSelect``: mean |div| over
    the non-inlet fluid cells after 400 plume steps under the learned
    projection, plus 0.05 x the plume height's relative gap to a
    Jacobi-100 rollout of the same scene (a net that stops the jet scores
    a low divergence on a dead flow). The port's steps run the first-hit
    trace (``use_pallas``), as its entry points do."""
    state0 = create_plume_scene(res, res, density_val=0.1,
                                u_scale=2.0 * res / 128.0, rad=0.145,
                                device=dev)
    fl_mask = (state0.flags == 1) & (state0.U_bc_inv_mask[:, 1] > 0.5)

    def rollout(cfg, project=None):
        s = state0
        with torch.no_grad():
            for _ in range(400):
                s = simulate_step(cfg, s, project)
        return s

    ref = rollout(plume_config(use_pallas=True, line_trace=False,
                               jacobi_iter=100))
    h_ref = plume_height(ref.density)
    print(f"evalSelect: Jacobi-100 reference height {h_ref:.0f}", flush=True)
    cfg_eval = plume_config(sim_method="convnet", use_pallas=True)

    def eval_rollout(model):
        s = rollout(cfg_eval, make_project_fn(mcfg, model.net))
        div = velocity_divergence(s.U, s.flags)
        mean_div = float(torch.sum(torch.abs(div) * fl_mask)
                         / torch.sum(fl_mask))
        return mean_div + 0.05 * abs(plume_height(s.density) - h_ref) / h_ref

    return eval_rollout


def train_on_device(args, mcfg, tc, scfg, dev):
    model = FluidNet(mcfg).to(dev)
    ts = init_train_state(model, tc, seed=0, steps_per_epoch=LOG_EVERY)
    best = float("inf")
    if args.resume:
        ts, _, best = load_train_checkpoint(args.modelDir, ts,
                                            best=args.resetOpt)
        if args.resetOpt:
            ts = TrainState(model, make_optimizer(tc, model, LOG_EVERY))
            best = float("inf")
        print(f"resumed at step {ts.step}", flush=True)
    extra = ()
    if args.plumeFrames:
        print(f"collecting {args.plumeFrames} plume rollout frames at "
              f"{args.res}^2...", flush=True)
        roll_cfg = plume_config(jacobi_iter=200, use_pallas=True,
                                line_trace=False)
        scene = create_plume_scene(args.res, args.res, density_val=0.1,
                                   u_scale=2.0 * args.res / 128.0, rad=0.145,
                                   device=dev)
        frames, frame_p, frame_flags = collect_rollout_frames(
            roll_cfg, scene, args.plumeFrames, stride=4, warmup=50)
        print(f"frames ready: {tuple(frames.shape)}", flush=True)
        step = make_mixed_train_step(model, scfg, tc, frames.shape,
                                     tc.batch_size, args.synthFrac,
                                     args.labelIters, dev)
        # The inlet's clamped cells stay out of the divergence losses.
        frame_div_mask = ((scene.U_bc_inv_mask[:, 1] > 0.5)
                          & (scene.U_bc_inv_mask[:, 0] > 0.5))
        extra = (frames, frame_p, frame_flags, frame_div_mask)
    else:
        step = make_on_device_train_step(model, scfg, tc, args.res, args.res,
                                         tc.batch_size, args.labelIters, dev)
    os.makedirs(args.modelDir, exist_ok=True)
    log = LossLogger(os.path.join(args.modelDir, "train_loss.npy"))
    gen = torch.Generator(device=dev).manual_seed(4321)
    host_gen = torch.Generator().manual_seed(4321)
    eval_rollout = (make_eval_rollout(mcfg, args.evalRes or args.res, dev)
                    if args.evalSelect else None)
    t0, window = time.time(), []
    for i in range(1, args.onDevice + 1):
        ts, terms = step(ts, gen, host_gen, *extra)
        window.append(terms)
        if i % LOG_EVERY and i < args.onDevice:
            continue
        mean = mean_terms(window)
        log.append(ts.step, mean)
        log.save()
        metric = (eval_rollout(model) if eval_rollout is not None
                  else mean.total)
        is_best = metric < best
        best = min(best, metric)
        save_train_checkpoint(args.modelDir, ts, ts.step, best, mcfg,
                              is_best=is_best)
        print(f"step {ts.step} ({i}/{args.onDevice}): loss {mean.total:.5f} "
              f"(divL2 {mean.div_l2:.5f} divLT {mean.div_lt:.5f}) metric "
              f"{metric:.6f}{' *best*' if is_best else ''} "
              f"{len(window) / (time.time() - t0):.2f} steps/s", flush=True)
        t0, window = time.time(), []


def train_dataset(args, mcfg, tc, scfg, dev):
    data_dir = args.dataDir or os.path.join(args.modelDir, "data")
    if args.synthetic:
        print(f"generating {args.synthetic} synthetic scenes...", flush=True)
        write_synthetic_dataset(os.path.join(data_dir, "tr"), args.synthetic,
                                steps_per_scene=8, h=args.res, w=args.res,
                                device=dev)
        write_synthetic_dataset(os.path.join(data_dir, "te"),
                                max(args.synthetic // 4, 1),
                                steps_per_scene=8, h=args.res, w=args.res,
                                seed=999, device=dev)
    tr = FluidDataset(data_dir, "tr")
    te = FluidDataset(data_dir, "te")
    steps_per_epoch = len(tr) // tc.batch_size
    print(f"train {len(tr)} frames, val {len(te)} frames, "
          f"{steps_per_epoch} steps/epoch", flush=True)
    model = FluidNet(mcfg).to(dev)
    ts = init_train_state(model, tc, seed=0, steps_per_epoch=steps_per_epoch)
    epoch0, best = 0, float("inf")
    if args.resume:
        ts, epoch0, best = load_train_checkpoint(args.modelDir, ts)
        print(f"resumed at epoch {epoch0}, step {ts.step}, best "
              f"{best:.5f}", flush=True)
    train_step, eval_step = make_train_step(model, scfg, tc)
    os.makedirs(args.modelDir, exist_ok=True)
    tr_log = LossLogger(os.path.join(args.modelDir, "train_loss.npy"))
    va_log = LossLogger(os.path.join(args.modelDir, "val_loss.npy"))
    host_gen = torch.Generator().manual_seed(1234)
    for epoch in range(epoch0 + 1, tc.max_epochs + 1):
        t0 = time.time()
        tr_terms = [train_step(ts, sample_to_batch(b, dev), host_gen)[1]
                    for b in tr.batches(tc.batch_size, shuffle=True,
                                        seed=epoch)]
        va_terms = [eval_step(ts, sample_to_batch(b, dev), host_gen)
                    for b in te.batches(tc.batch_size, shuffle=False,
                                        drop_last=False)]
        trm, vam = mean_terms(tr_terms), mean_terms(va_terms)
        tr_log.append(epoch, trm)
        va_log.append(epoch, vam)
        tr_log.save()
        va_log.save()
        is_best = vam.total < best
        best = min(best, vam.total)
        save_train_checkpoint(args.modelDir, ts, epoch, best, mcfg,
                              is_best=is_best)
        print(f"epoch {epoch}/{tc.max_epochs} (step {ts.step}): train "
              f"{trm.total:.5f} val {vam.total:.5f}"
              f"{' *best*' if is_best else ''} ({time.time() - t0:.1f}s)",
              flush=True)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mcfg, tc, scfg = configs(args)
    if args.trainConfig:
        print(f"{args.trainConfig}: {tc}\n{mcfg}\n{scfg}", flush=True)
    check_trainable(mcfg, dev)
    if args.onDevice:
        train_on_device(args, mcfg, tc, scfg, dev)
    else:
        train_dataset(args, mcfg, tc, scfg, dev)


if __name__ == "__main__":
    main()
