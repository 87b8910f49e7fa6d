"""Train the learned 3-D projection (PUNet3), the twin of the JAX
package's ``scripts/train3d.py``:

    python -m fluidnet_cxx_tpu_torch.scripts.train3d [--steps N]
        [--res 32] [--bsz 4] [--labelIters 400] [--polishSweeps 8]
        [--lr 2e-4] [--patch 4] [--plumeFrames N] [--synthFrac 0.5]
        [--modelDir DIR] [--device cuda] [--seed 0]

The same model (FluidNet3 on the flax path: PUNet3 with widths 96/128,
two bottleneck convs, bfloat16, the "xla" polish of ``--polishSweeps``
damped sweeps, input normalised by the std of U), loss (the mean squared
divergence of the projection) and plain Adam, on synthetic batches drawn
on the device (``data/synthetic3.py``, labelled by ``--labelIters``
Jacobi sweeps); with ``--plumeFrames`` N pre-projection frames of the
3-D plume (JAX's roll config: dt 0.25, Jacobi-200, buoyancy 0.5, gravity
(0, -1, 0), no trace, max_disp 2) mixed in, ``--synthFrac`` synthetic.
Steps run in chunks of 5; every 50 steps (and at the end) it prints the
mean loss of the last chunk and saves ``<modelDir>/last_epoch`` (and
``best/``, with ``torch_state_dict.pt`` and ``model_config.json``, so that
``python -m fluidnet_cxx_tpu_torch.run_plume3d --sim-method convnet
--model-dir DIR`` runs what was trained); the last line is the final
parameters' mean|div| on a fresh batch of 2 beside the input's and the
label's.

Differences from the JAX script: the weights start from flax's
initialisation drawn with numpy from ``--seed`` (``init_params3``) and the
batches from a ``torch.Generator`` seeded with it, not from JAX's keys; and
``--device`` (cuda by default; ``cpu`` runs the plain versions). On the
card every conv runs on kernel N's flax route with its backward on
``fn_conv3d_dgrad`` and ``fn_conv3d_wgrad``, the polish on kernel I with
``fn_jacobi3_adjoint`` behind it, the labels on kernel I and the frames'
steps on kernels L and I (``train/trainer.py``).
"""
import argparse
import time

import torch

from ..config import ModelConfig
from ..data.synthetic3 import generate_batch3
from ..models.punet3d import FluidNet3, init_params3
from ..ops.kernels.punet3 import pack_weights3
from ..ops.ops3d import velocity_divergence3
from ..run_plume import resolve_device
from ..sim.scenes import plume_config
from ..sim.scenes3 import create_plume_scene3
from ..train.checkpoint import save_train_checkpoint
from ..train.trainer import (TrainState, check_trainable,
                             collect_rollout_frames3, make_train_step3)

CHUNK = 5


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--bsz", type=int, default=4)
    ap.add_argument("--labelIters", type=int, default=400)
    ap.add_argument("--polishSweeps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--patch", type=int, default=4)
    ap.add_argument("--plumeFrames", type=int, default=0,
                    help="collect N pre-projection 3-D plume rollout "
                         "frames and mix them into training")
    ap.add_argument("--synthFrac", type=float, default=0.5,
                    help="fraction of synthetic samples when --plumeFrames")
    ap.add_argument("--modelDir", default="trained_models/PUNet3_32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="numpy seed of the initial weights and seed of the "
                         "batches' generator")
    return ap.parse_args(argv)


def model_config(args) -> ModelConfig:
    return ModelConfig(model="PUNet3", punet_patch=args.patch,
                       punet_widths=(96, 128), punet_bottleneck_convs=2,
                       polish_sweeps=args.polishSweeps,
                       compute_dtype="bfloat16", normalize_input_chan="UDiv")


def rollout_frames(args, dev):
    """(frames, flags, inlet mask) of ``--plumeFrames`` plume frames."""
    r = args.res
    print(f"collecting {args.plumeFrames} 3-D plume rollout frames at "
          f"{r}^3...", flush=True)
    roll_cfg = plume_config(dt=0.25, jacobi_iter=200, buoyancy_scale=0.5,
                            gravity_vec=(0.0, -1.0, 0.0), line_trace=False,
                            max_disp=2, advection_impl="window",
                            use_pallas=True)
    scene = create_plume_scene3(r, r, r, density_val=0.1,
                                u_scale=0.6 * r / 64.0, device=dev)
    frames, flags, mask = collect_rollout_frames3(
        roll_cfg, scene, args.plumeFrames, stride=4, warmup=40)
    print(f"frames ready: {tuple(frames.shape)}", flush=True)
    return frames, flags, mask


@torch.no_grad()
def final_report(model, args, dev):
    """(mean|div| of the input, of the learned projection, of the label) on
    a fresh batch of 2 drawn from seed 99."""
    r = args.res
    gen = torch.Generator(device=dev).manual_seed(99)
    U_div, flags, p_t, U_t = generate_batch3(gen, 2, r, r, r,
                                             args.labelIters, dev)
    zero = torch.zeros_like(p_t)
    _, U_out = model(zero, U_div, flags, zero, pack_weights3(model.net))
    return tuple(float(velocity_divergence3(U, flags).abs().mean())
                 for U in (U_div, U_out, U_t))


def main(argv=None):
    """Run the training; returns a dict of the reported losses (one a
    report, the mean of its chunk), the steps run, ms/step over the
    chunks and the final mean|div| triple."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mcfg = model_config(args)
    check_trainable(mcfg, dev)
    model = init_params3(FluidNet3(mcfg), args.seed).to(dev)
    r = args.res
    frames = flags = mask = None
    if args.plumeFrames:
        frames, flags, mask = rollout_frames(args, dev)
    step, opt = make_train_step3(model, args.lr, args.bsz, r,
                                 args.labelIters, frames, flags, mask,
                                 args.synthFrac, dev)
    ts = TrainState(model, opt)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    best = float("inf")
    reports = []
    t0 = t_start = time.time()
    for i in range(CHUNK, args.steps + 1, CHUNK):
        losses = torch.stack([step(gen) for _ in range(CHUNK)])
        ts.step += CHUNK
        if i % 50 == 0 or i >= args.steps:
            loss = float(losses.mean())
            is_best = loss < best
            best = min(best, loss)
            save_train_checkpoint(args.modelDir, ts, i, best, mcfg,
                                  is_best=is_best)
            reports.append(loss)
            print(f"step {i}/{args.steps}: divL2 {loss:.6f}"
                  f"{' *best*' if is_best else ''} "
                  f"{50 / (time.time() - t0):.2f} steps/s", flush=True)
            t0 = time.time()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.time() - t_start
    d_in, d_out, d_lbl = final_report(model, args, dev)
    print(f"mean|div|: input {d_in:.5f} -> learned {d_out:.5f} "
          f"(Jacobi-{args.labelIters} label: {d_lbl:.5f})", flush=True)
    return {"losses": reports, "steps": ts.step,
            "ms_per_step": 1e3 * elapsed / max(ts.step, 1),
            "mean_div": (d_in, d_out, d_lbl)}


if __name__ == "__main__":
    main()
