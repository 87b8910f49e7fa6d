"""Generate a Mantaflow-layout training dataset with the solver, the twin
of the JAX package's ``scripts/make_dataset.py``:

    python -m fluidnet_cxx_tpu_torch.scripts.make_dataset \\
        [--out out/dataset] [--dataset plume_mg] [--scenesTr 32]
        [--scenesTe 8] [--res 128] [--framesPerScene 64] [--saveDt 4]
        [--seed 0] [--device cpu]

Writes ``<out>/<dataset>/{tr,te}/NNNNNN/`` scene directories, each with
``framesPerScene`` frames: frame 0 the scene at t = 0, then every
``saveDt``-th step the projected state ``{t:06d}.bin`` and the state
before its projection ``{t:06d}_divergent.bin`` (the Manta ``.bin``
layout, ``data/manta_io.py::save_manta_file``), and ``DONE`` when the
scene is complete (a complete scene is skipped on a rerun). Scene i of
``tr`` draws from ``numpy.random.default_rng(seed + i)`` (``te`` from
``seed + 10000 + i``) exactly as JAX's script draws: the inlet's speed
(0.8-2.5 x res/128), radius (0.08-0.2) and density (0.1-1), the buoyancy
(one of 0.3, 0.6, 0.9, 1.2, 1.5) and 0-2 disc obstacles clear of the
inlet. The step: multigrid with 8 V-cycles, no line trace, JAX's
``use_pallas`` rule (on the card: kernels A and H; on the CPU their plain
versions). ``--device`` is the port's own flag.

Then ``python -m fluidnet_cxx_tpu_torch.scripts.preprocess_data`` turns
the scenes into the trainer's ``.npz`` frames.
"""
import argparse
import os
import time

import numpy as np
import torch

from ..data.manta_io import save_manta_file
from ..run_plume import resolve_device
from ..sim.scenes import add_cylinder, create_plume_scene, plume_config
from ..sim.step import simulate_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.scripts.make_dataset",
        description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="out/dataset")
    ap.add_argument("--dataset", default="plume_mg",
                    help="dataset name (subdir, like the reference's "
                         "dataDir/<dataset>/)")
    ap.add_argument("--scenesTr", type=int, default=32)
    ap.add_argument("--scenesTe", type=int, default=8)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--framesPerScene", type=int, default=64)
    ap.add_argument("--saveDt", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_scene(rng, res, device):
    """(state, config) of one randomised plume scene, drawn from ``rng``
    in JAX's order."""
    u_scale = float(rng.uniform(0.8, 2.5)) * res / 128.0
    rad = float(rng.uniform(0.08, 0.2))
    density_val = float(rng.uniform(0.1, 1.0))
    buoy = float(rng.choice([0.3, 0.6, 0.9, 1.2, 1.5]))
    state = create_plume_scene(res, res, density_val=density_val,
                               u_scale=u_scale, rad=rad, device=device)
    flags = state.flags
    for _ in range(int(rng.integers(0, 3))):
        r = float(rng.uniform(0.04, 0.1)) * res
        cx = float(rng.uniform(0.15 * res, 0.85 * res))
        cy = float(rng.uniform(0.35 * res, 0.85 * res))
        flags = add_cylinder(flags, cx, cy, r)
    state = state._replace(flags=flags)
    cfg = plume_config(sim_method="multigrid", mg_vcycles=8,
                       buoyancy_scale=buoy,
                       use_pallas=torch.device(device).type == "cuda",
                       line_trace=False)
    return state, cfg


@torch.no_grad()
def advance(cfg, state, save_dt):
    """``save_dt`` steps; also the last step's pre-projection state.
    Returns (divergent, state)."""
    for _ in range(save_dt - 1):
        state = simulate_step(cfg, state)
    divergent = simulate_step(cfg, state, output_div=True)
    return divergent, simulate_step(cfg, state)


def dump(path, state):
    save_manta_file(path, *(getattr(state, f)[0].cpu().numpy()
                            for f in ("p", "U", "flags", "density")))


def generate(out_base, prefix, n_scenes, res, n_frames, save_dt, seed0,
             device):
    """The scenes of ``prefix``; returns the seconds each new one took."""
    seconds = []
    for scene_i in range(n_scenes):
        sdir = os.path.join(out_base, prefix, f"{scene_i:06d}")
        os.makedirs(sdir, exist_ok=True)
        done = os.path.join(sdir, "DONE")
        if os.path.exists(done):
            continue
        t0 = time.time()
        rng = np.random.default_rng(seed0 + scene_i)
        state, cfg = build_scene(rng, res, device)
        # Frame 0 is the initial state: divergent == projected == initial.
        dump(os.path.join(sdir, "000000.bin"), state)
        dump(os.path.join(sdir, "000000_divergent.bin"), state)
        for f in range(1, n_frames):
            divergent, state = advance(cfg, state, save_dt)
            t = f * save_dt
            dump(os.path.join(sdir, f"{t:06d}.bin"), state)
            dump(os.path.join(sdir, f"{t:06d}_divergent.bin"), divergent)
        if not bool(torch.isfinite(state.density).all()):
            raise AssertionError(f"scene {scene_i} blew up")
        with open(done, "w") as fh:
            fh.write("ok\n")
        seconds.append(time.time() - t0)
        print(f"{prefix}/{scene_i:06d}: {n_frames} frames @ {res}^2 "
              f"({seconds[-1]:.1f}s)", flush=True)
    return seconds


def main(argv=None):
    """Write the dataset; returns the seconds of each new scene."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    base = os.path.join(args.out, args.dataset)
    seconds = generate(base, "tr", args.scenesTr, args.res,
                       args.framesPerScene, args.saveDt, args.seed, dev)
    seconds += generate(base, "te", args.scenesTe, args.res,
                        args.framesPerScene, args.saveDt,
                        args.seed + 10_000, dev)
    print(f"dataset complete under {base}")
    return seconds


if __name__ == "__main__":
    main()
