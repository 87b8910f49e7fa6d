"""The twin of the JAX package's ``__graft_entry__.py::dryrun_multichip``:
three multi-rank checks at JAX's toy shapes.

    torchrun --nproc-per-node N -m fluidnet_cxx_tpu_torch.parallel.dryrun
    python -m fluidnet_cxx_tpu_torch.parallel.dryrun --nproc N \\
        --backend gloo [--device cpu]

The first runs one rank a card under NCCL (torchrun's environment); the
second spawns its own N ranks, under gloo on one card (NCCL refuses two
ranks on one device) or, with ``--device cpu``, on the CPU.

1. one data-parallel train step of ``FluidNet(ModelConfig())`` at 16^2,
   the long-term loss on (rollout of 1 or 2 steps), a synthetic batch of
   N: at dp = N, sx = 1, since width-sharded training is ROADMAP A.8.2
   (JAX runs dp x sx there);
2. one width-sharded 3-D plume step at 8x16x4N, sx = N (JAX's window
   engine at max_disp 1, Jacobi-2);
3. one width-sharded viscous stick-wall cylinder step at 32x16N, sx = N
   (the disc at x = 4N, radius 4.5, Jacobi-2).

Each check must be finite; the two steps are also held to the
single-device step of the whole state within 1e-5 of its largest value
(the sharded step traces in its slab's coordinates, see
``parallel/step.py``). Rank 0 prints JAX's ``[i/3] ... OK`` lines and
``dryrun_multichip OK``.
"""
import argparse
import sys

import torch

from ..config import ModelConfig, SimConfig, TrainConfig
from ..data.synthetic import generate_batch
from ..models.fluidnet import FluidNet
from ..sim.scenes import create_cylinder_scene, cylinder_config, plume_config
from ..sim.scenes3 import create_plume_scene3
from ..sim.step import simulate_step
from ..sim.step3d import simulate_step3
from ..train.trainer import Batch, init_train_state, make_train_step
from .launch import spawn
from .mesh import (batch_sharding, gather_state, make_mesh, mesh_device,
                   state_sharding)
from .step import simulate_step3_sharded, simulate_step_sharded

TOL = 1e-5


def _say(mesh, line):
    if mesh.rank == 0:
        print(line, flush=True)


def _held(name, got, want):
    """Raise unless ``got`` is finite and within TOL of ``want``'s largest
    value."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    if err > TOL * scale:
        raise AssertionError(f"{name}: {err:.3e} from the single-device "
                             f"step (tolerance {TOL * scale:.3e})")
    return err


def check_train(n, backend, device):
    """[1/3]: the data-parallel train step at dp = n, sx = 1."""
    mesh = make_mesh(n, dp=n, sx=1, backend=backend, device=device)
    dev = mesh.device
    h = w = 16
    model = FluidNet(ModelConfig()).to(dev)
    tc = TrainConfig(div_lt_lambda=1.0, lt_num_steps=(1, 2), lr=1e-4)
    sc = SimConfig(dt=0.1, jacobi_iter=2)
    ts = init_train_state(model, tc, seed=0)
    train_step, _ = make_train_step(model, sc, tc, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        batch = Batch(*generate_batch(gen, n, h, w, 4, dev))
    host_gen = torch.Generator().manual_seed(2)
    ts, terms = train_step(ts, batch_sharding(mesh, batch), host_gen)
    loss = float(terms.total)
    if not torch.isfinite(terms.total):
        raise AssertionError("non-finite training loss")
    _say(mesh, f"[1/3] train_step OK on {n} devices (mesh dp={n} x sx=1; "
               "width-sharded training is ROADMAP A.8.2); "
               f"loss={loss:.4f}")
    return mesh


def check_3d(n, backend, device):
    """[2/3]: the width-sharded 3-D step at sx = n."""
    mesh = make_mesh(n, dp=1, sx=n, backend=backend, device=device)
    cfg = plume_config(dt=0.25, jacobi_iter=2, buoyancy_scale=0.5,
                       gravity_vec=(0.0, -1.0, 0.0), line_trace=False,
                       advection_impl="window", max_disp=1)
    state = create_plume_scene3(8, 16, 4 * n, device=mesh.device)
    out = simulate_step3_sharded(cfg, state_sharding(mesh, state), mesh)
    got = gather_state(mesh, out)
    err = _held("3d_step_sx", got.U, simulate_step3(cfg, state).U)
    _say(mesh, f"[2/3] 3d_step_sx OK (sx={n}); max |U - single| {err:.2e}")


def check_cylinder(n, backend, device):
    """[3/3]: the width-sharded viscous stick-wall cylinder at sx = n."""
    mesh = make_mesh(n, dp=1, sx=n, backend=backend, device=device)
    state, visc = create_cylinder_scene(res_x=16 * n, res_y=32,
                                        center_x=4.0 * n, radius=4.5,
                                        device=mesh.device)
    cfg = cylinder_config(visc, jacobi_iter=2)
    out = simulate_step_sharded(cfg, state_sharding(mesh, state), mesh)
    got = gather_state(mesh, out)
    err = _held("cylinder_step_sx", got.U, simulate_step(cfg, state).U)
    _say(mesh, f"[3/3] cylinder_step_sx OK (sx={n}); max |U - single| "
               f"{err:.2e}")


def run_checks(n, backend, device):
    """The three checks on this rank of an initialised world of ``n``."""
    mesh = check_train(n, backend, device)
    with torch.no_grad():
        check_3d(n, backend, device)
        check_cylinder(n, backend, device)
    _say(mesh, f"dryrun_multichip OK on {n} devices ({backend}; train_step "
               "+ 3d_step_sx + cylinder_step_sx)")


def dryrun_multichip(n_devices: int = 2, backend: str = "nccl",
                     device="cuda", timeout_s: float = 120.0):
    """Spawn ``n_devices`` ranks and run the three checks; raises if a rank
    fails or outlives ``timeout_s`` plus a minute."""
    mesh_device(backend, device)  # refuse before spawning
    spawn(run_checks, n_devices, (n_devices, backend, device),
          backend=backend, timeout_s=timeout_s)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fluidnet_cxx_tpu_torch.parallel.dryrun",
        description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=None,
                    help="spawn this many ranks (without torchrun)")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds a collective may wait")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # The package's own module, not this file run as __main__: the spawned
    # ranks import its functions by name.
    from fluidnet_cxx_tpu_torch.parallel import dryrun

    if args.nproc is not None:
        dryrun.dryrun_multichip(args.nproc, args.backend, args.device,
                                args.timeout)
        return
    import datetime

    import torch.distributed as dist

    mesh_device(args.backend, args.device)
    dist.init_process_group(args.backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=args.timeout))
    try:
        dryrun.run_checks(dist.get_world_size(), args.backend, args.device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
