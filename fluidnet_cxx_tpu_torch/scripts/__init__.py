"""Twins of the JAX package's scripts, run as ``python -m
fluidnet_cxx_tpu_torch.scripts.<name>`` with the same flags, plus
``--device`` (cuda by default): the scene drivers (``run_plume``,
``run_rayleigh_taylor``, ``run_cylinder``, ``run_blob3d``), the
evaluations (``eval_parity``, ``quality_per_ms``), the data tools
(``make_dataset``, ``preprocess_data``, which runs no device work and
takes no ``--device``) and the trainers (``train3d``,
``train_mg_coarse``).

The 2-D scene drivers differ from the JAX scripts in two ways. They
always run as the JAX scripts' ``--fast`` does (``use_pallas=True``: the
hand-written kernels and the first-hit line trace); ``--fast`` is
accepted and changes nothing, where JAX's scripts without it run the
march trace. And all three honour ``realTimePlot`` (true by default), where
the JAX RT and cylinder scripts plot unconditionally: the plume and RT
twins read it from their YAML, the cylinder twin, which reads none, from
``--realTimePlot``. Where matplotlib is not installed, run them with it
false.

This module holds what the drivers share: the restart or the scene, the
timed run and the finite check.
"""
import os
import time

import torch

from ..sim.driver import run_simulation
from ..train.checkpoint import load_sim_restart

RESTART_FILE = "restart.npz"


def initial_state(out: str, restart: bool, scene, device):
    """(state, it0): ``<out>/restart.npz`` on ``device`` when ``restart``
    and the file exists, else ``scene`` from step 0. Says which under
    ``restart``."""
    path = os.path.join(out, RESTART_FILE)
    if restart and os.path.isfile(path):
        state, it0 = load_sim_restart(path, device)
        print(f"restarting at it={it0} from {path}", flush=True)
        return state, it0
    if restart:
        print(f"no {path}: starting from the scene at it=0", flush=True)
    return scene, 0


@torch.no_grad()
def timed_run(cfg, state, max_iter: int, stat_iter: int, project=None,
              on_stats=None, start_it: int = 0, verbose: bool = True):
    """``run_simulation`` timed by CUDA events on the card (the host clock
    on the CPU). Returns (final state, a dict of ``it`` (the last step),
    ``steps`` run, ``ms_per_step`` over the whole loop with its outputs
    (None when no step ran) and ``outputs_ms``, the host time spent in
    ``on_stats``)."""
    outputs = [0.0]

    def timed_stats(st, it):
        t = time.perf_counter()
        if on_stats is not None:
            on_stats(st, it)
        outputs[0] += time.perf_counter() - t

    on_card = state.U.device.type == "cuda"
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
    t0 = time.perf_counter()
    state = run_simulation(cfg, state, max_iter, stat_iter, project,
                           on_stats=timed_stats, start_it=start_it,
                           verbose=verbose)
    if on_card:
        end.record()
        end.synchronize()
        elapsed_ms = start.elapsed_time(end)
    else:
        elapsed_ms = 1e3 * (time.perf_counter() - t0)
    steps = max(max_iter - start_it, 0)
    return state, {"it": max(max_iter, start_it), "steps": steps,
                   "ms_per_step": elapsed_ms / steps if steps else None,
                   "outputs_ms": 1e3 * outputs[0]}


def finite(state) -> bool:
    """Whether U, p and the density (where the scene has one) are
    finite."""
    return all(bool(torch.isfinite(t).all())
               for t in (state.U, state.p, state.density) if t is not None)
