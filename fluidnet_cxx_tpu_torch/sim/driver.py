"""Simulation run loop of the scene drivers (the port of the JAX
package's ``sim/driver.py``).

``make_chunk_runner`` advances a state ``chunk`` steps in a Python loop, in
place of the JAX driver's jitted ``lax.scan``: PyTorch runs eagerly, and
the kernels queue on the card's stream without waiting for the host.
``run_simulation`` advances a stats interval at a time, synchronises, runs
the CFL guard and calls ``on_stats(state, it)``; a run restarted from
``start_it`` first steps singly to the stats grid, as JAX's does.
"""
import time
import warnings
from typing import Callable, Optional

import torch

from ..ops.window import max_displacement
from .step import simulate_step


def make_chunk_runner(cfg, project_fn=None, chunk: int = 1):
    """``run(state)``: the state after ``chunk`` steps."""

    def run(state):
        for _ in range(chunk):
            state = simulate_step(cfg, state, project_fn)
        return state

    return run


def run_simulation(cfg, state, max_iter: int, stat_iter: int = 100,
                   project_fn=None, on_stats: Optional[Callable] = None,
                   start_it: int = 0, verbose: bool = True):
    """Advance from step ``start_it`` to ``max_iter``, calling
    ``on_stats(state, it)`` at every multiple of ``stat_iter`` and at
    ``max_iter``. A ``start_it`` off the stats grid is first stepped
    singly to the next multiple of ``stat_iter`` (no ``on_stats`` there).
    Returns the final state.

    The CFL guard: the window engine clamps back-traces to +-``max_disp``
    cells, so at each stats point the loop warns, once per run, when
    ``max_displacement`` exceeds ``cfg.max_disp``."""
    guard = cfg.advection_impl == "window"
    warned = False
    it = start_it
    while it % stat_iter != 0 and it < max_iter:
        state = simulate_step(cfg, state, project_fn)
        it += 1
    t0 = time.perf_counter()
    while it < max_iter:
        n = min(stat_iter, max_iter - it)
        state = make_chunk_runner(cfg, project_fn, n)(state)
        it += n
        if state.U.device.type == "cuda":
            torch.cuda.synchronize(state.U.device)
        if verbose:
            rate = n / max(time.perf_counter() - t0, 1e-9)
            print(f"it={it}/{max_iter}  {rate:.1f} steps/s", flush=True)
        if guard and not warned:
            d = float(max_displacement(state.U, cfg.dt))
            if d > cfg.max_disp:
                warnings.warn(
                    f"CFL violation at it={it}: max back-trace displacement "
                    f"{d:.2f} cells exceeds the window bound max_disp="
                    f"{cfg.max_disp}; advection is clamping trajectories. "
                    "Reduce dt.", stacklevel=2)
                warned = True
        if on_stats is not None:
            on_stats(state, it)
        t0 = time.perf_counter()
    return state
