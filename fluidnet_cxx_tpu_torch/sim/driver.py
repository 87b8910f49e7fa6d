"""Simulation run loop of the scene drivers (the port of the JAX
package's ``sim/driver.py::run_simulation``; without restarts).

A Python loop over ``simulate_step`` in place of the JAX driver's jitted
``lax.scan`` chunks: PyTorch runs eagerly, and the kernels queue on the
card's stream without waiting for the host. Every ``stat_iter`` steps the
loop synchronises, runs the CFL guard and calls ``on_stats(state, it)``.
"""
import time
import warnings
from typing import Callable, Optional

import torch

from ..ops.window import max_displacement
from .step import simulate_step


def run_simulation(cfg, state, max_iter: int, stat_iter: int = 100,
                   project_fn=None, on_stats: Optional[Callable] = None,
                   verbose: bool = True):
    """Advance ``max_iter`` steps, calling ``on_stats(state, it)`` every
    ``stat_iter`` steps and at the end. Returns the final state.

    The CFL guard: the window engine clamps back-traces to +-``max_disp``
    cells, so at each stats point the loop warns, once per run, when
    ``max_displacement`` exceeds ``cfg.max_disp``."""
    guard = cfg.advection_impl == "window"
    warned = False
    it = 0
    t0 = time.perf_counter()
    while it < max_iter:
        n = min(stat_iter, max_iter - it)
        for _ in range(n):
            state = simulate_step(cfg, state, project_fn)
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
