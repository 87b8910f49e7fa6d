"""Train checkpoints and simulation restarts (the port of the JAX
package's ``train/checkpoint.py``).

Training: ``<model_dir>/last_epoch/train_state.pt`` (and ``best/`` for the
best so far) holds, by ``torch.save``, the network's parameters (the
state_dict layout of ``trained_models/*/torch_state_dict.pt``), the Adam
state (the 2-D trainer's with its plateau state; the 3-D trainer's plain
Adam), ``step``, ``epoch`` and ``best_perf``;
``<model_dir>/model_config.json`` is written in the JAX trainer's layout,
and ``<model_dir>/torch_state_dict.pt`` holds the best parameters as float32
CPU tensors, the file that ``models/convert.py::load_state_dict_file``
reads, so the drivers and benches load a trained model dir as they load
``trained_models/*`` (``run_plume3d --model-dir``, as JAX's loaders read
``best/``). Every file is written under a temporary name and renamed into
place.

Simulation: ``restart.npz`` snapshots of a ``SimState`` for the drivers'
``--restartSim``, with the JAX package's keys (``it`` and every field that
is not None), so a restart written by either package loads into the other.
"""
import os

import numpy as np
import torch

from ..config import save_model_config
from ..models.convert import STATE_DICT_FILE
from ..state import SimState

STATE_FILE = "train_state.pt"


def _save(obj, path):
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_train_checkpoint(model_dir: str, ts, epoch: int, best_perf: float,
                          model_cfg, is_best: bool = False):
    payload = {"params": ts.model.net.state_dict(),
               "optimizer": ts.optimizer.state_dict(), "step": ts.step,
               "epoch": int(epoch), "best_perf": float(best_perf)}
    for name in ("last_epoch", "best") if is_best else ("last_epoch",):
        d = os.path.join(model_dir, name)
        os.makedirs(d, exist_ok=True)
        _save(payload, os.path.join(d, STATE_FILE))
    if is_best:
        _save({k: v.detach().float().cpu()
               for k, v in payload["params"].items()},
              os.path.join(model_dir, STATE_DICT_FILE))
    save_model_config(model_dir, model_cfg)


def load_train_checkpoint(model_dir: str, ts, best: bool = False):
    """Restore ``ts`` (a TrainState of the same model, e.g. freshly
    initialised) in place from ``last_epoch/`` (or ``best/``); returns
    (ts, epoch, best_perf)."""
    dev = next(ts.model.parameters()).device
    path = os.path.join(model_dir, "best" if best else "last_epoch",
                        STATE_FILE)
    payload = torch.load(path, map_location=dev, weights_only=True)
    ts.model.net.load_state_dict(payload["params"])
    ts.optimizer.load_state_dict(payload["optimizer"])
    ts.step = int(payload["step"])
    return ts, int(payload["epoch"]), float(payload["best_perf"])


def save_sim_restart(path: str, state, it: int):
    """npz snapshot of every non-None SimState field and the iteration
    counter ``it`` (one copy to the host). Written under a temporary name
    and renamed into place, so a run stopped during the write leaves the
    previous snapshot whole."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {"it": np.asarray(it)}
    for name in SimState._fields:
        val = getattr(state, name)
        if val is not None:
            arrays[name] = val.detach().cpu().numpy()
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_sim_restart(path: str, device="cpu"):
    """(SimState, it) of a ``save_sim_restart`` file (the port's or the JAX
    package's), each field on ``device`` in its saved dtype (flags
    int32)."""
    with np.load(path) as z:
        it = int(z["it"])
        state = SimState(**{
            name: torch.from_numpy(z[name]).to(device) if name in z.files
            else None for name in SimState._fields})
    return state, it
