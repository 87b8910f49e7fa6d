"""Train checkpoints (the port of the JAX package's ``train/checkpoint.py``,
its training half; the simulation restarts are ROADMAP A.9).

``<model_dir>/last_epoch/train_state.pt`` (and ``best/`` for the best so
far) holds, by ``torch.save``, the network's parameters (the state_dict
layout of ``trained_models/*/torch_state_dict.pt``), the Adam state, the
plateau state, ``step``, ``epoch`` and ``best_perf``;
``<model_dir>/model_config.json`` is written in the JAX trainer's layout.
A file is written under a temporary name and renamed into place.
"""
import os

import torch

from ..config import save_model_config

STATE_FILE = "train_state.pt"


def save_train_checkpoint(model_dir: str, ts, epoch: int, best_perf: float,
                          model_cfg, is_best: bool = False):
    payload = {"params": ts.model.net.state_dict(),
               "optimizer": ts.optimizer.state_dict(), "step": ts.step,
               "epoch": int(epoch), "best_perf": float(best_perf)}
    for name in ("last_epoch", "best") if is_best else ("last_epoch",):
        d = os.path.join(model_dir, name)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f"{STATE_FILE}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(d, STATE_FILE))
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
