#!/usr/bin/env python3
"""Convert the trained checkpoints into torch files for the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/torch_convert_checkpoints.py [NAME ...]

For each of PUNetD2_128, DataTrain_128 (FluidNetTower), ScaleNet_jets_128,
ScaleNet_onDevice_128 and ScaleNet_rollout_128 (MultiScaleNet) (2-D),
PUNet3p8_64, PUNet3p8j_64, PUNet3p8r_64 and PUNet3_32 (3-D) it reads
``trained_models/<name>/best`` with the JAX package's loader
(``train/checkpoint.py::load_train_checkpoint``), and for MGCoarse_128 (the
learned coarse solve of ``mg_learned``) as ``models/mg_coarse.py::
load_mg_coarse`` reads it; converts the network's parameters with
``fluidnet_cxx_tpu_torch/models/convert.py`` (``flax_to_state_dict`` /
``flax_to_state_dict3`` / ``flax_mg_coarse_to_state_dict``) and saves
them, float32 parameters only, as ``trained_models/<name>/torch_state_dict.pt``
(``models/convert.py::STATE_DICT_FILE``), which the port loads with
``load_state_dict_file``. Needs JAX, flax and orbax; the port itself never
imports them. Takes ~40 s on a CPU; names given convert only those.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fluidnet_cxx_tpu_torch.models.convert import (
    STATE_DICT_FILE, flax_mg_coarse_to_state_dict, flax_to_state_dict,
    flax_to_state_dict3)

MODELS_2D = ("PUNetD2_128", "DataTrain_128", "ScaleNet_jets_128",
             "ScaleNet_onDevice_128", "ScaleNet_rollout_128")
# The flax FluidNet's submodule of each 2-D model (its config's "model").
SUBTREE = {"PUNet": "PUNet_0", "ScaleNet": "MultiScaleNet_0",
           "FluidNet": "FluidNetTower_0"}
MODELS_3D = ("PUNet3p8_64", "PUNet3p8j_64", "PUNet3p8r_64", "PUNet3_32")
MODELS_MG_COARSE = ("MGCoarse_128",)


def _template(init):
    """Numpy zeros shaped as the tree ``init(key)`` returns, from its
    shapes alone (``jax.eval_shape``: nothing is compiled or run)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def flax_params(name):
    """The trained network's flax parameter subtree (numpy leaves) of
    ``trained_models/<name>/best``, read with the templates the JAX benches
    use (``bench.py`` for 2-D, ``scripts/bench3d.py`` for 3-D; their
    shapes, as numpy zeros); for MGCoarse_128 the whole ``MGCoarseNet``
    tree (its PUNet under ``punet``), read as the JAX package's
    ``models/mg_coarse.py::load_mg_coarse`` reads it (its config, its
    payload of params, step and best), from its template's shapes."""
    model_dir = os.path.join(ROOT, "trained_models", name)
    if name in MODELS_MG_COARSE:
        import orbax.checkpoint as ocp

        from fluidnet_cxx_tpu.models.mg_coarse import (MGCoarseConfig,
                                                       MGCoarseNet,
                                                       init_mg_coarse_params)

        with open(os.path.join(model_dir, "mg_coarse_config.json")) as f:
            cfg = MGCoarseConfig(**{k: tuple(v) if isinstance(v, list)
                                    else v for k, v in json.load(f).items()})
        model = MGCoarseNet(cfg)
        payload = {"params": _template(
            lambda k: init_mg_coarse_params(model, k, 128, 128)),
            "step": np.zeros(()), "best": np.zeros(())}
        restored = ocp.PyTreeCheckpointer().restore(
            os.path.join(model_dir, "best"), item=payload,
            restore_args=ocp.checkpoint_utils.construct_restore_args(
                payload))
        return jax.tree_util.tree_map(np.asarray,
                                      restored["params"]["params"])
    from fluidnet_cxx_tpu.train.checkpoint import (load_model_config,
                                                   load_train_checkpoint)

    mcfg = load_model_config(model_dir)
    if name in MODELS_2D:
        from fluidnet_cxx_tpu.models import FluidNet
        from fluidnet_cxx_tpu.train import TrainConfig, init_train_state

        template = _template(lambda k: init_train_state(
            FluidNet(mcfg), k, TrainConfig(), 64, 64))
        sub = SUBTREE[mcfg.model]
    else:
        import optax

        from fluidnet_cxx_tpu.models.punet3d import FluidNet3, init_params3
        from fluidnet_cxx_tpu.train.trainer import TrainState

        def init_state(k):
            init = init_params3(FluidNet3(mcfg), k, 16, 16, 16)
            return TrainState(init, optax.adam(1e-4).init(init),
                              jnp.zeros((), jnp.int32))

        template = _template(init_state)
        sub = "PUNet3_0"
    ts, _, _ = load_train_checkpoint(model_dir, template, best=True)
    return jax.tree_util.tree_map(np.asarray, ts.params["params"][sub])


def converted(name):
    """The port's state_dict of ``trained_models/<name>/best``."""
    convert = (flax_to_state_dict if name in MODELS_2D else
               flax_mg_coarse_to_state_dict if name in MODELS_MG_COARSE else
               flax_to_state_dict3)
    return convert(flax_params(name))


def main(names=None):
    for name in names or MODELS_2D + MODELS_3D + MODELS_MG_COARSE:
        t0 = time.perf_counter()
        sd = converted(name)
        path = os.path.join(ROOT, "trained_models", name, STATE_DICT_FILE)
        torch.save(sd, path)
        n = sum(t.numel() for t in sd.values())
        print(f"{name}: {len(sd)} tensors, {n} parameters, "
              f"{os.path.getsize(path) / 1e6:.2f} MB -> {path} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
