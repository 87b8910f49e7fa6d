#!/usr/bin/env python3
"""Convert the trained PUNet checkpoints into torch files for the PyTorch
port.

    JAX_PLATFORMS=cpu python scripts/torch_convert_checkpoints.py

For each of PUNetD2_128 (2-D), PUNet3p8_64 and PUNet3_32 (3-D) it reads
``trained_models/<name>/best`` with the JAX package's loader
(``train/checkpoint.py::load_train_checkpoint``), converts the network's
parameters with ``fluidnet_cxx_tpu_torch/models/convert.py``
(``flax_to_state_dict`` / ``flax_to_state_dict3``) and saves them, float32
parameters only, as ``trained_models/<name>/torch_state_dict.pt``
(``models/convert.py::STATE_DICT_FILE``), which the port loads with
``load_state_dict_file``. Needs JAX, flax and orbax; the port itself never
imports them. Takes ~40 s on a CPU.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fluidnet_cxx_tpu_torch.models.convert import (STATE_DICT_FILE,
                                                   flax_to_state_dict,
                                                   flax_to_state_dict3)

MODELS_2D = ("PUNetD2_128",)
MODELS_3D = ("PUNet3p8_64", "PUNet3_32")


def flax_params(name):
    """The trained network's flax parameter subtree (numpy leaves) of
    ``trained_models/<name>/best``, read with the templates the JAX benches
    use (``bench.py`` for 2-D, ``scripts/bench3d.py`` for 3-D)."""
    from fluidnet_cxx_tpu.train.checkpoint import (load_model_config,
                                                   load_train_checkpoint)

    model_dir = os.path.join(ROOT, "trained_models", name)
    mcfg = load_model_config(model_dir)
    if name in MODELS_2D:
        from fluidnet_cxx_tpu.models import FluidNet
        from fluidnet_cxx_tpu.train import TrainConfig, init_train_state

        template = jax.jit(lambda k: init_train_state(
            FluidNet(mcfg), k, TrainConfig(), 64, 64))(jax.random.PRNGKey(0))
        sub = "PUNet_0"
    else:
        import optax

        from fluidnet_cxx_tpu.models.punet3d import FluidNet3, init_params3
        from fluidnet_cxx_tpu.train.trainer import TrainState

        init = init_params3(FluidNet3(mcfg), jax.random.PRNGKey(0),
                            16, 16, 16)
        template = TrainState(init, optax.adam(1e-4).init(init),
                              jnp.zeros((), jnp.int32))
        sub = "PUNet3_0"
    ts, _, _ = load_train_checkpoint(model_dir, template, best=True)
    return jax.tree_util.tree_map(np.asarray, ts.params["params"][sub])


def converted(name):
    """The port's state_dict of ``trained_models/<name>/best``."""
    convert = flax_to_state_dict if name in MODELS_2D else flax_to_state_dict3
    return convert(flax_params(name))


def main():
    for name in MODELS_2D + MODELS_3D:
        t0 = time.perf_counter()
        sd = converted(name)
        path = os.path.join(ROOT, "trained_models", name, STATE_DICT_FILE)
        torch.save(sd, path)
        n = sum(t.numel() for t in sd.values())
        print(f"{name}: {len(sd)} tensors, {n} parameters, "
              f"{os.path.getsize(path) / 1e6:.2f} MB -> {path} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
