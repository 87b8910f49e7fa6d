"""Flax PUNet parameters -> the port's PUNet ``state_dict``.

Input: the flax ``PUNet_0`` param subtree as numpy arrays,
``{"embed": {"kernel": (k, k, c_in, c_out), "bias": (c_out,)}, ...}``
(from an orbax checkpoint read where JAX is installed, or from
``random_flax_params``). Three layout traps, each handled once:

1. flax's space_to_depth orders channels (py, px, c), torch's
   pixel_unshuffle (c, py, px): the port's ``space_to_depth`` keeps flax's
   order, so the embed and up weights need no permutation.
2. flax 'SAME' on an even input pads a stride-2 conv (0, 1): the port pads
   with ``same_pads`` and convolves with padding 0, so the weights carry
   over unchanged.
3. flax kernels are HWIO, torch's OIHW: transposed here.
"""
import numpy as np
import torch

# flax's lecun_normal: truncated normal on [-2, 2] rescaled to unit
# variance (the std of a standard normal truncated there).
_TRUNC_STD = 0.87962566103423978


def flax_to_state_dict(params):
    """Flax PUNet param tree (numpy) -> {``convs.<name>.weight``: OIHW,
    ``convs.<name>.bias``} float32 tensors."""
    sd = {}
    for name, leaf in params.items():
        k = np.asarray(leaf["kernel"], np.float32)
        sd[f"convs.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"convs.{name}.bias"] = torch.from_numpy(
            np.asarray(leaf["bias"], np.float32).copy())
    return sd


def random_flax_params(table, seed: int = 0):
    """Flax-initialised PUNet parameters from a numpy seed: lecun-normal
    kernels (truncated normal, std sqrt(1/fan_in)) and zero biases, for the
    layers of ``models.punet.layer_table``."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, ci, co, k, _, _ in table:
        shape = (k, k, ci, co)
        z = rng.standard_normal(shape)
        bad = np.abs(z) > 2.0
        while bad.any():
            z[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(z) > 2.0
        std = np.sqrt(1.0 / (k * k * ci)) / _TRUNC_STD
        params[name] = {"kernel": (z * std).astype(np.float32),
                        "bias": np.zeros((co,), np.float32)}
    return params
