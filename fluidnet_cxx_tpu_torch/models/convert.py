"""Flax network parameters -> the port's ``state_dict``s.

Input: the flax ``PUNet_0``, ``FluidNetTower_0`` or ``MultiScaleNet_0``
(or ``PUNet3_0``, or ``MGCoarseNet``'s ``punet``) param subtree as numpy
arrays, ``{"embed": {"kernel": (k, k, c_in, c_out), "bias": (c_out,)},
...}`` (3-D kernels are (k, k, k, c_in, c_out); MultiScaleNet's layers
nest one level deeper, ``{"convN_4": {"Conv_0": {...}}}``, and become
``convN_4/Conv_0``), from an orbax checkpoint read where JAX is
installed, or from ``random_flax_params``/``random_flax_params3``. Three
layout traps, each handled once:

1. flax's space_to_depth orders channels (py, px, c), torch's
   pixel_unshuffle (c, py, px): the port's ``space_to_depth`` keeps flax's
   order, so the embed and up weights need no permutation.
2. flax 'SAME' on an even input pads a stride-2 conv (0, 1): the port pads
   with ``same_pads`` and convolves with padding 0, so the weights carry
   over unchanged.
3. flax kernels are HWIO (DHWIO in 3-D), torch's OIHW (OIDHW):
   transposed here.

The trained checkpoints' conversions are committed beside them as
``trained_models/<name>/torch_state_dict.pt`` (written in a JAX
installation by ``scripts/torch_convert_checkpoints.py``);
``load_state_dict_file`` reads one with torch alone.
"""
import os

import numpy as np
import torch

STATE_DICT_FILE = "torch_state_dict.pt"

# flax's lecun_normal: truncated normal on [-2, 2] rescaled to unit
# variance (the std of a standard normal truncated there).
_TRUNC_STD = 0.87962566103423978


def _layers(params, prefix=""):
    """(name, {"kernel", "bias"}) of each layer of a flax param tree, a
    nested layer's name joined with "/"."""
    for name, sub in params.items():
        if "kernel" in sub:
            yield prefix + name, sub
        else:
            yield from _layers(sub, f"{prefix}{name}/")


def _to_state_dict(params, order):
    """{``convs.<name>.weight``: the kernel transposed by ``order``,
    ``convs.<name>.bias``} float32 tensors."""
    sd = {}
    for name, leaf in _layers(params):
        k = np.asarray(leaf["kernel"], np.float32)
        sd[f"convs.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(order)))
        sd[f"convs.{name}.bias"] = torch.from_numpy(
            np.asarray(leaf["bias"], np.float32).copy())
    return sd


def flax_to_state_dict(params):
    """Flax 2-D net param tree (numpy; PUNet, FluidNetTower or
    MultiScaleNet) -> {``convs.<name>.weight``: OIHW, ``convs.<name>.bias``}
    float32 tensors."""
    return _to_state_dict(params, (3, 2, 0, 1))


def flax_mg_coarse_to_state_dict(params):
    """Flax ``MGCoarseNet`` param tree (numpy; its PUNet under ``punet``,
    the flax submodule's name) -> the port's ``MGCoarseNet`` state_dict,
    ``punet.convs.<name>.weight`` (OIHW) and ``.bias``."""
    return {f"punet.{k}": v
            for k, v in flax_to_state_dict(params["punet"]).items()}


def flax_to_state_dict3(params):
    """Flax PUNet3 param tree (numpy) -> {``convs.<name>.weight``: OIDHW,
    ``convs.<name>.bias``} float32 tensors."""
    return _to_state_dict(params, (4, 3, 0, 1, 2))


def load_state_dict_file(model_dir):
    """The converted trained parameters of ``model_dir``
    (``<model_dir>/torch_state_dict.pt``), as float32 CPU tensors. Raises
    FileNotFoundError if the file is missing: there is no fallback to
    seed weights."""
    path = os.path.join(str(model_dir), STATE_DICT_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} is missing: write it with "
            "scripts/torch_convert_checkpoints.py (needs JAX), or ask for "
            "seed weights explicitly")
    return torch.load(path, weights_only=True, map_location="cpu")


def _lecun_params(rng, shape):
    """One flax-initialised layer: a lecun-normal kernel of ``shape``
    (truncated normal, std sqrt(1/fan_in), fan_in = all but the last axis)
    and a zero bias."""
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    std = np.sqrt(1.0 / np.prod(shape[:-1])) / _TRUNC_STD
    return {"kernel": (z * std).astype(np.float32),
            "bias": np.zeros((shape[-1],), np.float32)}


def random_flax_params(table, seed: int = 0):
    """Flax-initialised parameters of a 2-D net from a numpy seed:
    lecun-normal kernels (truncated normal, std sqrt(1/fan_in)) and zero
    biases, for the layers of its ``table`` (``ConvNet.table``: PUNet with
    its refinement stack, FluidNetTower, MultiScaleNet), as the flax tree
    holds them (a name with "/" nested)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, ci, co, k, _, _ in table:
        *outer, last = name.split("/")
        node = tree
        for part in outer:
            node = node.setdefault(part, {})
        node[last] = _lecun_params(rng, (k, k, ci, co))
    return tree


def random_flax_params3(table, seed: int = 0):
    """Flax-initialised PUNet3 parameters from a numpy seed, for the layers
    of ``models.punet3d.layer_table3``: lecun-normal (k, k, k, c_in, c_out)
    kernels (fan_in 27 c_in, or c_in for a 1x1x1 conv) and zero biases."""
    rng = np.random.default_rng(seed)
    return {name: _lecun_params(rng, (k, k, k, ci, co))
            for name, ci, co, k, _ in table}
