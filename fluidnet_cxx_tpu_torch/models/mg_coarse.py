"""The learned coarse-grid correction of the multigrid projection (the port
of the JAX package's ``models/mg_coarse.py``, JAX's ``mg_learned``).

One cold V-cycle whose recursion below the first level of side <=
``coarse_size`` is replaced by a small PUNet on that level's restricted,
compatibility-projected residual; ``post`` damped sweeps there clean the
net's high-frequency noise before the prolongation. The net is
scale-equivariant by construction: its input is normalised by the
per-sample RMS over live cells and its output scaled back, then
gauge-fixed (zero mean over continuation cells) and masked.

On the card the V-cycle is kernel G split at the cut (ops/kernels/mg.py::
``solve_mg_learned``) and the PUNet's convolutions are kernel B's
bfloat16 route (ops/kernels/punet.py; flax's rounding points, as JAX
runs the net, and in training its backward kernels); the RMS, the input
stack and the gauge are torch glue. A CPU tensor runs the plain versions.
The projection has no ``handles_const_vals``: the step runs it in its
unfused branch with ``sim_method="convnet"``, as the JAX
``scripts/run_plume.py`` does.

Training (``scripts/train_mg_coarse.py``): ``init_mg_coarse_params``
(flax's initialisation from a numpy seed) and ``save_mg_coarse``, whose
model dir ``load_mg_coarse`` and ``run_plume --simMethod mg_learned
--modelDir DIR`` read.
"""
import dataclasses
import json
import os

import torch
from torch import nn

from ..celltype import OBSTACLE
from ..ops.common import border_mask
from ..ops.kernels.mg import solve_mg
from ..ops.kernels.punet import pack_weights, net_forward
from ..ops.stencils import set_wall_bcs, velocity_divergence, velocity_update
from ..train.checkpoint import _save
from .convert import (STATE_DICT_FILE, flax_to_state_dict,
                      load_state_dict_file, random_flax_params)
from .punet import PUNet

CONFIG_FILE = "mg_coarse_config.json"
STATE_FILE = "train_state.pt"


@dataclasses.dataclass(frozen=True)
class MGCoarseConfig:
    patch: int = 8
    widths: tuple = (64, 64)
    level_convs: int = 1
    bottleneck_convs: int = 3
    bottleneck_dilation: int = 2


def _cont(flags):
    _, h, w = flags.shape
    return (~(border_mask(h, w, 1, flags.device)[None]
              | (flags == OBSTACLE))).to(torch.float32)


class MGCoarseNet(nn.Module):
    """(flags, rhs) -> e with A e ~= rhs on continuation cells. Its PUNet
    (2 input channels, no refinement stack) is ``self.punet``, named as
    the flax submodule, computing in ``dtype``: bfloat16 by default, as
    the JAX ``MGCoarseNet`` leaves flax PUNet's default dtype (and
    MGCoarse_128 was trained so); "float32" builds the float32 variant.
    The RMS, the input stack and the gauge are float32 either way."""

    def __init__(self, cfg: MGCoarseConfig = MGCoarseConfig(),
                 dtype: str = "bfloat16"):
        super().__init__()
        self.cfg = cfg
        self.punet = PUNet(in_ch=2, patch=cfg.patch, widths=cfg.widths,
                           level_convs=cfg.level_convs,
                           bottleneck_convs=cfg.bottleneck_convs,
                           bottleneck_dilation=cfg.bottleneck_dilation,
                           dtype=dtype)

    def forward(self, flags, rhs, packed=None):
        """``packed`` (``pack_weights(self.punet)``) runs the convolutions
        through ``conv2d_nhwc`` (kernel B on a CUDA tensor); without it the
        module's plain forward."""
        cont = _cont(flags)
        n_live = torch.clamp(torch.sum(cont, dim=(1, 2), keepdim=True),
                             min=1.0)
        s = torch.sqrt(torch.sum((rhs * cont) ** 2, dim=(1, 2), keepdim=True)
                       / n_live) + 1e-8
        x = torch.stack([rhs / s * cont, cont], dim=-1)
        e = (self.punet(x) if packed is None else
             net_forward(self.punet, packed, x))[..., 0]
        e = e * s
        mean = torch.sum(e * cont, dim=(1, 2), keepdim=True) / n_live
        return (e - mean) * cont


def make_coarse_fn(model):
    """``coarse_fn(flags_c, rhs_c) -> e_c`` of ``model`` for ``solve_mg``,
    its convolutions through ``conv2d_nhwc`` (weights packed once, on the
    model's device)."""
    with torch.no_grad():
        packed = pack_weights(model.punet)

    @torch.no_grad()
    def coarse_fn(flags_c, rhs_c):
        return model(flags_c, rhs_c, packed)

    return coarse_fn


def make_project_fn_mg_learned(model, n_vcycles: int = 1, pre: int = 4,
                               post: int = 4, coarse_size: int = 128):
    """Projection ``project(p, U, flags, density) -> (p, U)`` for
    ``simulate_step`` with ``sim_method="convnet"``: the divergence,
    ``n_vcycles`` cold V-cycles of kernel G with the learned coarse solve
    (``solve_mg(coarse_fn=...)``), the velocity update and the free-slip
    walls. No ``handles_const_vals``: the step applies the walls and inlet
    BCs around it."""
    coarse_fn = make_coarse_fn(model)

    @torch.no_grad()
    def project(p, U, flags, density):
        del p, density
        div = velocity_divergence(U, flags)
        p_new = solve_mg(flags, div, n_vcycles=n_vcycles, pre=pre,
                         post=post, coarse_fn=coarse_fn,
                         coarse_size=coarse_size)
        return p_new, set_wall_bcs(velocity_update(p_new, U, flags), flags)

    # What the width-sharded step reads (parallel/project.py::sharding_of).
    project.kind = "mg_learned"
    project.mg = dict(coarse_fn=coarse_fn, n_vcycles=n_vcycles, pre=pre,
                      post=post, coarse_size=coarse_size)
    return project


def init_mg_coarse_params(model: MGCoarseNet, seed: int = 0) -> MGCoarseNet:
    """flax's initialisation of ``model``'s PUNet from a numpy seed
    (lecun-normal kernels, zero biases; ``models/convert.py``), in place
    on the model's device; returns the model. JAX draws it from a PRNG
    key, so the two packages' weights from one seed differ."""
    dev = next(model.parameters()).device
    sd = flax_to_state_dict(random_flax_params(model.punet.table, seed))
    model.punet.load_state_dict({k: v.to(dev) for k, v in sd.items()})
    return model


def save_mg_coarse(model_dir, cfg: MGCoarseConfig, model, opt, step: int,
                   best: float, is_best: bool = False):
    """The training checkpoint, where JAX writes orbax ``last/`` (and
    ``best/``): ``<model_dir>/last/train_state.pt`` (and ``best/``) holds,
    by ``torch.save``, the model's parameters, the optimizer's state,
    ``step`` and ``best``; on best also ``<model_dir>/torch_state_dict.pt``
    (the parameters as float32 CPU tensors, the file ``load_mg_coarse``
    reads); and ``mg_coarse_config.json``. Every file is written under a
    temporary name and renamed into place."""
    os.makedirs(model_dir, exist_ok=True)
    params = model.state_dict()
    payload = {"params": params, "optimizer": opt.state_dict(),
               "step": int(step), "best": float(best)}
    for name in ("last", "best") if is_best else ("last",):
        d = os.path.join(model_dir, name)
        os.makedirs(d, exist_ok=True)
        _save(payload, os.path.join(d, STATE_FILE))
    if is_best:
        _save({k: v.detach().float().cpu() for k, v in params.items()},
              os.path.join(model_dir, STATE_DICT_FILE))
    tmp = os.path.join(model_dir, f"{CONFIG_FILE}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    os.replace(tmp, os.path.join(model_dir, CONFIG_FILE))


def load_mg_coarse_config(model_dir) -> MGCoarseConfig:
    """``<model_dir>/mg_coarse_config.json``; lists come back as tuples."""
    with open(os.path.join(str(model_dir), CONFIG_FILE)) as f:
        d = json.load(f)
    return MGCoarseConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in d.items()})


def load_mg_coarse(model_dir, device="cpu",
                   dtype: str = "bfloat16") -> MGCoarseNet:
    """The trained ``MGCoarseNet`` of ``model_dir``: its config and the
    converted parameters ``torch_state_dict.pt`` (read with torch alone;
    FileNotFoundError if the file is missing), on ``device``, in eval
    mode, its PUNet in ``dtype`` (flax's bfloat16 by default)."""
    model = MGCoarseNet(load_mg_coarse_config(model_dir), dtype)
    model.load_state_dict(load_state_dict_file(model_dir))
    return model.to(device).eval()
