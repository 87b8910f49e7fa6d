"""PUNet3, the learned 3-D pressure projection (the port of the JAX
package's ``models/punet3d.py``: ``space_to_depth3``/``depth_to_space3``,
the ``PUNet3`` network and the inference projection of
``make_project_fn3_fused_forward``).

space-to-depth(patch) -> 1x1x1 embed -> encoder (stride-2 3x3x3 downs,
3x3x3 convs) -> bottleneck 3x3x3 convs -> decoder (1x1x1 expand +
depth-to-space(2), skip concat [up | skip], 3x3x3 convs) -> 1x1x1 head ->
depth-to-space(patch).

Layouts follow flax so the converted weights drop in: the network takes and
returns NDHWC; ``space_to_depth3`` orders channels (pz, py, px, c) like
flax (not torch's pixel-shuffle order); padding is flax 'SAME', which on
an even input pads a stride-2 conv (0, 1) per axis. Parameters are
``nn.Conv3d``s (OIDHW) named as the flax modules are. This module's forward
is the plain version of kernel N (ops/kernels/punet3.py), with the TPU
kernel's bfloat16 rounding points (see that module).
"""
import torch
from torch import nn

from ..ops.kernels.proj_tail3 import project_tail3
from ..ops.kernels.punet3 import (conv3d_ndhwc_plain, pack_weights3,
                                  punet3_forward)
from ..ops.ops3d import velocity_divergence3
from ..ops.stencils import flags_to_occupancy
from .fluidnet import scale_std

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def space_to_depth3(x, p: int):
    """(b, d, h, w, c) -> (b, d/p, h/p, w/p, p^3 c), channels ordered
    (pz, py, px, c)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // p, p, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, d // p, h // p, w // p, p * p * p * c)


def depth_to_space3(x, p: int):
    """(b, d, h, w, p^3 c) -> (b, d p, h p, w p, c). Inverse of
    space_to_depth3."""
    b, d, h, w, cp = x.shape
    c = cp // (p * p * p)
    x = x.reshape(b, d, h, w, p, p, p, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d * p, h * p, w * p, c)


def layer_table3(in_ch, patch, widths, level_convs, bottleneck_convs):
    """[(name, c_in, c_out, kernel, stride)] in forward order."""
    widths = tuple(widths)
    t = [("embed", patch ** 3 * in_ch, widths[0], 1, 1)]
    for i, wd in enumerate(widths):
        if i > 0:
            t.append((f"down{i}", widths[i - 1], wd, 3, 2))
        for j in range(level_convs):
            t.append((f"enc{i}_{j}", wd, wd, 3, 1))
    for j in range(bottleneck_convs):
        t.append((f"mid{j}", widths[-1], widths[-1], 3, 1))
    for i in range(len(widths) - 2, -1, -1):
        wd = widths[i]
        t.append((f"up{i}", widths[i + 1], 8 * wd, 1, 1))
        for j in range(level_convs):
            t.append((f"dec{i}_{j}", 2 * wd if j == 0 else wd, wd, 3, 1))
    t.append(("head", widths[0], patch ** 3, 1, 1))
    return t


class PUNet3(nn.Module):
    """Learned 3-D Poisson solve: NDHWC (b, d, h, w, in_ch) float32 ->
    (b, d, h, w, 1) float32.

    d, h and w must be divisible by patch * 2**(len(widths)-1)."""

    def __init__(self, in_ch: int = 2, patch: int = 4, widths=(96, 128),
                 level_convs: int = 1, bottleneck_convs: int = 2,
                 compute_dtype: str = "bfloat16"):
        super().__init__()
        if compute_dtype not in _COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r}: the port's PUNet3 runs "
                "float32 or bfloat16")
        self.in_ch = in_ch
        self.patch = patch
        self.widths = tuple(widths)
        self.level_convs = level_convs
        self.bottleneck_convs = bottleneck_convs
        self.act_dtype = _COMPUTE_DTYPES[compute_dtype]
        self.table = layer_table3(in_ch, patch, widths, level_convs,
                                  bottleneck_convs)
        self.strides = {name: s for name, _, _, _, s in self.table}
        self.convs = nn.ModuleDict({
            name: nn.Conv3d(ci, co, k, stride=s)
            for name, ci, co, k, s in self.table})

    @classmethod
    def from_config(cls, cfg):
        """Build from a ``ModelConfig`` (refine-free PUNet3, float32 or
        bfloat16)."""
        if cfg.model != "PUNet3" or cfg.punet_refine_convs != 0:
            raise NotImplementedError(
                "the port has the refine-free PUNet3 only; the other "
                "models are ROADMAP A.4")
        return cls(in_ch=cfg.in_dims, patch=cfg.punet_patch,
                   widths=cfg.punet_widths,
                   level_convs=cfg.punet_level_convs,
                   bottleneck_convs=cfg.punet_bottleneck_convs,
                   compute_dtype=cfg.compute_dtype)

    def out_dtype(self, relu: bool):
        """A ReLU layer's output is rounded to the compute dtype; the up
        conv's and the head's stay float32."""
        return self.act_dtype if relu else torch.float32

    def _plain_conv(self, name, x, x2=None, relu=True):
        c = self.convs[name]
        w = c.weight.to(self.act_dtype)
        return conv3d_ndhwc_plain(x, w, c.bias, self.strides[name], relu, x2,
                                  self.out_dtype(relu))

    def forward(self, x, conv=None):
        """``conv`` replaces the per-layer convolution (the kernel path
        passes its own)."""
        conv = conv or self._plain_conv
        x = space_to_depth3(x.float(), self.patch).to(self.act_dtype)
        x = conv("embed", x)
        skips = []
        for i in range(len(self.widths)):
            if i > 0:
                x = conv(f"down{i}", x)
            for j in range(self.level_convs):
                x = conv(f"enc{i}_{j}", x)
            skips.append(x)
        for j in range(self.bottleneck_convs):
            x = conv(f"mid{j}", x)
        for i in range(len(self.widths) - 2, -1, -1):
            x = depth_to_space3(conv(f"up{i}", x, relu=False), 2)
            x = conv(f"dec{i}_0", x, x2=skips[i])
            for j in range(1, self.level_convs):
                x = conv(f"dec{i}_{j}", x)
        x = conv("head", x, relu=False)
        return depth_to_space3(x, self.patch)


def make_project_fn3(cfg, net):
    """Inference 3-D projection ``project(p, U, flags, density) -> (p,
    U)`` for ``simulate_step3``, with the semantics of the JAX package's
    ``make_project_fn3_fused_forward``: divergence, the std scale s of the
    configured channel, the PUNet3 forward of [div / s, occupancy]
    (kernel N), then the projection tail (kernel J: RHS, ``polish_sweeps``
    warm damped Jacobi sweeps from p_hat * s, velocity update, wall BCs)
    on the un-normalised fields.

    ``cfg`` is the ``ModelConfig``, ``net`` the PUNet3 (its device decides
    kernel or plain path)."""
    if cfg.model != "PUNet3" or cfg.punet_refine_convs != 0:
        raise NotImplementedError(
            "the port's 3-D projection runs the refine-free PUNet3 only "
            "(ROADMAP A.4)")
    if cfg.polish_sweeps < 1:
        raise NotImplementedError(
            "polish_sweeps 0 takes the JAX package's flax path "
            "(FluidNet3.__call__), not ported (ROADMAP A.4)")
    if net.in_ch != 2:
        raise ValueError("the 3-D projection assembles a 2-channel input")
    packed = pack_weights3(net)

    @torch.no_grad()
    def project(p, U, flags, density):
        div = velocity_divergence3(U, flags)
        if cfg.normalize_input:
            chan = {"pDiv": p, "UDiv": U, "div": div}[
                cfg.normalize_input_chan]
            s = scale_std(chan, cfg.normalize_input_threshold)
        else:
            s = torch.ones((p.shape[0],), dtype=torch.float32,
                           device=p.device)
        s4 = s[:, None, None, None]
        x = torch.stack([div / s4, flags_to_occupancy(flags)], dim=-1)
        p_hat = punet3_forward(net, packed, x)[..., 0]
        return project_tail3(flags, U, p_hat * s4,
                             cfg.polish_sweeps, damping=cfg.polish_damping)

    return project
