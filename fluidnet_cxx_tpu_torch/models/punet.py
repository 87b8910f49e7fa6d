"""PUNet — the learned pressure projection's U-Net (twin of the JAX
package's ``models/punet.py``), and ``ConvNet``, the base of the port's
2-D conv nets.

space-to-depth(patch) -> 1x1 embed -> encoder (stride-2 3x3 downs, 3x3
convs) -> bottleneck 3x3 convs (optionally dilated) -> decoder (1x1 expand +
depth-to-space(2), skip concat [up | skip], 3x3 convs) -> 1x1 head ->
depth-to-space(patch) -> optionally the thin full-resolution refinement
stack (``refine_convs`` 3x3 convs of ``refine_ch`` channels over [p | the
raw input], a 3x3 conv to 1 channel, added to p).

Layouts follow flax so the converted weights drop in: the network takes and
returns NHWC; space_to_depth orders channels (py, px, c) like flax (torch's
pixel_unshuffle orders them (c, py, px)); padding is flax 'SAME', which on
an even input pads a stride-2 conv (0, 1). Parameters are ``nn.Conv2d``s
(OIHW) named as the flax modules are. This module's forward is the plain
version of the conv kernel (ops/kernels/punet.py).
"""
import torch
from torch import nn

from ..ops.kernels.punet import _scaled, conv2d_nhwc_plain, widen

# flax's ``dtype`` names of the compute types the 2-D nets take.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def space_to_depth(x, p: int):
    """(b, h, w, c) -> (b, h/p, w/p, p*p*c), channels ordered (py, px, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // p, w // p, p * p * c)


def depth_to_space(x, p: int):
    """(b, h, w, p*p*c) -> (b, h*p, w*p, c). Inverse of space_to_depth."""
    b, h, w, cpp = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * p, w * p, c)


def layer_table(in_ch, patch, widths, level_convs, bottleneck_convs,
                bottleneck_dilation, refine_ch=8, refine_convs=0):
    """[(name, c_in, c_out, kernel, stride, dilation)] in forward order."""
    widths = tuple(widths)
    t = [("embed", patch * patch * in_ch, widths[0], 1, 1, 1)]
    for i, wd in enumerate(widths):
        if i > 0:
            t.append((f"down{i}", widths[i - 1], wd, 3, 2, 1))
        for j in range(level_convs):
            t.append((f"enc{i}_{j}", wd, wd, 3, 1, 1))
    for j in range(bottleneck_convs):
        t.append((f"mid{j}", widths[-1], widths[-1], 3, 1,
                  bottleneck_dilation))
    for i in range(len(widths) - 2, -1, -1):
        wd = widths[i]
        t.append((f"up{i}", widths[i + 1], 4 * wd, 1, 1, 1))
        for j in range(level_convs):
            t.append((f"dec{i}_{j}", 2 * wd if j == 0 else wd, wd, 3, 1, 1))
    t.append(("head", widths[0], patch * patch, 1, 1, 1))
    for j in range(refine_convs):
        t.append((f"ref{j}", 1 + in_ch if j == 0 else refine_ch, refine_ch,
                  3, 1, 1))
    if refine_convs:
        t.append(("ref_out", refine_ch, 1, 3, 1, 1))
    return t


class ConvNet(nn.Module):
    """A 2-D net of named flax-'SAME' convolutions, NHWC in and out.

    ``table`` is [(name, c_in, c_out, kernel, stride, dilation)]; the
    parameters are ``nn.Conv2d``s (OIHW) under ``convs.<name>``, named as
    the flax modules are (a nested flax name joined with "/"). A
    subclass's forward takes ``conv`` (the per-layer convolution: the
    plain version on these weights by default; ops/kernels/punet.py::
    ``net_forward`` passes kernel B's on padded weights) and ``width``
    (None, or the kernel path's stage: each input the net assembles is
    widened to it with zero channels). ``thin(name)`` says whether a
    layer is on kernel B's thin-channel route (its weights padded by
    ops/kernels/punet.py::pack_weights): every layer by default.
    ``outputs`` are the layers whose output the forward slices to its
    real channels. ``compute_dtype`` is flax's ``dtype`` of the convs
    (``dtype``: "float32" or "bfloat16"): the parameters stay float32 and
    each conv casts its input, weight and bias to it, and the forward
    returns float32, as the flax nets do."""
    outputs = ()

    def __init__(self, table, dtype: str = "float32"):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"{type(self).__name__} dtype {dtype!r}: the "
                             f"port's 2-D nets take {sorted(DTYPES)}")
        self.compute_dtype = DTYPES[dtype]
        self.table = table
        self.geometry = {name: (k, s, d) for name, _, _, k, s, d in table}
        self.convs = nn.ModuleDict({
            name: nn.Conv2d(ci, co, k, stride=s, dilation=d)
            for name, ci, co, k, s, d in table})

    def _plain_conv(self, name, x, x2=None, relu=True, in_scale=None,
                    scale_mod=1):
        c = self.convs[name]
        _, stride, dil = self.geometry[name]
        if self.compute_dtype == torch.bfloat16:
            x = x.to(torch.bfloat16)
            x2 = None if x2 is None else x2.to(torch.bfloat16)
        return conv2d_nhwc_plain(x, c.weight, c.bias, stride, dil, relu, x2,
                                 in_scale, scale_mod)

    def thin(self, name) -> bool:
        return True


class PUNet(ConvNet):
    """Learned Poisson solve: NHWC (b, h, w, in_ch) -> (b, h, w, 1).

    h and w must be divisible by patch * 2**(len(widths)-1). Only the
    refinement stack is on the thin-channel route: the U-Net's layers keep
    their widths (kernel B takes multiples of 32). ``dtype`` is flax
    PUNet's: "float32" (FluidNet's ``compute_dtype`` default) or
    "bfloat16" (flax PUNet's own default, which MGCoarseNet keeps):
    activations between the convs in that type, the output float32."""
    outputs = ("ref_out",)

    def thin(self, name) -> bool:
        return name.startswith("ref")

    def __init__(self, in_ch: int = 2, patch: int = 8,
                 widths=(128, 128), level_convs: int = 1,
                 bottleneck_convs: int = 3, bottleneck_dilation: int = 1,
                 refine_ch: int = 8, refine_convs: int = 0,
                 dtype: str = "float32"):
        super().__init__(layer_table(in_ch, patch, widths, level_convs,
                                     bottleneck_convs, bottleneck_dilation,
                                     refine_ch, refine_convs), dtype)
        self.in_ch = in_ch
        self.patch = patch
        self.widths = tuple(widths)
        self.level_convs = level_convs
        self.bottleneck_convs = bottleneck_convs
        self.refine_convs = refine_convs

    @classmethod
    def from_config(cls, cfg):
        """Build from a ``ModelConfig`` (``compute_dtype`` float32 or
        bfloat16)."""
        if cfg.model != "PUNet":
            raise ValueError(f"model {cfg.model!r} is not a PUNet")
        return cls(in_ch=cfg.in_dims, patch=cfg.punet_patch,
                   widths=cfg.punet_widths,
                   level_convs=cfg.punet_level_convs,
                   bottleneck_convs=cfg.punet_bottleneck_convs,
                   bottleneck_dilation=cfg.punet_bottleneck_dilation,
                   refine_ch=cfg.punet_refine_ch,
                   refine_convs=cfg.punet_refine_convs,
                   dtype=cfg.compute_dtype)

    def forward(self, x, inv_scale=None, conv=None, width=None):
        """``inv_scale`` (b,) optionally multiplies input channel 0 (the
        physical channel) before the embed conv and the refinement stack.
        ``conv`` and ``width``: see ``ConvNet``."""
        conv = conv or self._plain_conv
        raw = x
        x = space_to_depth(x, self.patch)
        x = conv("embed", x, in_scale=inv_scale, scale_mod=self.in_ch)
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
            x = depth_to_space(conv(f"up{i}", x, relu=False), 2)
            x = conv(f"dec{i}_0", x, x2=skips[i])
            for j in range(1, self.level_convs):
                x = conv(f"dec{i}_{j}", x)
        p = depth_to_space(conv("head", x, relu=False), self.patch)
        if self.refine_convs:
            raw = _scaled(raw, inv_scale, self.in_ch)
            r = widen(torch.cat([p, raw], dim=-1), width)
            for j in range(self.refine_convs):
                r = conv(f"ref{j}", r)
            p = p + conv("ref_out", r, relu=False)[..., :1]
        return p.float()
