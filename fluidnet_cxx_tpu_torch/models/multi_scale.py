"""MultiScaleNet ('ScaleNet'): the reference's 3-resolution-branch pressure
CNN (the port of the JAX package's ``models/multi_scale.py``).

A quarter-scale branch of 4 convs on the downsampled input; a half-scale
branch of 6 convs on [the input, the quarter output], both resized to
half scale; a full-scale branch of 6 convs on [the input, the half output
resized to full scale]; a final 1x1 conv. No ReLU after a branch's last
two convs. NHWC; every conv runs through the ``conv`` hook of ``ConvNet``
(kernel B on a CUDA tensor, ops/kernels/punet.py::net_forward).
"""
import torch
import torch.nn.functional as F

from ..ops.kernels.punet import widen
from .punet import ConvNet

# (flax name, widths, kernel sizes) of each branch, in forward order.
BRANCHES = (("convN_4", (32, 64, 32, 1), (3, 3, 3, 3)),
            ("convN_2", (32, 64, 128, 64, 32, 1), (5, 3, 3, 3, 3, 3)),
            ("convN_1", (32, 64, 128, 64, 32, 8), (5, 3, 3, 3, 3, 5)))


def multiscale_table(in_ch: int):
    """[(name, c_in, c_out, kernel, stride, dilation)]: ``<branch>/Conv_i``
    and ``final``, as the flax tree names them."""
    t = []
    for branch, widths, kernels in BRANCHES:
        ci = in_ch if branch == "convN_4" else in_ch + 1
        for i, (wd, k) in enumerate(zip(widths, kernels)):
            t.append((f"{branch}/Conv_{i}", ci, wd, k, 1, 1))
            ci = wd
    t.append(("final", ci, 1, 1, 1, 1))
    return t


def resize_weights(m: int, n: int):
    """(m, n) float32 weights of a linear resize of an axis of m cells to
    n, as ``jax.image``'s ``compute_weight_mat`` makes them for the
    triangle kernel (antialiased: widened by the scale where it
    downsamples; each column normalised to sum 1)."""
    inv = m / n
    sample = (torch.arange(n, dtype=torch.float32) + 0.5) * inv - 0.5
    d = (sample[None, :] - torch.arange(m, dtype=torch.float32)[:, None])
    w = torch.clamp(1.0 - d.abs() / max(inv, 1.0), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(x, hw):
    """Bilinear resize of NHWC ``x`` to ``hw`` as ``jax.image.resize(...,
    "linear")`` computes it: half-pixel centres and, where it downsamples,
    the triangle filter widened by the scale (torch's antialias=True;
    without it a 4x downsample differs by O(1)). A bfloat16 ``x`` is JAX's
    einsum of it with the two axes' weights cast to bfloat16: one axis,
    rounded to bfloat16, then the other, rounded again, the axis first that
    the einsum's path takes first (the fewer operations; rows on a tie)."""
    if x.dtype != torch.bfloat16:
        return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                             mode="bilinear", align_corners=False,
                             antialias=True).permute(0, 2, 3, 1)
    _, h, w, _ = x.shape
    big, wide = hw

    def rows(t):
        wt = resize_weights(h, big).to(t.device, torch.bfloat16).float()
        return torch.einsum("bhwc,hH->bHwc", t.float(), wt).to(x.dtype)

    def cols(t):
        wt = resize_weights(w, wide).to(t.device, torch.bfloat16).float()
        return torch.einsum("bhwc,wW->bhWc", t.float(), wt).to(x.dtype)

    if h * big * w + big * w * wide <= w * wide * h + h * wide * big:
        return cols(rows(x))
    return rows(cols(x))


class MultiScaleNet(ConvNet):
    """NHWC (b, h, w, in_ch) -> (b, h, w, 1) (JAX ``MultiScaleNet``).
    ``dtype`` is flax's: in bfloat16 the branches' outputs stay bfloat16
    through their resizes (``resize``), and the concats with the float32
    input's resizes are float32, as in flax."""
    outputs = ("convN_4/Conv_3", "convN_2/Conv_5", "final")

    def __init__(self, in_ch: int = 2, dtype: str = "float32"):
        super().__init__(multiscale_table(in_ch), dtype)
        self.in_ch = in_ch

    def _branch(self, name, x, conv):
        n = next(len(widths) for b, widths, _ in BRANCHES if b == name)
        for i in range(n):
            x = conv(f"{name}/Conv_{i}", x, relu=i < n - 2)
        return x

    def forward(self, x, conv=None, width=None):
        """``conv`` and ``width``: see ``ConvNet``."""
        conv = conv or self._plain_conv
        h, w = x.shape[1], x.shape[2]
        quarter = (int(h * 0.25), int(w * 0.25))
        half = (int(h * 0.5), int(w * 0.5))
        q = self._branch("convN_4", widen(resize(x, quarter), width),
                         conv)[..., :1]
        hf = self._branch("convN_2", widen(torch.cat(
            [resize(x, half), resize(q, half)], dim=-1), width),
            conv)[..., :1]
        f = self._branch("convN_1", widen(torch.cat(
            [x, resize(hf, (h, w))], dim=-1), width), conv)
        return conv("final", f, relu=False)[..., :1].float()
