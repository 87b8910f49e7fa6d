"""Kernel B: one NHWC convolution with fused bias and ReLU, and the PUNet
forward that launches it once per layer.

Replaces ``fluidnet_cxx_tpu/ops/pallas/punet_pallas.py::punet_forward_pallas``
(the whole U-Net in one Pallas kernel) with the CUDA kernel in
``csrc/conv2d.cu``: 3xTF32 tensor-core products (float32 accuracy) on the
tile and split-K plan of ``conv_plan.py``, a split layer's partial sums in
a ``torch.empty`` workspace added in a fixed order (bit-equal repeats).
The space-to-depth/depth-to-space reshapes and the skip routing stay
PyTorch, as the JAX wrapper keeps s2d(8)/d2s(8) outside its kernel. Plain
versions: ``conv2d_nhwc_plain`` for one layer (F.conv2d) and the ``PUNet``
module's own forward for the network; a CPU tensor runs them, a CUDA
tensor the kernel.
"""
import torch
import torch.nn.functional as F

from . import _build
from .conv_plan import plan_conv


def same_pads(size: int, k: int, stride: int, dil: int):
    """(lo, hi) padding of flax/XLA 'SAME' — on an even input a stride-2
    3x3 conv pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dil + 1 - size, 0)
    return total // 2, total - total // 2


def _scaled(x, in_scale, scale_mod):
    """Multiply channels c % scale_mod == 0 of NHWC ``x`` by in_scale[n]."""
    if in_scale is None:
        return x
    sel = torch.arange(x.shape[-1], device=x.device) % scale_mod == 0
    fac = torch.where(sel[None, :], in_scale[:, None],
                      torch.ones((), dtype=x.dtype, device=x.device))
    return x * fac[:, None, None, :]


def conv2d_nhwc_plain(x, weight, bias, stride=1, dil=1, relu=False, x2=None,
                      in_scale=None, scale_mod=1):
    """Plain version: SAME conv of NHWC ``x`` (and ``x2`` concatenated on
    channels) with an OIHW ``weight``; returns NHWC."""
    x = _scaled(x, in_scale, scale_mod)
    if x2 is not None:
        x = torch.cat([x, x2], dim=-1)
    k = weight.shape[-1]
    ph = same_pads(x.shape[1], k, stride, dil)
    pw = same_pads(x.shape[2], k, stride, dil)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, weight, bias, stride=stride, dilation=dil)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_nhwc(x, w_hwio, bias, stride=1, dil=1, relu=False, x2=None,
                in_scale=None, scale_mod=1):
    """SAME conv of NHWC ``x`` (channels [x | x2]) with an HWIO weight
    (k, k, c_in, c_out); bias and ReLU fused. Returns NHWC."""
    if not _build.on_cuda(x):
        return conv2d_nhwc_plain(x, w_hwio.permute(3, 2, 0, 1), bias, stride,
                                 dil, relu, x2, in_scale, scale_mod)
    n, hi, wi, c1 = x.shape
    k, _, cin, co = w_hwio.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    dev = x.device
    _build.check(x, "x", torch.float32, (n, hi, wi, c1), dev)
    if x2 is not None:
        _build.check(x2, "x2", torch.float32, (n, hi, wi, c2), dev)
    _build.check(w_hwio, "weight", torch.float32, (k, k, c1 + c2, co), dev)
    _build.check(bias, "bias", torch.float32, (co,), dev)
    if in_scale is not None:
        _build.check(in_scale, "in_scale", torch.float32, (n,), dev)
    if co % 4 or scale_mod < 1:
        raise ValueError("conv2d_nhwc needs co a multiple of 4")
    ph = same_pads(hi, k, stride, dil)
    pw = same_pads(wi, k, stride, dil)
    if ph != pw:
        # One pad for both axes: a non-square map passes where its SAME
        # pads agree (the 1000x100 cylinder map does).
        raise ValueError(f"conv2d_nhwc needs equal SAME pads on both axes: "
                         f"rows {ph}, columns {pw} ({hi}x{wi}, kernel {k}, "
                         f"stride {stride}, dilation {dil})")
    ho, wo = -(-hi // stride), -(-wi // stride)
    m = n * ho * wo
    plan = plan_conv(m, co, k * k, c1, c2, "tf32x3")
    out = torch.empty((n, ho, wo, co), dtype=torch.float32, device=dev)
    ws = (torch.empty((plan.splits, m, co), dtype=torch.float32, device=dev)
          if plan.splits > 1 else None)
    _build.call("fn_conv2d_nhwc", x.data_ptr(), _build.ptr(x2),
                w_hwio.data_ptr(), bias.data_ptr(), _build.ptr(in_scale),
                out.data_ptr(), _build.ptr(ws), c1, c2, scale_mod, n, hi, wi,
                ho, wo, co, k, stride, dil, ph[0], int(relu), plan.bm,
                plan.bn, plan.warp_m, plan.splits, plan.c_bounds,
                _build.stream())
    conv2d_nhwc.launches += 1
    return out


conv2d_nhwc.launches = 0


def pack_weights(net):
    """HWIO copies of the PUNet's conv weights, made once for the kernel."""
    return {name: (conv.weight.detach().permute(2, 3, 1, 0).contiguous(),
                   conv.bias.detach().contiguous())
            for name, conv in net.convs.items()}


def punet_forward(net, packed, x, inv_scale=None):
    """PUNet forward of NHWC ``x`` (b, h, w, C) -> (b, h, w, 1), every conv
    through ``conv2d_nhwc``. ``packed`` is ``pack_weights(net)``;
    ``inv_scale`` (b,) normalises input channel 0 as it is loaded."""
    def conv(name, h, x2=None, relu=True, in_scale=None, scale_mod=1):
        w_hwio, b = packed[name]
        _, stride, dil = net.geometry[name]
        return conv2d_nhwc(h, w_hwio, b, stride, dil, relu, x2, in_scale,
                           scale_mod)

    return net(x, inv_scale=inv_scale, conv=conv)
