"""Kernel N: one NDHWC 3-D convolution with fused bias and ReLU, and the
PUNet3 forward that launches it once per layer.

Replaces ``fluidnet_cxx_tpu/ops/pallas/punet3_pallas.py::
punet3_forward_pallas`` (the whole 3-D U-Net in one Pallas kernel) with the
CUDA kernel in ``csrc/conv3d.cu``: bf16 tensor cores (the concat's float32
half through an exact bf16x3 split) on the tile and split-K plan of
``conv_plan.py``; the all-float32 net takes a SIMT route. A layer with
more than one split gets a float32 workspace (splits, cells, co) from
``torch.empty`` and its partial sums are added in a fixed order, so repeats
are bit-equal. The space-to-depth/depth-to-space reshapes (the patchify,
the up conv's ``depth_to_space3(2)`` and the head's
``depth_to_space3(patch)``) stay PyTorch, as the JAX wrapper keeps them in
XLA. Plain versions: ``conv3d_ndhwc_plain`` for one layer
(F.conv3d) and the ``PUNet3`` module's own forward for the network; a CPU
tensor runs them, a CUDA tensor the kernel.

Rounding (``compute_dtype="bfloat16"``), two routes:

* ``rounding="fused"`` (the fused forward, as the TPU kernel rounds): the
  input and every weight are bfloat16, each product is taken in float32
  and summed in float32, the bias is added in float32, a ReLU layer rounds
  its output to bfloat16, and the layers without a ReLU (the decoder's up
  conv and the head) keep float32 outputs;
* ``rounding="flax"`` (the flax path, flax ``nn.Conv(dtype="bfloat16")``
  as JAX computes it on the CPU): the same products and float32 sums, the
  sum rounded to bfloat16, the bias (rounded to bfloat16) added and the
  result rounded again (``round_sum``), every layer's output bfloat16, the
  up conv's and the head's too, so the decoder's concat is bfloat16 on
  both halves; the network's output is cast to float32 at the end.

Tensors carry those dtypes between the layers; with ``"float32"`` nothing
is rounded and the two routes are the same.

Training (``ConvNDHWC``, through ``conv3d_ndhwc_autograd`` whenever
autograd records, on the flax route and in float32): the backward of a
conv is the hand kernels of ``conv_grad3.py`` on a CUDA tensor,
``fn_conv3d_dgrad`` for the input gradient (split at the decoder's concat
into its up and skip halves) and ``fn_conv3d_wgrad`` for the weight and
bias gradients, at flax's rounding points; their plain versions on a CPU
tensor, and always for the module's own plain forward. ``pack_weights3``
casts and permutes the live parameters through ops autograd follows, so
the gradients reach them as JAX's reach flax's float32 parameters:
rounded to bfloat16, then float32. The fused route has no backward.
"""
import types

import torch
import torch.nn.functional as F

from . import _build
from .conv_grad3 import (conv3d_dgrad, conv3d_dgrad_plain, conv3d_wgrad,
                         conv3d_wgrad_plain)
from .conv_plan import plan_conv
from .punet import same_pads

# Bits of the kernel's ``types`` argument: which operands are bfloat16.
_X1_BF16, _X2_BF16, _W_BF16, _OUT_BF16 = 1, 2, 4, 8
_DTYPES = (torch.float32, torch.bfloat16)
# The launches of N's flax route (round_sum), which also count on
# conv3d_ndhwc.
flax_route = types.SimpleNamespace(launches=0)


def _pads3(x, k: int, stride: int):
    """flax 'SAME' (lo, hi) pads of the three spatial axes of NDHWC ``x``."""
    return [same_pads(x.shape[1 + a], k, stride, 1) for a in range(3)]


def conv3d_ndhwc_plain(x, weight, bias, stride=1, relu=False, x2=None,
                       out_dtype=torch.float32, round_sum=False):
    """Plain version: SAME conv of NDHWC ``x`` (and ``x2`` concatenated on
    channels) with an OIDHW ``weight``, products and sums in float32;
    returns NDHWC in ``out_dtype``. ``round_sum`` (bfloat16 out): the sum
    rounded to bfloat16, then the bias, rounded to bfloat16, added and the
    result rounded again, as flax's bfloat16 conv."""
    h = x.float()
    if x2 is not None:
        h = torch.cat([h, x2.float()], dim=-1)
    (d0, d1), (h0, h1), (w0, w1) = _pads3(x, weight.shape[-1], stride)
    hn = F.pad(h.permute(0, 4, 1, 2, 3), (w0, w1, h0, h1, d0, d1))
    if round_sum:
        y = F.conv3d(hn, weight.float(), None, stride=stride)
        y = y.to(out_dtype) + bias.to(out_dtype)[:, None, None, None]
    else:
        y = F.conv3d(hn, weight.float(), bias.float(), stride=stride)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 4, 1).to(out_dtype).contiguous()


def conv3d_ndhwc(x, w_dhwio, bias, stride=1, relu=False, x2=None,
                 out_dtype=torch.float32, round_sum=False):
    """SAME conv of NDHWC ``x`` (channels [x | x2]) with a DHWIO weight
    (k, k, k, c_in, c_out); bias and ReLU fused. ``x``, ``x2`` and the
    weight are float32 or bfloat16 (each product in float32), the bias
    float32. Returns NDHWC in ``out_dtype`` (float32 or bfloat16);
    ``round_sum`` rounds the sum to bfloat16 before the bias add (the flax
    route: give the bias rounded to bfloat16). The kernel takes the dtype
    sets of the PUNet3 forwards (all float32, or bfloat16 weights:
    csrc/conv3d.cu::launch_types) and refuses others."""
    if not _build.on_cuda(x):
        return conv3d_ndhwc_plain(x, w_dhwio.permute(4, 3, 0, 1, 2), bias,
                                  stride, relu, x2, out_dtype, round_sum)
    n, di, hi, wi, c1 = x.shape
    k, _, _, cin, co = w_dhwio.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    dev = x.device
    for name, t in (("x", x), ("x2", x2), ("weight", w_dhwio)):
        if t is not None and t.dtype not in _DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; conv3d_ndhwc "
                             "takes float32 or bfloat16")
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: float32 or bfloat16")
    if round_sum and out_dtype != torch.bfloat16:
        raise ValueError("round_sum rounds to a bfloat16 output")
    _build.check(x, "x", x.dtype, (n, di, hi, wi, c1), dev)
    if x2 is not None:
        _build.check(x2, "x2", x2.dtype, (n, di, hi, wi, c2), dev)
    _build.check(w_dhwio, "weight", w_dhwio.dtype, (k, k, k, c1 + c2, co),
                 dev)
    _build.check(bias, "bias", torch.float32, (co,), dev)
    if k not in (1, 3) or stride not in (1, 2):
        raise ValueError("conv3d_ndhwc needs k 1 or 3 and stride 1 or 2")
    pads = _pads3(x, k, stride)
    if len({p[0] for p in pads}) != 1:
        raise ValueError("conv3d_ndhwc needs the same low pad on every axis")
    types = ((_X1_BF16 if x.dtype == torch.bfloat16 else 0)
             | (_X2_BF16 if x2 is not None and x2.dtype == torch.bfloat16
                else 0)
             | (_W_BF16 if w_dhwio.dtype == torch.bfloat16 else 0)
             | (_OUT_BF16 if out_dtype == torch.bfloat16 else 0))
    if co % (4 if types == 0 else 8):
        raise ValueError(f"conv3d_ndhwc needs co a multiple of 8 (4 in "
                         f"float32), got {co}")
    do, ho, wo = (-(-s // stride) for s in (di, hi, wi))
    m = n * do * ho * wo
    plan = plan_conv(m, co, k ** 3, c1, c2, "simt" if types == 0 else "bf16")
    out = torch.empty((n, do, ho, wo, co), dtype=out_dtype, device=dev)
    ws = (torch.empty((plan.splits, m, co), dtype=torch.float32, device=dev)
          if plan.splits > 1 else None)
    _build.call("fn_conv3d_ndhwc", x.data_ptr(), _build.ptr(x2),
                w_dhwio.data_ptr(), bias.data_ptr(), out.data_ptr(),
                _build.ptr(ws), c1, c2, n, di, hi, wi, do, ho, wo, co, k,
                stride, pads[0][0], int(relu), types, int(round_sum),
                plan.bm, plan.bn,
                plan.warp_m, plan.splits, plan.c_bounds, _build.stream())
    conv3d_ndhwc.launches += 1
    flax_route.launches += bool(round_sum)
    return out


conv3d_ndhwc.launches = 0


class ConvNDHWC(torch.autograd.Function):
    """``conv3d_ndhwc`` (``plain``: ``conv3d_ndhwc_plain``) with a
    backward at flax's rounding points: the upstream gradient (in the
    output's dtype) masked by ``out > 0`` under ReLU (jax's relu gradient
    at 0 is 0 too); the input gradient over [x | x2] (skipped when neither
    needs one), split into x's and x2's channels; the weight and bias
    gradients on the input the kernel saw, [x | x2] assembled in torch.
    The gradients are ``conv_grad3.py``'s: the kernels on a CUDA tensor,
    the plain versions on a CPU tensor or with ``plain``. Saves the inputs
    and the output."""

    @staticmethod
    def forward(ctx, x, x2, w_dhwio, bias, stride, relu, out_dtype,
                round_sum, plain):
        if plain:
            y = conv3d_ndhwc_plain(x, w_dhwio.permute(4, 3, 0, 1, 2), bias,
                                   stride, relu, x2, out_dtype, round_sum)
        else:
            y = conv3d_ndhwc(x, w_dhwio, bias, stride, relu, x2, out_dtype,
                             round_sum)
        ctx.save_for_backward(x, x2, w_dhwio, y)
        ctx.geom = (stride, relu, plain)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, x2, w_dhwio, y = ctx.saved_tensors
        stride, relu, plain = ctx.geom
        gy = (torch.where(y > 0, gy, 0.0) if relu else gy).contiguous()
        dgrad = conv3d_dgrad_plain if plain else conv3d_dgrad
        wgrad = conv3d_wgrad_plain if plain else conv3d_wgrad
        dx = dx2 = dw = db = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g = dgrad(gy, w_dhwio, stride, tuple(x.shape[1:4]))
            c1 = x.shape[-1]
            dx = g if x2 is None else g[..., :c1]
            dx2 = None if x2 is None else g[..., c1:]
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            xin = x if x2 is None else torch.cat([x, x2], dim=-1)
            dw, db = wgrad(xin.contiguous(), gy, w_dhwio.shape[0], stride)
        return dx, dx2, dw, db, None, None, None, None, None


def conv3d_ndhwc_autograd(x, w_dhwio, bias, stride=1, relu=False, x2=None,
                          out_dtype=torch.float32, round_sum=False,
                          plain=False):
    """``conv3d_ndhwc`` (``plain``: ``conv3d_ndhwc_plain``) that autograd
    follows: while it records and a tensor needs a gradient, ``ConvNDHWC``
    on the flax route (``round_sum``) or in float32; the kernel's backward
    on the card runs in bfloat16 only (``conv_grad3.py`` raises for a
    float32 one). Raises for the fused route, which has no backward.
    Otherwise the forward alone."""
    tensors = (x, x2, w_dhwio, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        if w_dhwio.dtype != torch.float32 and not round_sum:
            raise ValueError("no gradient on kernel N's fused route: "
                             "FluidNet3 trains on the flax route")
        return ConvNDHWC.apply(x, x2, w_dhwio, bias, stride, relu,
                               out_dtype, round_sum, plain)
    if plain:
        return conv3d_ndhwc_plain(x, w_dhwio.permute(4, 3, 0, 1, 2), bias,
                                  stride, relu, x2, out_dtype, round_sum)
    return conv3d_ndhwc(x, w_dhwio, bias, stride, relu, x2, out_dtype,
                        round_sum)


def pack_layer3(net, conv):
    """(DHWIO weight in the net's compute dtype, float32 bias rounded to
    bfloat16 first on the flax route) of one of ``net``'s convs, from its
    live parameters through ops autograd follows: made under
    ``torch.no_grad()`` a detached copy, made while autograd records the
    path of the gradient back to the parameters."""
    b = conv.bias.to(torch.bfloat16) if net.round_sum else conv.bias
    return (conv.weight.to(net.act_dtype).permute(2, 3, 4, 1, 0)
            .contiguous(), b.float().contiguous())


def pack_weights3(net):
    """``pack_layer3`` of every conv of the PUNet3, for the kernel: an
    inference caller packs once (under ``torch.no_grad()``), a training
    step on every call."""
    return {name: pack_layer3(net, conv) for name, conv in net.convs.items()}


def punet3_forward(net, packed, x):
    """PUNet3 forward of NDHWC ``x`` (b, d, h, w, C) float32 -> (b, d, h,
    w, 1) float32, every conv through ``conv3d_ndhwc`` on the net's
    rounding route (``conv3d_ndhwc_autograd`` on the trainable ones: the
    flax route and float32). ``packed`` is ``pack_weights3(net)``."""
    fn = conv3d_ndhwc_autograd if net.trainable else conv3d_ndhwc

    def conv(name, h, x2=None, relu=True):
        w_dhwio, b = packed[name]
        return fn(h, w_dhwio, b, net.strides[name], relu, x2,
                  net.out_dtype(relu), net.round_sum)

    return net(x, conv=conv)
