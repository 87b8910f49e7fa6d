"""Kernel B: one NHWC convolution with fused bias and ReLU, and the forward
of a 2-D conv net that launches it once per layer.

Replaces ``fluidnet_cxx_tpu/ops/pallas/punet_pallas.py::punet_forward_pallas``
(the whole U-Net in one Pallas kernel) with the CUDA kernel in
``csrc/conv2d.cu``: 3xTF32 tensor-core products (float32 accuracy) on the
tile and split-K plan of ``conv_plan.py``, a split layer's partial sums in
a ``torch.empty`` workspace added in a fixed order (bit-equal repeats).
The space-to-depth/depth-to-space reshapes and the skip routing stay
PyTorch, as the JAX wrapper keeps s2d(8)/d2s(8) outside its kernel. Plain
versions: ``conv2d_nhwc_plain`` for one layer (F.conv2d) and the network
module's own forward for the network; a CPU tensor runs them, a CUDA
tensor the kernel.

The same kernel runs every conv of the port's other 2-D nets (JAX computes
them with flax ``nn.Conv``): FluidNetTower, MultiScaleNet and PUNet's
refinement stack, whose 1-16 channel layers the kernel's 32-channel stage
does not take. ``pack_weights`` pads each layer once, at pack time, with
zero input rows up to the stage and zero output columns (and bias) up to
it, or up to 4 for a layer whose output the net slices; the net widens its
assembled inputs with zero channels (``widen``). The padded channels stay
exactly 0 through ReLU, pooling, nearest repeat and bilinear resize, so
activations carry them from layer to layer with no pad pass between.

bfloat16 route (MGCoarse_128, as flax runs it): ``fn_conv2d_bf16`` in the
same source, bf16 ``mma.sync`` with float32 sums, the sum rounded to
bfloat16, then the bias add rounded again (flax ``nn.Conv(dtype=
"bfloat16")`` on JAX's CPU); a bfloat16 net's weights are cast at pack
time. Its backward (``ConvNHWC`` on bfloat16 tensors) is
``fn_conv2d_bf16_dgrad``, ``fn_conv2d_bf16_wgrad`` and
``fn_bias_grad_bf16`` (``conv_grad.py``), with flax's rounding points.

Training (``ConvNHWC``, through ``net_forward`` whenever autograd records):
a conv's backward is hand kernels (``conv_grad.py``), both over the layer's
real channels (``net_forward`` passes them) with 0 in the padded ones: its
input gradient ``fn_conv2d_dgrad`` (``conv2d_dgrad``: one pass per
output-parity class, so a stride-2 conv gathers and multiplies no zero
tap; 3xTF32 ``mma.sync`` on thin layers, ``wgmma`` on the wide ones), split
at a skip concat, and its weight gradient ``fn_conv2d_wgrad``.
``pack_weights`` pads through ops autograd follows, so the padded channels
pass no gradient to the parameters.
"""
import torch
import torch.nn.functional as F

from . import _build
from .conv_grad import (conv2d_dgrad, conv2d_dgrad_bf16, conv2d_wgrad,
                        conv2d_wgrad_bf16, same_pads)
from .conv_plan import CHUNK, plan_conv

# Input channels a stage of the 3xTF32 route: every layer's input is
# padded to a multiple of it.
STAGE = CHUNK["tf32x3"]


def padded(n: int, m: int) -> int:
    """n rounded up to a multiple of m."""
    return -(-n // m) * m


def widen(x, width):
    """NHWC ``x`` with zero channels appended up to ``width``; ``x`` itself
    when ``width`` is None (the plain version's chain)."""
    return x if width is None else F.pad(x, (0, width - x.shape[-1]))


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
    channels) with an OIHW ``weight``; returns NHWC. A bfloat16 ``x`` is
    flax ``nn.Conv(dtype="bfloat16")`` as JAX computes it on the CPU: the
    weight and bias cast to bfloat16, the products summed in float32 (each
    is exact there), the sum rounded to bfloat16, the bias added and the
    result rounded again, then the ReLU; a bfloat16 output."""
    low = x.dtype == torch.bfloat16
    if low:
        if in_scale is not None:
            raise ValueError("the bfloat16 conv takes no in_scale")
        x, weight = x.float(), weight.to(torch.bfloat16).float()
        x2 = None if x2 is None else x2.float()
    x = _scaled(x, in_scale, scale_mod)
    if x2 is not None:
        x = torch.cat([x, x2], dim=-1)
    k = weight.shape[-1]
    ph = same_pads(x.shape[1], k, stride, dil)
    pw = same_pads(x.shape[2], k, stride, dil)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, weight, None if low else bias, stride=stride,
                 dilation=dil)
    if low:
        y = y.to(torch.bfloat16) + bias.to(torch.bfloat16)[:, None, None]
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
    out = _launch(x, w_hwio, bias, stride, dil, relu, x2, in_scale,
                  scale_mod)
    conv2d_nhwc.launches += 1
    return out


def _same_pad(hi, wi, k, stride, dil):
    """The one SAME pad (lo, hi) of both axes that the kernels take."""
    ph = same_pads(hi, k, stride, dil)
    pw = same_pads(wi, k, stride, dil)
    if ph != pw:
        # One pad for both axes: a non-square map passes where its SAME
        # pads agree (the 1000x100 cylinder map does).
        raise ValueError(f"kernel B needs equal SAME pads on both axes: "
                         f"rows {ph}, columns {pw} ({hi}x{wi}, kernel {k}, "
                         f"stride {stride}, dilation {dil})")
    return ph


def _launch(x, w_hwio, bias, stride, dil, relu, x2, in_scale, scale_mod):
    """Kernel B on CUDA tensors (``conv2d_nhwc``'s arguments): the 3xTF32
    route on float32 ``x``, the bfloat16 route on bfloat16 ``x``."""
    n, hi, wi, c1 = x.shape
    k, _, cin, co = w_hwio.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    dev = x.device
    low = x.dtype == torch.bfloat16
    dt = torch.bfloat16 if low else torch.float32
    _build.check(x, "x", dt, (n, hi, wi, c1), dev)
    if x2 is not None:
        _build.check(x2, "x2", dt, (n, hi, wi, c2), dev)
    _build.check(w_hwio, "weight", dt, (k, k, c1 + c2, co), dev)
    _build.check(bias, "bias", torch.float32, (co,), dev)
    if in_scale is not None:
        if low:
            raise ValueError("the bfloat16 conv takes no in_scale")
        _build.check(in_scale, "in_scale", torch.float32, (n,), dev)
    if co % (8 if low else 4) or scale_mod < 1:
        raise ValueError(f"conv2d_nhwc needs co a multiple of "
                         f"{8 if low else 4}")
    ph = _same_pad(hi, wi, k, stride, dil)
    ho, wo = -(-hi // stride), -(-wi // stride)
    m = n * ho * wo
    plan = plan_conv(m, co, k * k, c1, c2, "bf16" if low else "tf32x3")
    out = torch.empty((n, ho, wo, co), dtype=dt, device=dev)
    ws = (torch.empty((plan.splits, m, co), dtype=torch.float32, device=dev)
          if plan.splits > 1 else None)
    if low:
        _build.call("fn_conv2d_bf16", x.data_ptr(), _build.ptr(x2),
                    w_hwio.data_ptr(), bias.data_ptr(), out.data_ptr(),
                    _build.ptr(ws), c1, c2, n, hi, wi, ho, wo, co, k, stride,
                    dil, ph[0], int(relu), plan.bm, plan.bn, plan.warp_m,
                    plan.splits, plan.c_bounds, _build.stream())
        return out
    _build.call("fn_conv2d_nhwc", x.data_ptr(), _build.ptr(x2),
                w_hwio.data_ptr(), bias.data_ptr(), _build.ptr(in_scale),
                out.data_ptr(), _build.ptr(ws), c1, c2, scale_mod, n, hi, wi,
                ho, wo, co, k, stride, dil, ph[0], int(relu), plan.bm,
                plan.bn, plan.warp_m, plan.splits, plan.c_bounds,
                _build.stream())
    return out


conv2d_nhwc.launches = 0


class ConvNHWC(torch.autograd.Function):
    """``conv2d_nhwc`` with a backward of hand kernels, both over the
    layer's real channels ``ci`` -> ``co`` (the padded entries of the
    packed weight's gradient, and the padded channels of the input
    gradient, are 0): the upstream gradient masked by ``out > 0`` under
    ReLU (jax's relu gradient at 0 is 0 too); the input gradient over [x |
    x2] (skipped when neither needs one) from ``conv2d_dgrad``, split into
    x's and x2's channels; ``conv2d_wgrad`` for the weight and bias on the
    input the kernel saw: [x * in_scale | x2], assembled in torch. The
    input and ``in_scale`` of a scaled conv take no gradient (JAX's scale
    comes from data or from the rollout's stop-gradient state): asserted
    by ``conv2d_nhwc_autograd``. On bfloat16 tensors (kernel B's bfloat16
    route) the backward is ``conv2d_dgrad_bf16`` and ``conv2d_wgrad_bf16``
    over the stored channels (the padded ones carry exact zeros): a
    bfloat16 input and weight gradient, a float32 bias gradient of
    bfloat16 values. Saves the inputs and the output."""

    @staticmethod
    def forward(ctx, x, x2, w_hwio, bias, in_scale, stride, dil, relu,
                scale_mod, ci, co):
        y = conv2d_nhwc(x, w_hwio, bias, stride, dil, relu, x2, in_scale,
                        scale_mod)
        ctx.save_for_backward(x, x2, w_hwio, in_scale, y)
        ctx.geom = (stride, dil, relu, scale_mod, ci, co)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, x2, w_hwio, in_scale, y = ctx.saved_tensors
        stride, dil, relu, scale_mod, ci, co = ctx.geom
        gy = (torch.where(y > 0, gy, 0.0) if relu else gy).contiguous()
        dx = dx2 = dw = db = None
        low = gy.dtype == torch.bfloat16
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g = (conv2d_dgrad_bf16(gy, w_hwio, dil, stride, x.shape[1:3])
                 if low else conv2d_dgrad(gy, w_hwio, dil, stride,
                                          x.shape[1:3], ci, co))
            c1 = x.shape[-1]
            dx = g if x2 is None else g[..., :c1]
            dx2 = None if x2 is None else g[..., c1:]
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            xin = _scaled(x, in_scale, scale_mod)
            if x2 is not None:
                xin = torch.cat([xin, x2], dim=-1)
            k = w_hwio.shape[0]
            pads = same_pads(x.shape[1], k, stride, dil)
            dw, db = (conv2d_wgrad_bf16(xin.contiguous(), gy, k, stride, dil,
                                        pads) if low else
                      conv2d_wgrad(xin.contiguous(), gy, k, stride, dil,
                                   pads, ci, co))
        return dx, dx2, dw, db, None, None, None, None, None, None, None


def conv2d_nhwc_autograd(x, w_hwio, bias, stride=1, dil=1, relu=False,
                         x2=None, in_scale=None, scale_mod=1, real=None):
    """``conv2d_nhwc`` that autograd follows: while it records and a
    tensor needs a gradient, ``ConvNHWC`` (stride 1 or 2, with ``x2`` and
    ``in_scale``), its weight gradient over ``real`` = (the layer's real
    c_in, c_out) of the packed weight's (all of it by default; the
    bfloat16 route's gradients run over the stored channels). Raises for a
    gradient of a scaled conv's input or ``in_scale``. Otherwise
    ``conv2d_nhwc``."""
    tensors = (x, w_hwio, bias, x2, in_scale)
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in tensors)):
        return conv2d_nhwc(x, w_hwio, bias, stride, dil, relu, x2, in_scale,
                           scale_mod)
    if in_scale is not None and (x.requires_grad or in_scale.requires_grad):
        raise ValueError("a scaled conv's input and in_scale take no "
                         "gradient (the scale comes from data)")
    ci, co = real or w_hwio.shape[2:]
    return ConvNHWC.apply(x, x2, w_hwio, bias, in_scale, stride, dil, relu,
                          scale_mod, ci, co)


def pack_weights(net):
    """HWIO weights of the net's convs for the kernel, from its live
    parameters through ops autograd follows (permute, zero-pad): made under
    ``torch.no_grad()`` they are a detached copy, packed once for
    inference; made while autograd records (a training step packs on every
    call) they pass their gradient back to the parameters, the padded
    channels none. The layers on the thin-channel route
    (``net.thin(name)``) get zero input rows up to a multiple of ``STAGE``
    and zero output columns and bias up to a multiple of ``STAGE``, or of
    4 (8 in bfloat16) for the layers in ``net.outputs`` (whose output the
    forward slices to its real channels); the others keep their widths. A
    bfloat16 net (``net.compute_dtype``) gets its weights cast to bfloat16
    here, once, and its biases rounded to bfloat16 and kept in float32, as
    flax's ``promote_dtype`` casts the float32 parameters."""
    low = net.compute_dtype == torch.bfloat16
    packed = {}
    for name, conv in net.convs.items():
        co, ci, k, _ = conv.weight.shape
        cip, cop = ci, co
        if net.thin(name):
            cip = padded(ci, STAGE)
            cop = padded(co, (8 if low else 4) if name in net.outputs
                         else STAGE)
        w = F.pad(conv.weight.permute(2, 3, 1, 0),
                  (0, cop - co, 0, cip - ci)).contiguous()
        b = F.pad(conv.bias, (0, cop - co))
        if low:
            w, b = w.to(torch.bfloat16), b.to(torch.bfloat16).float()
        packed[name] = (w, b)
    return packed


def net_forward(net, packed, x, **kw):
    """Forward of a 2-D conv net (``models/punet.py::ConvNet``) on NHWC
    ``x``, every conv through ``conv2d_nhwc_autograd`` with ``packed``
    (``pack_weights(net)``; the weight gradients over each layer's real
    channels) and the net's assembled inputs widened to
    ``STAGE`` channels. ``kw`` goes to the net (PUNet's ``inv_scale``
    normalises input channel 0 as it is loaded). On a CPU tensor this is
    the padded chain's plain twin. A bfloat16 net takes its input cast to
    bfloat16 (each conv casts what it is given, as ``promote_dtype`` does)
    and returns float32."""
    low = net.compute_dtype == torch.bfloat16

    def cast(t):
        return t.to(torch.bfloat16) if low and t is not None else t

    def conv(name, h, x2=None, relu=True, in_scale=None, scale_mod=1):
        w_hwio, b = packed[name]
        _, stride, dil = net.geometry[name]
        co, ci = net.convs[name].weight.shape[:2]
        return conv2d_nhwc_autograd(cast(h), w_hwio, b, stride, dil, relu,
                                    cast(x2), in_scale, scale_mod, (ci, co))

    out = net(cast(x), conv=conv, width=STAGE, **kw)
    return out.float() if low else out
