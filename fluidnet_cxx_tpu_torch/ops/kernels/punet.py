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

Training (``ConvNHWC``, through ``net_forward`` whenever autograd records):
a stride-1 conv's backward is two hand kernels, its input gradient kernel B
itself on the weights flipped in both taps with c_in and c_out swapped
(``conv2d_dgrad``) and its weight gradient ``fn_conv2d_wgrad``
(``conv_grad.py``), which computes only the layer's real rows and columns
(``net_forward`` passes them) and writes 0 in the padded ones.
``pack_weights`` pads through ops autograd follows, so the padded channels
pass no gradient to the parameters.
"""
import torch
import torch.nn.functional as F

from . import _build
from .conv_grad import conv2d_wgrad
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
    out = _launch(x, w_hwio, bias, stride, dil, relu, x2, in_scale,
                  scale_mod)
    conv2d_nhwc.launches += 1
    return out


def _launch(x, w_hwio, bias, stride, dil, relu, x2, in_scale, scale_mod):
    """Kernel B on CUDA tensors (``conv2d_nhwc``'s arguments)."""
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
    return out


conv2d_nhwc.launches = 0


def _adjoint(dy, w_hwio):
    """(dy, the weight flipped in both taps with c_in and c_out swapped,
    a zero bias), dy's channels and the weight's rows widened with zeros to
    the stage where they fall short of it (an output layer's 4)."""
    co = dy.shape[-1]
    wt = w_hwio.flip(0, 1).transpose(2, 3)
    cp = padded(co, STAGE)
    if cp != co:
        dy = F.pad(dy, (0, cp - co))
        wt = F.pad(wt, (0, 0, 0, cp - co))
    return dy, wt.contiguous(), dy.new_zeros((wt.shape[3],))


def conv2d_dgrad_plain(dy, w_hwio, dil=1):
    """Plain version of ``conv2d_dgrad``: F.conv2d on the flipped weight."""
    dy, wt, bias = _adjoint(dy, w_hwio)
    return conv2d_nhwc_plain(dy, wt.permute(3, 2, 0, 1), bias, 1, dil)


def conv2d_dgrad(dy, w_hwio, dil=1):
    """Input gradient of a stride-1 SAME conv with the HWIO weight
    ``w_hwio`` (odd k), from the gradient ``dy`` of its output: kernel B on
    the weight flipped in both taps with c_in and c_out swapped, no bias,
    no ReLU (the adjoint of a stride-1 SAME conv is that conv, with the
    same symmetric pads)."""
    if not _build.on_cuda(dy):
        return conv2d_dgrad_plain(dy, w_hwio, dil)
    out = _launch(*_adjoint(dy, w_hwio), 1, dil, False, None, None, 1)
    conv2d_dgrad.launches += 1
    return out


conv2d_dgrad.launches = 0


class ConvNHWC(torch.autograd.Function):
    """``conv2d_nhwc`` at stride 1 with a backward of hand kernels: the
    upstream gradient masked by ``out > 0`` under ReLU (jax's relu
    gradient at 0 is 0 too), then ``conv2d_dgrad`` for the input (skipped
    when it needs none) and ``conv_grad.conv2d_wgrad`` for the weight and
    bias over the layer's real channels ``ci`` -> ``co`` (the padded
    entries of the packed weight's gradient are 0). Saves the input and
    the output."""

    @staticmethod
    def forward(ctx, x, w_hwio, bias, dil, relu, ci, co):
        y = conv2d_nhwc(x, w_hwio, bias, 1, dil, relu)
        ctx.save_for_backward(x, w_hwio, y)
        ctx.dil, ctx.relu, ctx.real = dil, relu, (ci, co)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w_hwio, y = ctx.saved_tensors
        gy = (torch.where(y > 0, gy, 0.0) if ctx.relu else gy).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_dgrad(gy, w_hwio, ctx.dil)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            k = w_hwio.shape[0]
            dw, db = conv2d_wgrad(x, gy, k, 1, ctx.dil,
                                  same_pads(x.shape[1], k, 1, ctx.dil),
                                  *ctx.real)
        return dx, dw, db, None, None, None, None


def conv2d_nhwc_autograd(x, w_hwio, bias, stride=1, dil=1, relu=False,
                         x2=None, in_scale=None, scale_mod=1, real=None):
    """``conv2d_nhwc`` that autograd follows: while it records and a
    tensor needs a gradient, a stride-1 conv without ``x2`` and
    ``in_scale`` runs ``ConvNHWC``, its weight gradient over ``real`` =
    (the layer's real c_in, c_out) of the packed weight's (all of it by
    default); any other conv runs its plain version under autograd on a
    CPU tensor and raises on a CUDA tensor (its backward is the next
    training slice's). Otherwise ``conv2d_nhwc``."""
    tensors = (x, w_hwio, bias, x2, in_scale)
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in tensors)):
        return conv2d_nhwc(x, w_hwio, bias, stride, dil, relu, x2, in_scale,
                           scale_mod)
    if stride == 1 and x2 is None and in_scale is None:
        ci, co = real or w_hwio.shape[2:]
        return ConvNHWC.apply(x, w_hwio, bias, dil, relu, ci, co)
    if not _build.on_cuda(x):
        return conv2d_nhwc_plain(x, w_hwio.permute(3, 2, 0, 1), bias, stride,
                                 dil, relu, x2, in_scale, scale_mod)
    raise NotImplementedError(
        "not ported yet: the gradient of a stride-2, skip-concat or "
        "in_scale conv on the card (PUNet's training, ROADMAP A.5.1)")


def pack_weights(net):
    """HWIO weights of the net's convs for the kernel, from its live
    parameters through ops autograd follows (permute, zero-pad): made under
    ``torch.no_grad()`` they are a detached copy, packed once for
    inference; made while autograd records (a training step packs on every
    call) they pass their gradient back to the parameters, the padded
    channels none. The layers on the thin-channel route
    (``net.thin(name)``) get zero input rows up to a multiple of ``STAGE``
    and zero output columns and bias up to a multiple of ``STAGE``, or of
    4 for the layers in ``net.outputs`` (whose output the forward slices
    to its real channels); the others keep their widths."""
    packed = {}
    for name, conv in net.convs.items():
        co, ci, k, _ = conv.weight.shape
        cip, cop = ci, co
        if net.thin(name):
            cip = padded(ci, STAGE)
            cop = padded(co, 4 if name in net.outputs else STAGE)
        w = F.pad(conv.weight.permute(2, 3, 1, 0),
                  (0, cop - co, 0, cip - ci)).contiguous()
        packed[name] = (w, F.pad(conv.bias, (0, cop - co)))
    return packed


def net_forward(net, packed, x, **kw):
    """Forward of a 2-D conv net (``models/punet.py::ConvNet``) on NHWC
    ``x``, every conv through ``conv2d_nhwc_autograd`` with ``packed``
    (``pack_weights(net)``; the weight gradients over each layer's real
    channels) and the net's assembled inputs widened to
    ``STAGE`` channels. ``kw`` goes to the net (PUNet's ``inv_scale``
    normalises input channel 0 as it is loaded). On a CPU tensor this is
    the padded chain's plain twin."""
    def conv(name, h, x2=None, relu=True, in_scale=None, scale_mod=1):
        w_hwio, b = packed[name]
        _, stride, dil = net.geometry[name]
        co, ci = net.convs[name].weight.shape[:2]
        return conv2d_nhwc_autograd(h, w_hwio, b, stride, dil, relu, x2,
                                    in_scale, scale_mod, (ci, co))

    return net(x, conv=conv, width=STAGE, **kw)
