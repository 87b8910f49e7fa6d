"""The gradients of kernel N's convolution on the flax route, both hand
kernels in ``csrc/conv3d_grad.cu``: the input gradient ``fn_conv3d_dgrad``
(``conv3d_dgrad``) and the weight gradient ``fn_conv3d_wgrad``
(``conv3d_wgrad``, with the bias gradient of ``conv_grad.py::bias_grad``)
of one SAME NDHWC 3-D conv (kernel 1 or 3, stride 1 or
2) from the gradient of its output. They replace no TPU kernel: JAX lets
XLA differentiate flax ``nn.Conv(dtype="bfloat16")``; the port needs them
because every conv of FluidNet3 on the card runs on kernel N. The autograd
function of ``ops/kernels/punet3.py`` (``ConvNDHWC``) calls them.

Rounding points, flax's on JAX's CPU: the upstream gradient is bfloat16
(the ReLU mask applied by the caller), every product exact in float32, the
input and weight gradients summed in float32 and rounded to bfloat16 once;
the bias gradient is the transpose of the bias's broadcast, a reduction of
the bfloat16 upstream gradient that XLA on the CPU accumulates in
bfloat16, each add rounded, in the order of its tree reduction
(``conv_grad.py::bias_windows``: the cells in order while every reduced
axis is at most 32 long; ``bias_grad_plain``; a float32 sum rounded once
misses it by up to hundreds of ulps), kept in float32. In float32 nothing
is rounded.

Kernels: bf16 ``mma.sync`` with float32 sums, as N's forward body. The
input gradient runs over dx's output-parity classes (``dgrad_table3``: at
stride 2 each class takes only the taps of its parity) with the weight's
channel axes swapped here; the weight gradient reduces over the output
cells per tap. Both split their reductions (``grad_splits``) and add the
float32 partials in a fixed order, so repeats are bit-equal.

Plain versions: ``F.conv_transpose3d`` cut to the SAME window, and
``torch.nn.grad.conv3d_weight`` on the padded input with a sum of dy, in
float32 on bf16-exact operands, then the rounding. A CPU tensor runs them,
a CUDA tensor the kernels (bfloat16 only: a float32 conv has no backward
kernel on the card).
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .conv_grad import BF16_CHUNK as CHUNK
from .conv_grad import (DGRAD_TILE, WGRAD_TILE, _axis_classes, bias_grad,
                        bias_grad_plain, grad_splits, same_pads)


def _pads3(shape, k, stride):
    return [same_pads(s, k, stride, 1) for s in shape]


def conv3d_dgrad_plain(dy, w_dhwio, stride, in_shape):
    """Plain version of ``conv3d_dgrad``: F.conv_transpose3d of ``dy``
    (n, do, ho, wo, co) with the DHWIO weight in float32, cut to the
    SAME-padded window of the input map ``in_shape`` (di, hi, wi), rounded
    to dy's dtype. Returns NDHWC."""
    k = w_dhwio.shape[0]
    lo = [p[0] for p in _pads3(in_shape, k, stride)]
    g = F.conv_transpose3d(dy.float().permute(0, 4, 1, 2, 3),
                           w_dhwio.float().permute(4, 3, 0, 1, 2),
                           stride=stride)
    short = [max(0, lo[i] + in_shape[i] - g.shape[2 + i]) for i in range(3)]
    g = F.pad(g, (0, short[2], 0, short[1], 0, short[0]))
    g = g[:, :, lo[0]:lo[0] + in_shape[0], lo[1]:lo[1] + in_shape[1],
          lo[2]:lo[2] + in_shape[2]]
    return g.permute(0, 2, 3, 4, 1).to(dy.dtype).contiguous()


def conv3d_wgrad_plain(x, dy, k, stride):
    """Plain version of ``conv3d_wgrad``: (dW (k, k, k, ci, co) DHWIO in
    x's dtype, from float32 sums rounded once; db (co,) float32,
    ``bias_grad_plain``) of a SAME conv of NDHWC ``x`` from NDHWC
    ``dy``."""
    pads = _pads3(x.shape[1:4], k, stride)
    (d0, d1), (h0, h1), (w0, w1) = pads
    xn = F.pad(x.float().permute(0, 4, 1, 2, 3), (w0, w1, h0, h1, d0, d1))
    dw = torch.nn.grad.conv3d_weight(
        xn, (dy.shape[-1], x.shape[-1], k, k, k),
        dy.float().permute(0, 4, 1, 2, 3), stride=stride)
    return (dw.permute(2, 3, 4, 1, 0).to(x.dtype).contiguous(),
            bias_grad_plain(dy))


@functools.lru_cache(maxsize=None)
def dgrad_classes3(in_shape: tuple, k: int, stride: int) -> tuple:
    """The output-parity classes of the input gradient of a SAME 3-D conv:
    ((z0, y0, x0), (dq, hq, wq), taps), each tap (tap, oz, oy, ox) with
    tap = (kz * k + ky) * k + kx: class cell q reads dy at q + o through
    weight tap ``tap``. Stride 1: one class of every cell and all k^3
    taps; stride 2: the (z, y, x) parities, each with the taps of its
    parity only."""
    axes = [_axis_classes(s, k, stride, 1) for s in in_shape]
    out = []
    for z0, dq, tz in axes[0]:
        for y0, hq, ty in axes[1]:
            for x0, wq, tx in axes[2]:
                taps = tuple(((kz * k + ky) * k + kx, oz, oy, ox)
                             for kz, oz in tz for ky, oy in ty
                             for kx, ox in tx)
                out.append(((z0, y0, x0), (dq, hq, wq), taps))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def dgrad_table3(in_shape: tuple, k: int, stride: int):
    """``dgrad_classes3`` as ``fn_conv3d_dgrad`` reads it, a ctypes int
    array: the class count, each class's z0, y0, x0, dq, hq, wq and tap
    count, then every class's taps (tap, oz, oy, ox) in class order."""
    classes = dgrad_classes3(in_shape, k, stride)
    flat = [len(classes)]
    for start, size, taps in classes:
        flat += [*start, *size, len(taps)]
    for _, _, taps in classes:
        flat += [v for tap in taps for v in tap]
    return (ctypes.c_int * len(flat))(*flat)


def _dgrad_splits(n, in_shape, k, stride, ci, co):
    classes = dgrad_classes3(in_shape, k, stride)
    bm, bn = DGRAD_TILE
    tiles = sum(-(-n * dq * hq * wq // bm) for _, (dq, hq, wq), _ in classes)
    chunks = min(len(t) for _, _, t in classes) * (co // CHUNK)
    return grad_splits(tiles * -(-ci // bn), chunks)


def _wgrad_splits(cells, k, ci, co):
    bm, bn = WGRAD_TILE
    return grad_splits(k ** 3 * -(-ci // bm) * -(-co // bn),
                       -(-cells // CHUNK))


def _check_bf16(name, t, shape, dev):
    if t.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{name} is {t.dtype}: the 3-D conv gradients run in bfloat16 "
            "on the card (a float32 PUNet3 has no backward kernel there, "
            "ROADMAP A.5.5)")
    _build.check(t, name, torch.bfloat16, shape, dev)


def conv3d_dgrad(dy, w_dhwio, stride, in_shape):
    """Input gradient (n, di, hi, wi, ci) of a SAME conv of stride
    ``stride`` with the DHWIO weight ``w_dhwio`` (k, k, k, ci, co) from
    ``dy`` (n, do, ho, wo, co), the input map being ``in_shape`` (di, hi,
    wi): ``fn_conv3d_dgrad`` over dx's output-parity classes, its
    reduction split as ``grad_splits`` says. Bit-equal on a repeat."""
    in_shape = tuple(in_shape)
    if not _build.on_cuda(dy):
        return conv3d_dgrad_plain(dy, w_dhwio, stride, in_shape)
    n, do, ho, wo, co = dy.shape
    k, _, _, ci, _ = w_dhwio.shape
    dev = dy.device
    _check_bf16("dy", dy, (n, do, ho, wo, co), dev)
    _check_bf16("weight", w_dhwio, (k, k, k, ci, co), dev)
    if tuple(-(-s // stride) for s in in_shape) != (do, ho, wo):
        raise ValueError(f"dy {(do, ho, wo)} is not the output of a stride-"
                         f"{stride} SAME conv of {in_shape}")
    if co % CHUNK or ci % 8:
        raise ValueError(f"conv3d_dgrad needs co a multiple of {CHUNK} and "
                         f"ci of 8, got {co}, {ci}")
    s = _dgrad_splits(n, in_shape, k, stride, ci, co)
    wt = w_dhwio.transpose(3, 4).contiguous()
    dx = torch.empty((n, *in_shape, ci), dtype=torch.bfloat16, device=dev)
    ws = (torch.empty((s, dx.numel()), dtype=torch.float32, device=dev)
          if s > 1 else None)
    _build.call("fn_conv3d_dgrad", dy.data_ptr(), wt.data_ptr(),
                dx.data_ptr(), _build.ptr(ws),
                ctypes.addressof(dgrad_table3(in_shape, k, stride)), n,
                *in_shape, ci, do, ho, wo, co, k, stride, s, _build.stream())
    conv3d_dgrad.launches += 1
    return dx


conv3d_dgrad.launches = 0


def conv3d_wgrad(x, dy, k, stride):
    """(dW (k, k, k, ci, co) DHWIO bfloat16, db (co,) float32 of bfloat16
    values) of a SAME conv of NDHWC ``x`` (n, di, hi, wi, ci) from ``dy``
    (n, do, ho, wo, co): ``fn_conv3d_wgrad``, its reduction over the
    output cells split as ``grad_splits`` says. Bit-equal on a repeat."""
    if not _build.on_cuda(x):
        return conv3d_wgrad_plain(x, dy, k, stride)
    n, di, hi, wi, ci = x.shape
    _, do, ho, wo, co = dy.shape
    dev = x.device
    _check_bf16("x", x, (n, di, hi, wi, ci), dev)
    _check_bf16("dy", dy, (n, do, ho, wo, co), dev)
    if tuple(-(-s // stride) for s in (di, hi, wi)) != (do, ho, wo):
        raise ValueError(f"dy {(do, ho, wo)} is not the output of a stride-"
                         f"{stride} SAME conv of {(di, hi, wi)}")
    pads = _pads3((di, hi, wi), k, stride)
    if len({p[0] for p in pads}) != 1 or ci % 8 or co % 8:
        raise ValueError("conv3d_wgrad needs one low pad on every axis and "
                         f"channels multiples of 8, got {ci}, {co}")
    s = _wgrad_splits(n * do * ho * wo, k, ci, co)
    dw = torch.empty((k, k, k, ci, co), dtype=torch.bfloat16, device=dev)
    ws = (torch.empty((s, dw.numel()), dtype=torch.float32, device=dev)
          if s > 1 else None)
    _build.call("fn_conv3d_wgrad", x.data_ptr(), dy.data_ptr(),
                dw.data_ptr(), _build.ptr(ws), n, di, hi, wi, ci, do, ho, wo,
                co, k, stride, pads[0][0], s, _build.stream())
    conv3d_wgrad.launches += 1
    return dw, bias_grad(dy)


conv3d_wgrad.launches = 0
