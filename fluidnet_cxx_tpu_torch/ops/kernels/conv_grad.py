"""The weight gradient of kernel B's convolution (``csrc/conv2d_grad.cu``,
``fn_conv2d_wgrad``): dW (HWIO) and db of a SAME conv of an NHWC input,
any stride and dilation, from the gradient of its output. It replaces no
TPU kernel (the JAX package lets XLA differentiate flax ``nn.Conv``); the
port needs it because every conv on the card runs on kernel B. The
autograd function of ``ops/kernels/punet.py`` calls it with the layer's
real channel counts; ``fn_conv2d_dgrad``, kernel B's body with a
transposed gather, gives the input gradient there (``conv2d_dgrad``).

The kernel runs 3xTF32 ``mma.sync`` over chunks of 64 output pixels, each
with the halo'd x patch it needs staged by ``cp.async``; its planner,
``fn_conv2d_wgrad_plan`` in the same source (``plan_wgrad`` here), picks
the channel slices, warp tiles, chunk tile and splits of the pixels.

Plain version: ``torch.nn.grad.conv2d_weight`` on the padded input and a
sum of dy, over the real channels; a CPU tensor runs it, a CUDA tensor the
kernel.
"""
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build


class WPlan(NamedTuple):
    """``fn_conv2d_wgrad``'s plan: channels a slice (``cw``), floats a patch
    pixel (``cs``, the slot of ones at ``cw``), the warp tile ``wm`` x
    ``wn`` m16n8 tiles, ``nwr`` x ``nwc`` warps a block, the chunk tile
    width ``tw`` (its height ``64 // tw``), floats a dy tile pixel
    (``cy``), splits of the chunks."""
    cw: int
    cs: int
    wm: int
    wn: int
    nwr: int
    nwc: int
    tw: int
    cy: int
    splits: int


@functools.lru_cache(maxsize=None)
def plan_wgrad(n: int, ho: int, wo: int, ci: int, co: int, k: int,
               stride: int = 1, dil: int = 1, cw: int = 0, wm: int = 0,
               nwr: int = 0) -> WPlan:
    """The kernel's plan of a layer of real channels ``ci`` -> ``co`` on an
    output map ``n`` x ``ho`` x ``wo``, from ``fn_conv2d_wgrad_plan`` on the
    current card; a positive ``cw``, ``wm`` or ``nwr`` fixes that field."""
    plan = (ctypes.c_int * len(WPlan._fields))()
    plan[0], plan[2], plan[4] = cw, wm, nwr
    status = _build.query("fn_conv2d_wgrad_plan", n, ho, wo, ci, co, k,
                          stride, dil, ctypes.addressof(plan))
    if status:
        raise ValueError(f"fn_conv2d_wgrad_plan: no plan for {n}x{ho}x{wo}, "
                         f"{ci} -> {co}, k {k}, stride {stride}, dilation "
                         f"{dil}, fixed cw {cw} wm {wm} nwr {nwr} (CUDA "
                         f"error {status})")
    return WPlan(*plan)


def conv2d_wgrad_plain(x, dy, k: int, stride: int = 1, dil: int = 1,
                       pads=(0, 0), ci=None, co=None):
    """(dW (k, k, xs, ys), db (ys,)) of a conv of NHWC ``x`` (xs stored
    channels) padded by ``pads`` = (before, after) on both axes, from NHWC
    ``dy`` (ys stored channels), over the real channels ``ci`` and ``co``
    (all by default); the padded entries are 0."""
    xs, ys = x.shape[-1], dy.shape[-1]
    ci = xs if ci is None else ci
    co = ys if co is None else co
    lo, hi = pads
    xn = F.pad(x[..., :ci].permute(0, 3, 1, 2), (lo, hi, lo, hi))
    dw = torch.nn.grad.conv2d_weight(
        xn, (co, ci, k, k), dy[..., :co].permute(0, 3, 1, 2),
        stride=stride, dilation=dil)
    dw = F.pad(dw.permute(2, 3, 1, 0), (0, ys - co, 0, xs - ci))
    return dw.contiguous(), F.pad(dy[..., :co].sum(dim=(0, 1, 2)),
                                  (0, ys - co))


def conv2d_wgrad(x, dy, k: int, stride: int = 1, dil: int = 1, pads=(0, 0),
                 ci=None, co=None, plan=None):
    """(dW (k, k, xs, ys) HWIO, db (ys,)) of a SAME conv of NHWC ``x`` (n,
    hi, wi, xs) from the gradient ``dy`` (n, ho, wo, ys) of its output,
    over the layer's real channels ``ci`` <= xs and ``co`` <= ys (all by
    default; the padded entries are 0); ``pads`` = (before, after) on both
    axes (the kernel reads the first: taps past the input read 0); the
    kernel's ``plan`` (``plan_wgrad``'s by default). Bit-equal on a
    repeat."""
    n, hi, wi, xs = x.shape
    _, ho, wo, ys = dy.shape
    ci = xs if ci is None else ci
    co = ys if co is None else co
    if not _build.on_cuda(x):
        return conv2d_wgrad_plain(x, dy, k, stride, dil, pads, ci, co)
    dev = x.device
    _build.check(x, "x", torch.float32, (n, hi, wi, xs), dev)
    _build.check(dy, "dy", torch.float32, (n, ho, wo, ys), dev)
    if xs % 4 or ys % 4 or not 0 < ci <= xs or not 0 < co <= ys:
        raise ValueError(f"conv2d_wgrad needs stored channels a multiple of "
                         f"4 and 0 < real <= stored: x {xs} ({ci} real), dy "
                         f"{ys} ({co} real)")
    p = plan or plan_wgrad(n, ho, wo, ci, co, k, stride, dil)
    dw = torch.empty((k, k, xs, ys), dtype=torch.float32, device=dev)
    db = torch.empty((ys,), dtype=torch.float32, device=dev)
    ws = torch.empty((p.splits, k * k * ci + 1, co), dtype=torch.float32,
                     device=dev)
    _build.call("fn_conv2d_wgrad", x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                db.data_ptr(), ws.data_ptr(), n, hi, wi, xs, ci, ho, wo, ys,
                co, k, stride, dil, pads[0], p.cw, p.cs, p.wm, p.wn, p.nwr,
                p.nwc, p.tw, p.cy, p.splits, _build.stream())
    conv2d_wgrad.launches += 1
    return dw, db


conv2d_wgrad.launches = 0
