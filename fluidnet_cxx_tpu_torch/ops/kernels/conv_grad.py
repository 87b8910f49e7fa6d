"""The gradients of kernel B's convolution, both hand kernels: the weight
gradient ``fn_conv2d_wgrad`` (``csrc/conv2d_grad.cu``): dW (HWIO) and db of
a SAME conv of an NHWC input, any stride and dilation, from the gradient of
its output; and the input gradient ``fn_conv2d_dgrad``
(``csrc/conv2d_dgrad.cu``). They replace no TPU kernel (the JAX package
lets XLA differentiate flax ``nn.Conv``); the port needs them because every
conv on the card runs on kernel B. The autograd function of
``ops/kernels/punet.py`` calls both with the layer's real channel counts.

wgrad runs 3xTF32 ``mma.sync`` over chunks of 64 output pixels, each with
the halo'd x patch it needs staged by ``cp.async``; its planner,
``fn_conv2d_wgrad_plan`` in the same source (``plan_wgrad`` here), picks
the channel slices, warp tiles, chunk tile and splits of the pixels.

The input gradient runs over dx's output-parity classes (``dgrad_classes``:
at stride 2 each class correlates dy with the taps of its parity only, no
zero tap), on the layer's real channels, through one of three routes
(``ROUTES``) that its planner ``fn_conv2d_dgrad_plan`` (``plan_dgrad``
here) picks per layer: 3xTF32 ``mma.sync`` gathering each tap's rows of
dy, or over a halo'd patch of dy; on the wide layers ``wgmma`` over a
patch, with the weight's tf32 halves made here (``tf32_split``).

Plain versions: ``torch.nn.grad.conv2d_weight`` on the padded input and a
sum of dy, over the real channels; F.conv_transpose2d cut to the SAME
window. A CPU tensor runs them, a CUDA tensor the kernels.
"""
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build


def same_pads(size: int, k: int, stride: int, dil: int):
    """(lo, hi) padding of flax/XLA 'SAME' — on an even input a stride-2
    3x3 conv pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dil + 1 - size, 0)
    return total // 2, total - total // 2


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


# fn_conv2d_dgrad's routes: mma.sync gathering each tap's rows of dy;
# wgmma and mma.sync reading them from a halo'd patch of dy.
ROUTES = {1: "mma.sync", 2: "wgmma", 3: "mma.sync-patch"}


class DPlan(NamedTuple):
    """``fn_conv2d_dgrad``'s plan: the route (``ROUTES``), the K chunk
    ``kc`` (dy channels a tap a stage), the mma.sync warp tile's n8 tiles
    ``nt``, ``wm`` x ``wn`` warps (wgmma: ``wm`` m64 tiles a warpgroup),
    the block's columns ``bn``, the splits of K, log2 of the patch tile's
    columns ``tws``."""
    route: int
    kc: int
    nt: int
    wm: int
    wn: int
    bn: int
    splits: int
    tws: int


@functools.lru_cache(maxsize=None)
def plan_dgrad(n: int, hi: int, wi: int, ci: int, co: int, k: int,
               stride: int = 1, dil: int = 1, route: int = 0) -> DPlan:
    """The kernel's plan of the input gradient of a layer of real channels
    ``ci`` -> ``co`` whose input is ``n`` x ``hi`` x ``wi``, from
    ``fn_conv2d_dgrad_plan`` on the current card; a positive ``route``
    fixes the route."""
    plan = (ctypes.c_int * len(DPlan._fields))()
    plan[0] = route
    status = _build.query("fn_conv2d_dgrad_plan", n, hi, wi, ci, co, k,
                          stride, dil, ctypes.addressof(plan))
    if status:
        raise ValueError(f"fn_conv2d_dgrad_plan: no plan for {n}x{hi}x{wi}, "
                         f"{ci} -> {co}, k {k}, stride {stride}, dilation "
                         f"{dil}, route {route} (CUDA error {status})")
    return DPlan(*plan)


class DClass(NamedTuple):
    """One output-parity class of dx: its cells (y0 + s*qy, x0 + s*qx) for
    qy < hq, qx < wq, and its taps (tap = ky*k + kx, oy, ox): class cell
    (qy, qx) reads dy at (qy + oy, qx + ox) through weight tap ``tap``."""
    y0: int
    x0: int
    hq: int
    wq: int
    taps: tuple


def _axis_classes(size, k, stride, dil):
    """Per parity p of one axis with cells: (first cell, cells, [(kk,
    offset)]) -- the cells y with (y + pad) % s == p, and the taps kk with
    kk*d % s == p, at offset (p - kk*d) / s + q0 from the class's qy."""
    pad = same_pads(size, k, stride, dil)[0]
    out = []
    for p in range(stride):
        ys = [y for y in range(size) if (y + pad) % stride == p]
        if not ys:
            continue
        q0 = (ys[0] + pad - p) // stride
        taps = [(kk, q0 + (p - kk * dil) // stride) for kk in range(k)
                if (kk * dil - p) % stride == 0]
        out.append((ys[0], len(ys), taps))
    return out


@functools.lru_cache(maxsize=None)
def dgrad_classes(hi: int, wi: int, k: int, stride: int = 1,
                  dil: int = 1) -> tuple:
    """The output-parity classes of the input gradient of a SAME conv
    (stride 1: one class of all k*k taps at dy offsets pad - tap*d; stride
    2 and a 3x3 kernel at dilation 1: taps 2x2, 2x1, 1x2, 1x1). Every dx
    cell lies in one class; a tap lands on dy cell (y + pad - ky*d) / s,
    which divides exactly for each of its class's cells."""
    classes = []
    for y0, hq, ty in _axis_classes(hi, k, stride, dil):
        for x0, wq, tx in _axis_classes(wi, k, stride, dil):
            taps = tuple((ky * k + kx, oy, ox) for ky, oy in ty
                         for kx, ox in tx)
            classes.append(DClass(y0, x0, hq, wq, taps))
    return tuple(classes)


@functools.lru_cache(maxsize=None)
def class_table(hi: int, wi: int, k: int, stride: int = 1, dil: int = 1):
    """``dgrad_classes`` as the kernel reads them, a ctypes int array: the
    class count, then each class's y0, x0, hq, wq, tap count and its taps'
    (tap, oy, ox)."""
    classes = dgrad_classes(hi, wi, k, stride, dil)
    flat = [len(classes)]
    for c in classes:
        flat += [c.y0, c.x0, c.hq, c.wq, len(c.taps)]
        flat += [v for tap in c.taps for v in tap]
    return (ctypes.c_int * len(flat))(*flat)


def tf32_split(w):
    """(big, small) of float32 ``w``: big = tf32(w) rounded to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds (its 13 low bits
    0), and small = tf32(w - big) likewise (w - big is exact); big + small
    is w within 2^-22 of it. Integer ops on the bits."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000)
                & -0x2000).view(torch.float32)
    big = rna(w)
    return big, rna(w - big)


def conv2d_dgrad_plain(dy, w_hwio, dil=1, stride=1, in_hw=None, ci=None,
                       co=None):
    """Plain version of ``conv2d_dgrad``: F.conv_transpose2d of dy's ``co``
    real channels with the OIHW weight's real block, cut to the input's
    SAME-padded window, dx's channels past ``ci`` 0."""
    in_hw = tuple(dy.shape[1:3]) if in_hw is None else in_hw
    k, _, xs, ys = w_hwio.shape
    ci = xs if ci is None else ci
    co = ys if co is None else co
    lo = [same_pads(n, k, stride, dil)[0] for n in in_hw]
    g = F.conv_transpose2d(dy[..., :co].permute(0, 3, 1, 2),
                           w_hwio[:, :, :ci, :co].permute(3, 2, 0, 1),
                           stride=stride, dilation=dil)
    short = [max(0, lo[i] + in_hw[i] - g.shape[2 + i]) for i in (0, 1)]
    g = F.pad(g, (0, short[1], 0, short[0]))
    g = g[:, :, lo[0]:lo[0] + in_hw[0], lo[1]:lo[1] + in_hw[1]]
    return F.pad(g.permute(0, 2, 3, 1), (0, xs - ci)).contiguous()


def conv2d_dgrad(dy, w_hwio, dil=1, stride=1, in_hw=None, ci=None, co=None,
                 plan=None):
    """Input gradient (n, *in_hw, xs) of a SAME conv of stride ``stride``
    (1 or 2) with the HWIO weight ``w_hwio`` (k, k, xs, ys) from the
    gradient ``dy`` (n, ho, wo, ys) of its output (``in_hw`` defaults to
    dy's map, right at stride 1), over the layer's real channels ``ci`` <=
    xs and ``co`` <= ys (all by default; dx's channels past ci are 0):
    ``fn_conv2d_dgrad`` over the output-parity classes on the kernel's
    ``plan`` (``plan_dgrad``'s by default). Bit-equal on a repeat."""
    n, ho, wo, ys = dy.shape
    k, _, xs, cop = w_hwio.shape
    ci = xs if ci is None else ci
    co = ys if co is None else co
    if not _build.on_cuda(dy):
        return conv2d_dgrad_plain(dy, w_hwio, dil, stride, in_hw, ci, co)
    dev = dy.device
    _build.check(dy, "dy", torch.float32, (n, ho, wo, ys), dev)
    _build.check(w_hwio, "weight", torch.float32, (k, k, xs, cop), dev)
    if (xs % 4 or ys % 4 or cop % 4 or not 0 < ci <= xs
            or not 0 < co <= min(ys, cop)):
        raise ValueError(f"conv2d_dgrad needs stored channels a multiple of "
                         f"4 and 0 < real <= stored: dx {xs} ({ci} real), "
                         f"dy {ys} ({co} real), weight {xs}x{cop}")
    hi, wi = (ho, wo) if in_hw is None else in_hw
    if (-(-hi // stride), -(-wi // stride)) != (ho, wo):
        raise ValueError(f"dy {ho}x{wo} is not the output of a stride-"
                         f"{stride} SAME conv of {hi}x{wi}")
    p = plan or plan_dgrad(n, hi, wi, ci, co, k, stride, dil)
    wb = wsm = None
    if p.route == 2:
        wb, wsm = tf32_split(w_hwio)
    dx = torch.empty((n, hi, wi, xs), dtype=torch.float32, device=dev)
    ws = (torch.empty((p.splits, n * hi * wi, ci), dtype=torch.float32,
                      device=dev) if p.splits > 1 else None)
    _build.call("fn_conv2d_dgrad", dy.data_ptr(), w_hwio.data_ptr(),
                _build.ptr(wb), _build.ptr(wsm), dx.data_ptr(),
                _build.ptr(ws),
                ctypes.addressof(class_table(hi, wi, k, stride, dil)), n, hi,
                wi, xs, ci, ho, wo, ys, co, k, xs, cop, stride, p.route,
                p.kc, p.nt, p.wm, p.wn, p.bn, p.splits, p.tws,
                _build.stream())
    conv2d_dgrad.launches += 1
    return dx


conv2d_dgrad.launches = 0
