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

Kernel B's bfloat16 route has its own pair (``csrc/conv2d_bf16_grad.cu``,
the 3-D pair's design in two dimensions with dilation): the input gradient
``fn_conv2d_bf16_dgrad`` (``conv2d_dgrad_bf16``, over the same parity
classes) and the weight gradient ``fn_conv2d_bf16_wgrad``
(``conv2d_wgrad_bf16``), bf16 ``mma.sync`` with float32 sums over the
stored channels (the padded ones carry exact zeros), and the bias gradient
``fn_bias_grad_bf16`` (``bias_grad``, which the 3-D wrapper shares).
Rounding points, flax ``nn.Conv(dtype="bfloat16")``'s gradients on JAX's
CPU: every product exact in float32, dx and dW summed in float32 and
rounded to bfloat16 once; db a reduction of the bfloat16 upstream gradient
that XLA accumulates in bfloat16, each add rounded, in the order of its
tree reduction (``bias_windows``). Their plain versions are the float32
ones on the bfloat16 values, then those roundings (``*_bf16_plain``,
``bias_grad_plain``).
"""
import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .conv_plan import CHUNK as _CHUNKS
from .conv_plan import MAX_SPLITS


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


# ---- kernel B's bfloat16 route ----

# The bf16 kernels' staged chunk (dgrad: of dy's channels; wgrad: of
# output cells), csrc/conv_mma.cuh::kChunk.
BF16_CHUNK = _CHUNKS["bf16"]
# Blocks the splits aim for: two waves of the H100's 132 SMs.
TARGET_BLOCKS = 264
# (dx cells, input channels) of a dgrad block; (input, output channels) of
# a wgrad block (csrc/conv2d_bf16_grad.cu, csrc/conv3d_grad.cu).
DGRAD_TILE, WGRAD_TILE = (64, 32), (64, 64)
# The window of XLA's tree reduction on the CPU (TreeReductionRewriter).
TREE_WINDOW = 32


def grad_splits(tiles: int, chunks: int) -> int:
    """Splits of a reduction of ``chunks`` chunks over ``tiles`` blocks:
    enough for TARGET_BLOCKS blocks, at least 2 chunks a split, at most
    MAX_SPLITS."""
    return max(1, min(-(-TARGET_BLOCKS // tiles), chunks // 2, MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def bias_windows(dims: tuple) -> tuple:
    """The order in which XLA on the CPU sums a bfloat16 reduction over the
    axes ``dims`` (the bias gradient's cells): ((window, low pad,
    windows), ...) per axis. While every axis is at most TREE_WINDOW long,
    one window of all the cells: a chain in row-major order. Otherwise
    (XLA's TreeReductionRewriter) windows of TREE_WINDOW along each longer
    axis, padded evenly on both sides to a multiple of it (an axis of at
    most TREE_WINDOW is one window): a chain over each window's cells in
    row-major order, then a chain over the windows' sums in row-major
    order. A grid of windows with an axis above TREE_WINDOW (which XLA
    would reduce as a tree again) raises ValueError."""
    if max(dims) <= TREE_WINDOW:
        return tuple((d, 0, 1) for d in dims)
    out = []
    for d in dims:
        if d <= TREE_WINDOW:
            out.append((d, 0, 1))
            continue
        g = -(-d // TREE_WINDOW)
        out.append((TREE_WINDOW, (g * TREE_WINDOW - d) // 2, g))
    if max(g for _, _, g in out) > TREE_WINDOW:
        raise ValueError(f"the bias gradient over {dims} cells has more "
                         f"than {TREE_WINDOW} windows on an axis")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def bias_table(dims: tuple):
    """``bias_windows(dims)`` as ``fn_bias_grad_bf16`` reads it, a ctypes
    int array over four axes (leading axes of 1): the lengths, the window
    sizes, the low pads and the window counts."""
    wins = ((1, 0, 1),) * (4 - len(dims)) + bias_windows(dims)
    dims = (1,) * (4 - len(dims)) + tuple(dims)
    flat = [*dims, *(w for w, _, _ in wins), *(lo for _, lo, _ in wins),
            *(g for _, _, g in wins)]
    return (ctypes.c_int * len(flat))(*flat)


def bias_grad_plain(dy):
    """The bias gradient (co,) float32 of channels-last ``dy``: in float32
    its sum over the cells; in bfloat16 XLA's sum on the CPU, accumulated
    in bfloat16 with each add rounded, in ``bias_windows``' order (a
    window's cells, then the windows)."""
    co = dy.shape[-1]
    if dy.dtype == torch.float32:
        return dy.reshape(-1, co).sum(dim=0)
    dims = tuple(dy.shape[:-1])
    wins = bias_windows(dims)
    z = dy.new_zeros(tuple(w * g for w, _, g in wins) + (co,))
    z[tuple(slice(lo, lo + d) for (_, lo, _), d in zip(wins, dims))] = dy
    r = len(dims)
    z = z.reshape(tuple(v for w, _, g in wins for v in (g, w)) + (co,))
    z = z.permute(*range(0, 2 * r, 2), *range(1, 2 * r, 2), 2 * r)
    z = z.reshape(-1, math.prod(w for w, _, _ in wins), co)
    acc = torch.zeros_like(z[:, 0])
    for i in range(z.shape[1]):
        acc = acc + z[:, i]
    s = torch.zeros_like(acc[0])
    for part in acc:
        s = s + part
    return s.float()


def bias_grad(dy):
    """The bias gradient (co,) float32 (bfloat16 values) of a bfloat16 conv
    from its channels-last output gradient ``dy``: ``fn_bias_grad_bf16``,
    a chain a window and column, then a chain over the windows
    (``bias_windows``). Bit-equal to ``bias_grad_plain``."""
    if not _build.on_cuda(dy):
        return bias_grad_plain(dy)
    dims, co = tuple(dy.shape[:-1]), dy.shape[-1]
    _build.check(dy, "dy", torch.bfloat16, dy.shape, dy.device)
    if co % 8 or len(dims) > 4:
        raise ValueError(f"bias_grad needs co a multiple of 8 and at most "
                         f"4 reduced axes, got {tuple(dy.shape)}")
    nwin = math.prod(g for _, _, g in bias_windows(dims))
    db = torch.empty((co,), dtype=torch.float32, device=dy.device)
    part = (torch.empty((nwin, co), dtype=torch.float32, device=dy.device)
            if nwin > 1 else None)
    _build.call("fn_bias_grad_bf16", dy.data_ptr(), db.data_ptr(),
                _build.ptr(part), ctypes.addressof(bias_table(dims)), co,
                _build.stream())
    bias_grad.launches += 1
    return db


bias_grad.launches = 0


def conv2d_dgrad_bf16_plain(dy, w_hwio, dil=1, stride=1, in_hw=None):
    """Plain version of ``conv2d_dgrad_bf16``: ``conv2d_dgrad_plain`` in
    float32 on the bfloat16 values (every product exact), rounded to
    bfloat16 once."""
    return conv2d_dgrad_plain(dy.float(), w_hwio.float(), dil, stride,
                              in_hw).to(torch.bfloat16)


def conv2d_wgrad_bf16_plain(x, dy, k, stride=1, dil=1, pads=(0, 0)):
    """Plain version of ``conv2d_wgrad_bf16``: (dW (k, k, xs, ys) bfloat16
    from a float32 sum rounded once, db (ys,) float32 from
    ``bias_grad_plain``)."""
    dw, _ = conv2d_wgrad_plain(x.float(), dy.float(), k, stride, dil, pads)
    return dw.to(torch.bfloat16), bias_grad_plain(dy)


def conv2d_dgrad_bf16(dy, w_hwio, dil=1, stride=1, in_hw=None):
    """Input gradient (n, *in_hw, xs) bfloat16 of a SAME conv on kernel B's
    bfloat16 route (stride 1 or 2, dilation 1 or 2, kernel 1, 3 or 5) with
    the bfloat16 HWIO weight ``w_hwio`` (k, k, xs, ys) from the bfloat16
    gradient ``dy`` (n, ho, wo, ys) of its output (``in_hw`` defaults to
    dy's map): ``fn_conv2d_bf16_dgrad`` over the output-parity classes
    (``class_table``), on all stored channels, its reduction split as
    ``grad_splits`` says. Bit-equal on a repeat."""
    n, ho, wo, ys = dy.shape
    k, _, xs, _ = w_hwio.shape
    if not _build.on_cuda(dy):
        return conv2d_dgrad_bf16_plain(dy, w_hwio, dil, stride, in_hw)
    dev = dy.device
    _build.check(dy, "dy", torch.bfloat16, (n, ho, wo, ys), dev)
    _build.check(w_hwio, "weight", torch.bfloat16, (k, k, xs, ys), dev)
    if xs % 8 or ys % 8:
        raise ValueError(f"conv2d_dgrad_bf16 needs channels multiples of 8, "
                         f"got {xs} -> {ys}")
    hi, wi = (ho, wo) if in_hw is None else in_hw
    if (-(-hi // stride), -(-wi // stride)) != (ho, wo):
        raise ValueError(f"dy {ho}x{wo} is not the output of a stride-"
                         f"{stride} SAME conv of {hi}x{wi}")
    cop = -(-ys // BF16_CHUNK) * BF16_CHUNK
    wt = F.pad(w_hwio.transpose(2, 3), (0, 0, 0, cop - ys)).reshape(
        k * k, cop, xs).contiguous()
    classes = dgrad_classes(hi, wi, k, stride, dil)
    bm, bn = DGRAD_TILE
    tiles = sum(-(-n * c.hq * c.wq // bm) for c in classes) * -(-xs // bn)
    s = grad_splits(tiles, min(len(c.taps) for c in classes)
                    * (cop // BF16_CHUNK))
    dx = torch.empty((n, hi, wi, xs), dtype=torch.bfloat16, device=dev)
    ws = (torch.empty((s, dx.numel()), dtype=torch.float32, device=dev)
          if s > 1 else None)
    _build.call("fn_conv2d_bf16_dgrad", dy.data_ptr(), wt.data_ptr(),
                dx.data_ptr(), _build.ptr(ws),
                ctypes.addressof(class_table(hi, wi, k, stride, dil)), n, hi,
                wi, xs, ho, wo, ys, cop, k, stride, s, _build.stream())
    conv2d_dgrad_bf16.launches += 1
    return dx


conv2d_dgrad_bf16.launches = 0


def conv2d_wgrad_bf16(x, dy, k, stride=1, dil=1, pads=(0, 0)):
    """(dW (k, k, xs, ys) HWIO bfloat16, db (ys,) float32 of bfloat16
    values) of a SAME conv on kernel B's bfloat16 route of NHWC ``x`` (n,
    hi, wi, xs) from the gradient ``dy`` (n, ho, wo, ys) of its output, on
    all stored channels; ``pads`` = (before, after) on both axes (the
    kernel reads the first): ``fn_conv2d_bf16_wgrad``, its reduction over
    the output cells split as ``grad_splits`` says, and ``bias_grad``.
    Bit-equal on a repeat."""
    if not _build.on_cuda(x):
        return conv2d_wgrad_bf16_plain(x, dy, k, stride, dil, pads)
    n, hi, wi, xs = x.shape
    _, ho, wo, ys = dy.shape
    dev = x.device
    _build.check(x, "x", torch.bfloat16, (n, hi, wi, xs), dev)
    _build.check(dy, "dy", torch.bfloat16, (n, ho, wo, ys), dev)
    if xs % 8 or ys % 8:
        raise ValueError(f"conv2d_wgrad_bf16 needs channels multiples of 8, "
                         f"got {xs} -> {ys}")
    if (-(-hi // stride), -(-wi // stride)) != (ho, wo):
        raise ValueError(f"dy {ho}x{wo} is not the output of a stride-"
                         f"{stride} SAME conv of {hi}x{wi}")
    bm, bn = WGRAD_TILE
    s = grad_splits(k * k * -(-xs // bm) * -(-ys // bn),
                    -(-(n * ho * wo) // BF16_CHUNK))
    dw = torch.empty((k, k, xs, ys), dtype=torch.bfloat16, device=dev)
    ws = (torch.empty((s, dw.numel()), dtype=torch.float32, device=dev)
          if s > 1 else None)
    _build.call("fn_conv2d_bf16_wgrad", x.data_ptr(), dy.data_ptr(),
                dw.data_ptr(), _build.ptr(ws), n, hi, wi, xs, ho, wo, ys, k,
                stride, dil, pads[0], s, _build.stream())
    conv2d_wgrad_bf16.launches += 1
    return dw, bias_grad(dy)


conv2d_wgrad_bf16.launches = 0
