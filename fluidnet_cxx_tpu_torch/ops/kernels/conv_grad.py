"""The weight gradient of kernel B's convolution (``csrc/conv2d_grad.cu``,
``fn_conv2d_wgrad``): dW (HWIO) and db of a SAME conv of an NHWC input,
any stride and dilation, from the gradient of its output. It replaces no
TPU kernel (the JAX package lets XLA differentiate flax ``nn.Conv``); the
port needs it because every conv on the card runs on kernel B. The
autograd function of ``ops/kernels/punet.py`` calls it; kernel B itself
gives the input gradient there (``conv2d_dgrad``).

Plain version: ``torch.nn.grad.conv2d_weight`` on the padded input and a
sum of dy; a CPU tensor runs it, a CUDA tensor the kernel.
"""
import torch
import torch.nn.functional as F

from . import _build


def conv2d_wgrad_plain(x, dy, k: int, stride: int = 1, dil: int = 1,
                       pads=(0, 0)):
    """(dW (k, k, ci, co), db (co,)) of a conv of NHWC ``x`` padded by
    ``pads`` = (before, after) on both axes, from NHWC ``dy``."""
    lo, hi = pads
    xn = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    dw = torch.nn.grad.conv2d_weight(
        xn, (dy.shape[-1], x.shape[-1], k, k), dy.permute(0, 3, 1, 2),
        stride=stride, dilation=dil)
    return dw.permute(2, 3, 1, 0).contiguous(), dy.sum(dim=(0, 1, 2))


def conv2d_wgrad(x, dy, k: int, stride: int = 1, dil: int = 1, pads=(0, 0)):
    """(dW (k, k, ci, co) HWIO, db (co,)) of a SAME conv of NHWC ``x``
    (n, hi, wi, ci) from the gradient ``dy`` (n, ho, wo, co) of its output;
    ``pads`` = (before, after) on both axes (the kernel reads the first:
    taps past the input read 0). Bit-equal on a repeat."""
    if not _build.on_cuda(x):
        return conv2d_wgrad_plain(x, dy, k, stride, dil, pads)
    n, hi, wi, ci = x.shape
    _, ho, wo, co = dy.shape
    dev = x.device
    _build.check(x, "x", torch.float32, (n, hi, wi, ci), dev)
    _build.check(dy, "dy", torch.float32, (n, ho, wo, co), dev)
    kdim = k * k * ci
    splits = _build.query("fn_conv2d_wgrad_splits", n * ho * wo, kdim, co)
    dw = torch.empty((k, k, ci, co), dtype=torch.float32, device=dev)
    db = torch.empty((co,), dtype=torch.float32, device=dev)
    ws = torch.empty((splits, kdim + 1, co), dtype=torch.float32, device=dev)
    _build.call("fn_conv2d_wgrad", x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                db.data_ptr(), ws.data_ptr(), n, hi, wi, ci, ho, wo, co, k,
                stride, dil, pads[0], splits, _build.stream())
    conv2d_wgrad.launches += 1
    return dw, db


conv2d_wgrad.launches = 0
