"""The weight-gradient kernel's order of work, as a plain-torch twin, on the
CPU.

``fn_conv2d_wgrad`` (``csrc/conv2d_grad.cu``) cannot run here; its twin
below follows it step by step under a given plan (``conv_grad.WPlan``;
on the card the kernel's own planner makes it): the input channels cut
into slices, the pixels into chunks of 64 (a TR x TW
tile of one image) and the chunks into contiguous splits; for each chunk
the halo'd x patch as the kernel stages it (channels 0..c4-1 copied, zero
outside the input, the slot of ones at ``cw``, NaN in every slot no copy
writes), each row of [dW; db] read through the kernel's patch offsets
(``roff``, ``po``), dy's tile zero past the map; 3xTF32 products (operands
split by ``cvt.rna`` rounding to TF32, as
``tests/test_torch_conv_plan.py::_tf32`` does for B) summed from zero
over each pair of k-steps (16 pixels) in the kernel's order (small*big,
big*small, big*big a k-step), the pairs added over a chunk, the chunks
Kahan-added over the split, the splits Kahan-added in the order
0..S-1, the padded entries 0.

Held to ``conv2d_wgrad_plain`` within 1e-5 of each gradient's largest
value at k 1, 3 and 5, dilation 1 and 2, stride 1 and 2, thin counts in
padded storage and a wide layer, under plans like those the main path's
layers get and plans with several slices, row blocks and splits; and on
one long reduction (M = 2^16) within twice plain float32's distance from
float64.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fluidnet_cxx_tpu_torch.ops.kernels.conv_grad import (WPlan,
                                                          conv2d_wgrad_plain)
from fluidnet_cxx_tpu_torch.ops.kernels.punet import same_pads

torch.set_num_threads(1)

PIX = 64  # output pixels a chunk (the kernel's kPix)


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _kahan(s, c, v):
    y = v - c
    t = s + y
    return t, (t - s) - y


def wgrad_twin(x, dy, k, stride, dil, pad, ci, co, plan):
    """(dW (k, k, xs, ys), db (ys,)) as ``fn_conv2d_wgrad`` computes them
    under ``plan``."""
    n, hi, wi, xs = x.shape
    _, ho, wo, ys = dy.shape
    pix = PIX
    tw = plan.tw
    tws = tw.bit_length() - 1
    tr = pix // tw
    ph = (tr - 1) * stride + (k - 1) * dil + 1
    pw = (tw - 1) * stride + (k - 1) * dil + 1
    cs, cw = plan.cs, plan.cw
    tiles_y, tiles_x = -(-ho // tr), -(-wo // tw)
    chunks = n * tiles_y * tiles_x
    c_ix = torch.arange(chunks)
    img = c_ix // (tiles_y * tiles_x)
    rem = c_ix % (tiles_y * tiles_x)
    yo0, xo0 = rem // tiles_x * tr, rem % tiles_x * tw
    p = torch.arange(pix)
    # dy's tile: (chunks, 64, co), zero past the map.
    yo = yo0[:, None] + (p >> tws)[None]
    xo = xo0[:, None] + (p & (tw - 1))[None]
    ok = (yo < ho) & (xo < wo)
    dyt = dy[img[:, None], yo.clamp(max=ho - 1), xo.clamp(max=wo - 1), :co]
    dyt = torch.where(ok[..., None], dyt, 0.0)
    # The patch's pixels: (chunks, ph * pw) input positions.
    py, px = torch.meshgrid(torch.arange(ph), torch.arange(pw), indexing="ij")
    iy = (yo0 * stride - pad)[:, None] + py.flatten()[None]
    ix = (xo0 * stride - pad)[:, None] + px.flatten()[None]
    inside = (iy >= 0) & (iy < hi) & (ix >= 0) & (ix < wi)
    po = ((p >> tws) * pw + (p & (tw - 1))) * stride * cs
    rows = k * k * ci + 1
    splits = plan.splits
    ws = torch.empty((splits, rows, co), dtype=torch.float32)
    bounds = [s * chunks // splits for s in range(splits + 1)]
    for sl in range(-(-ci // cw)):
        c_lo = sl * cw
        cws = min(cw, ci - c_lo)
        c4 = -(-cws // 4) * 4
        kc = k * k * cws
        srows = kc + (sl == 0)
        patch = torch.full((chunks, ph * pw, cs), float("nan"))
        vals = x[img[:, None], iy.clamp(0, hi - 1), ix.clamp(0, wi - 1),
                 c_lo:c_lo + c4]
        patch[..., :c4] = torch.where(inside[..., None], vals, 0.0)
        patch[..., cw] = 1.0
        r = torch.arange(srows)
        tap, ch = r // cws, r % cws
        roff = torch.where(r < kc, ((tap // k) * dil * pw + (tap % k) * dil)
                           * cs + ch, cw)
        a = patch.reshape(chunks, -1)[:, roff[:, None] + po[None]]
        assert not bool(a.isnan().any()), "a row read a slot no copy wrote"
        ab, bb = _tf32(a), _tf32(dyt)
        asm, bsm = _tf32(a - ab), _tf32(dyt - bb)
        part = torch.zeros((chunks, srows, co))
        for ks in range(pix // 8):
            q = slice(8 * ks, 8 * ks + 8)
            pair = (torch.bmm(asm[..., q], bb[:, q]) if ks % 2 == 0 else
                    pair + torch.bmm(asm[..., q], bb[:, q]))
            pair = pair + torch.bmm(ab[..., q], bsm[:, q])
            pair = pair + torch.bmm(ab[..., q], bb[:, q])
            if ks % 2:
                part = part + pair
        grow = torch.where(r < kc, tap * ci + c_lo + ch, k * k * ci)
        for s in range(splits):
            acc = torch.zeros((srows, co))
            comp = torch.zeros((srows, co))
            for c in range(bounds[s], bounds[s + 1]):
                acc, comp = _kahan(acc, comp, part[c])
            ws[s, grow] = acc - comp
    tot, comp = ws[0], torch.zeros((rows, co))
    for s in range(1, splits):
        tot, comp = _kahan(tot, comp, ws[s])
    tot = tot - comp
    dw = F.pad(tot[:-1].reshape(k, k, ci, co), (0, ys - co, 0, xs - ci))
    return dw, F.pad(tot[-1], (0, ys - co))


def _inputs(rng, n, h, w, xs, ci, ys, co, stride):
    """x with its padded channels 0 (as the activations carry them) and dy
    with arbitrary values in its padded ones (the kernel must not read
    them into a real entry)."""
    x = rng.standard_normal((n, h, w, xs)).astype(np.float32)
    x[..., ci:] = 0
    ho, wo = -(-h // stride), -(-w // stride)
    dy = rng.standard_normal((n, ho, wo, ys)).astype(np.float32)
    return torch.from_numpy(np.abs(x)), torch.from_numpy(dy)


def _check(x, dy, k, stride, dil, ci, co, plan):
    pads = same_pads(x.shape[1], k, stride, dil)
    got = wgrad_twin(x, dy, k, stride, dil, pads[0], ci, co, plan)
    want = conv2d_wgrad_plain(x, dy, k, stride, dil, pads, ci, co)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))
    dw, db = got
    assert not bool(dw[:, :, ci:].any()) and not bool(dw[..., co:].any())
    assert not bool(db[co:].any())


# (k, stride, dil, xs, ci, ys, co, h, w, plan). Plans of the main path's
# classes: the tower's conv1 (2 -> 16) and ScaleNet's 3x3 input layer
# (3 -> 32) in 32-channel storage, an output layer (8 -> 1 in 4), 5x5 input
# layers, 16 -> 16 bank convs, strides 2, a wide layer in two slices. Then
# plans the planner does not pick at these sizes: several slices (the last
# narrower), a narrow chunk tile over several map rows, several splits.
CASES = [
    (3, 1, 1, 32, 2, 32, 16, 16, 16, WPlan(4, 8, 1, 2, 2, 1, 16, 24, 2)),
    (3, 1, 1, 32, 3, 32, 32, 12, 20, WPlan(4, 8, 1, 4, 2, 1, 32, 40, 3)),
    (1, 1, 1, 32, 8, 4, 1, 16, 16, WPlan(8, 24, 1, 1, 1, 1, 16, 8, 2)),
    (5, 1, 1, 32, 4, 32, 32, 16, 12, WPlan(4, 8, 1, 4, 5, 1, 16, 40, 4)),
    (3, 1, 2, 32, 16, 32, 16, 16, 16, WPlan(16, 24, 2, 2, 5, 1, 16, 24, 2)),
    (5, 1, 2, 32, 32, 32, 8, 12, 12, WPlan(16, 24, 4, 1, 7, 1, 16, 8, 3)),
    (3, 2, 1, 32, 16, 32, 8, 16, 16, WPlan(16, 20, 4, 1, 3, 1, 8, 8, 2)),
    (1, 2, 1, 32, 16, 32, 16, 15, 17, WPlan(16, 20, 1, 2, 2, 1, 16, 24, 1)),
    (3, 1, 1, 64, 64, 128, 128, 8, 8, WPlan(32, 40, 2, 4, 2, 4, 8, 136, 2)),
    (3, 1, 1, 40, 40, 16, 16, 12, 12, WPlan(16, 24, 2, 2, 3, 1, 8, 24, 3)),
    (5, 1, 1, 12, 10, 8, 8, 20, 20, WPlan(4, 8, 1, 1, 2, 1, 16, 8, 4)),
    (3, 2, 1, 32, 20, 32, 32, 16, 16, WPlan(8, 12, 2, 4, 2, 2, 32, 72, 2)),
]
IDS = [f"k{c[0]}-s{c[1]}-d{c[2]}-{c[4]}of{c[3]}to{c[6]}of{c[5]}-cw{c[9].cw}"
       f"-tw{c[9].tw}-S{c[9].splits}" for c in CASES]


@pytest.mark.parametrize("k,stride,dil,xs,ci,ys,co,h,w,plan", CASES,
                         ids=IDS)
def test_twin_matches_plain(rng, k, stride, dil, xs, ci, ys, co, h, w, plan):
    x, dy = _inputs(rng, 2, h, w, xs, ci, ys, co, stride)
    _check(x, dy, k, stride, dil, ci, co, plan)


def test_long_reduction_within_twice_plain_float32(rng):
    """M = 4 x 128 x 128 = 2^16 pixels, a 16 -> 16 bank conv in 32-channel
    storage: the twin's distance from the float64 gradient is at most twice
    the plain float32 version's."""
    x, dy = _inputs(rng, 4, 128, 128, 32, 16, 32, 16, 1)
    pads = same_pads(128, 3, 1, 1)
    plan = WPlan(16, 24, 2, 2, 5, 1, 64, 24, 32)
    got = torch.cat([t.flatten() for t in
                     wgrad_twin(x, dy, 3, 1, 1, pads[0], 16, 16, plan)])
    plain = torch.cat([t.flatten() for t in conv2d_wgrad_plain(
        x, dy, 3, 1, 1, pads, 16, 16)])
    exact = torch.cat([t.flatten() for t in conv2d_wgrad_plain(
        x.double(), dy.double(), 3, 1, 1, pads, 16, 16)])
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert err <= 2 * plain_err, (err, plain_err)
