"""The conv kernels' tile planner (ops/kernels/conv_plan.py) at the main
paths' layer shapes, and plain torch twins of the two exact splits the
kernels use: kernel N's bf16x3 split of a float32 operand and kernel B's
3xTF32 products. The kernels themselves run only on the card (chip_smoke);
here the planner's promises and the arithmetic of the splits are checked.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fluidnet_cxx_tpu_torch.models.punet import layer_table
from fluidnet_cxx_tpu_torch.models.punet3d import layer_table3
from fluidnet_cxx_tpu_torch.ops.kernels import conv_plan
from fluidnet_cxx_tpu_torch.ops.kernels.conv_plan import plan_conv
from fluidnet_cxx_tpu_torch.ops.kernels.punet import (conv2d_nhwc_plain,
                                                      same_pads)

torch.set_num_threads(1)

# (model, resolution, route): PUNet3p8_64 / PUNet3_32 (patch 8 / 4,
# widths 96/128) at 128^3 in bf16 and float32, PUNetD2_128 (patch 8,
# widths 96/128/128, dilated bottleneck) at 512^2 and 128^2.
CASES = {"p8 128^3 bf16": ("p8", 128, "bf16"),
         "p4 128^3 bf16": ("p4", 128, "bf16"),
         "p8 128^3 f32": ("p8", 128, "simt"),
         "p4 128^3 f32": ("p4", 128, "simt"),
         "D2 512^2": ("d2", 512, "tf32x3"),
         "D2 128^2": ("d2", 128, "tf32x3")}
# The main paths: every layer gets one wave of blocks.
MAIN = ("p8 128^3 bf16", "p4 128^3 bf16", "D2 512^2")


def _layers(model, res):
    """[(name, m, co, taps, c1, c2)] of one forward, batch 1; the
    decoder's first conv takes [up | skip] in equal halves."""
    if model == "d2":
        table = [(nm, ci, co, k, s) for nm, ci, co, k, s, _ in
                 layer_table(2, 8, (96, 128, 128), 1, 3, 2)]
        patch, dims = 8, 2
    else:
        patch = 8 if model == "p8" else 4
        table, dims = layer_table3(2, patch, (96, 128), 1, 2), 3
    out, side = [], res // patch
    for name, ci, co, k, stride in table:
        if stride == 2:
            side //= 2
        c1, c2 = (ci // 2, ci // 2) if name.startswith("dec") else (ci, 0)
        out.append((name, side ** dims, co, k ** dims, c1, c2))
        if name.startswith("up"):
            side *= 2
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plan_covers_k_once_in_whole_chunks(case):
    model, res, route = CASES[case]
    for name, m, co, taps, c1, c2 in _layers(model, res):
        plan = plan_conv(m, co, taps, c1, c2, route)
        cin, ktot = c1 + c2, taps * (c1 + c2)
        b = plan.bounds
        assert b[0] == 0 and b[-1] == ktot, name
        assert all(lo < hi for lo, hi in zip(b, b[1:])), name
        assert all(k % plan.chunk == 0 for k in b), name
        # Every chunk of every split lies inside one tap and one input.
        for k0 in range(0, ktot, plan.chunk):
            c = k0 % cin
            end = c1 if c < c1 else cin
            assert c + plan.chunk <= end, (name, k0)
        assert plan.splits <= conv_plan.MAX_SPLITS
        if route == "simt":
            assert (plan.bm, plan.bn, plan.warp_m) == (64, 64, 32)
        elif plan.warp_m == 64:   # four warps of 64 x bn/2
            assert route == "bf16" and plan.bm == 128
            assert plan.bn in conv_plan.WIDE_BNS
        else:
            assert plan.warp_m == 32 and plan.bm in conv_plan.BMS
            assert plan.bn % 32 == 0
            assert plan.bm * plan.bn <= conv_plan.MAX_TILE
        if route != "simt":
            assert plan.bn >= min(co, 128)


@pytest.mark.parametrize("case", list(CASES))
def test_plan_reaches_the_blocks_it_promises(case):
    model, res, route = CASES[case]
    for name, m, co, taps, c1, c2 in _layers(model, res):
        plan = plan_conv(m, co, taps, c1, c2, route)
        grid = -(-m // plan.bm) * -(-co // plan.bn) * plan.splits
        assert grid == plan.blocks, name
        n_chunks = taps * (c1 + c2) // plan.chunk
        cap = min(n_chunks, conv_plan.MAX_SPLITS)
        # Four blocks an SM, or as many splits of MIN_CHUNKS chunks as the
        # K range has; one wave, or a split for every chunk.
        fill = conv_plan.FILL_BLOCKS[route]
        if plan.warp_m == 64:   # wide tiles: two waves without a split
            assert plan.blocks >= conv_plan.WIDE_MIN_TILES, name
        elif plan.blocks < fill:
            assert plan.splits >= min(n_chunks // conv_plan.MIN_CHUNKS,
                                      cap), name
        if plan.blocks < conv_plan.WAVE:
            assert plan.splits == cap, name
        if plan.splits > 1:   # no split beyond what fills the card
            assert plan.warp_m == 32
            assert plan.tiles * (plan.splits - 1) < fill
        if case in MAIN:
            assert plan.blocks >= conv_plan.WAVE, name


def test_plan_c_bounds_and_refusals():
    plan = plan_conv(512, 128, 27, 128, 0, "bf16")
    assert list(plan.c_bounds) == list(plan.bounds)
    with pytest.raises(ValueError):
        plan_conv(512, 128, 27, 48, 0, "bf16")        # 48 % 32
    with pytest.raises(ValueError):
        plan_conv(512, 128, 27, 128, 16, "tf32x3")    # 16 % 32
    assert plan_conv(512, 128, 27, 128, 16, "simt").chunk == 16


def _bf16x3(x):
    """Twin of csrc/conv_mma.cuh::split_bf16x3: round-to-nearest steps."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _f32_ulp(v):
    a = v.abs().double()
    return torch.exp2(torch.floor(torch.log2(a)) - 23)


def test_bf16x3_split_is_exact():
    rng = np.random.default_rng(9)
    n = 20000
    mag = np.exp2(rng.uniform(-100, 100, n))
    x = (mag * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    x[:16] = 0.0
    x[16:32] = -x[16:32]
    xt = torch.from_numpy(x)
    hi, mid, lo = _bf16x3(xt)
    # The last step rounds nothing: lo is x - hi - mid exactly.
    assert torch.equal(lo.float(), xt - hi.float() - mid.float())
    total = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(total.view(torch.int32), xt.view(torch.int32))
    # Each piece times a bf16 weight is exact in float32, and the three
    # exact products sum to the float32 product within one float32 ulp.
    w = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        torch.bfloat16)
    for piece in (hi, mid, lo):
        assert torch.equal((piece.float() * w.float()).double(),
                           piece.double() * w.double())
    exact = hi.double() * w.double() + mid.double() * w.double() \
        + lo.double() * w.double()
    prod = xt * w.float()
    nz = prod != 0
    err = (exact - prod.double()).abs()
    assert bool((err[nz] <= _f32_ulp(prod[nz])).all())
    assert bool((exact[~nz] == 0).all())
    f32_sum = (hi.float() * w.float() + mid.float() * w.float()) \
        + lo.float() * w.float()
    assert bool(((f32_sum - prod).abs()[nz].double()
                 <= _f32_ulp(prod[nz])).all())


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _conv2d_3xtf32(x, w_oihw, bias, stride, dil, relu, terms=3):
    """Plain torch emulation of kernel B's products: im2col, each operand
    split big = tf32(v), small = tf32(v - big), and small*big + big*small
    + big*big summed in float32 (``terms`` 1: plain TF32)."""
    k = w_oihw.shape[-1]
    ph = same_pads(x.shape[1], k, stride, dil)
    pw = same_pads(x.shape[2], k, stride, dil)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    cols = F.unfold(xn, k, dilation=dil, stride=stride)   # (1, c k k, L)
    a = cols[0].T.contiguous()                           # (L, c k k)
    b = w_oihw.reshape(w_oihw.shape[0], -1).T.contiguous()
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    y = a_big @ b_big
    if terms == 3:
        y = (a_small @ b_big + a_big @ b_small) + y
    y = y + bias
    if relu:
        y = torch.relu(y)
    ho, wo = -(-x.shape[1] // stride), -(-x.shape[2] // stride)
    return y.reshape(1, ho, wo, -1)


@pytest.mark.parametrize("stride, dil", [(1, 1), (2, 1), (1, 2)])
def test_3xtf32_emulation_meets_kernel_b_tolerance(stride, dil):
    """Within 1e-5 of the layer's largest output, the tolerance of B's
    per-layer check on the card; plain TF32 misses it."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 96))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 96, 3, 3)) / 29.0)
                         .astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    want = conv2d_nhwc_plain(x, w, bias, stride, dil, relu=True)
    tol = 1e-5 * float(want.abs().max())
    got = _conv2d_3xtf32(x, w, bias, stride, dil, relu=True)
    assert float((got - want).abs().max()) <= tol
    tf32 = _conv2d_3xtf32(x, w, bias, stride, dil, relu=True, terms=1)
    assert float((tf32 - want).abs().max()) > tol
