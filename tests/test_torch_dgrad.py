"""The input gradient of kernel B's conv (``conv_grad.conv2d_dgrad``), on
the CPU: its plain version against JAX, and what the kernel's wrapper
hands the kernel.

* ``conv2d_dgrad`` (on a CPU tensor, the plain version) against
  ``jax.vjp`` of flax ``nn.Conv`` (SAME), the conv the JAX package's nets
  use, at stride 1 and 2, k 1, 3, 5, dilation 1, 2, the thin (16->16,
  16->8, 8->1) and wide (64->128) widths, each also in the packed layout
  that kernel B's thin-channel route stores (zero channels up to 32, or 4
  for an output layer) with the layer's real counts: the real channels
  equal, the padded ones exactly 0. Tolerance 1e-5 of the largest value:
  float32 sums in another order.
* The output-parity classes (``dgrad_classes``) the kernel runs over: every
  dx cell in one class, every tap in exactly one class, no tap of a class
  landing between dy's cells, 3x3 at stride 2 in classes of 4, 2, 2 and 1
  taps; a plain computation through the tables (each tap of each class a
  shifted 1x1 product of dy, scattered into dx) equal to the plain version
  within 1e-6 of its largest value.
* The wrapper's tf32 split of the weight against a numpy model of
  ``cvt.rna.tf32.f32``.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu_torch.ops.kernels import conv_grad

torch.set_num_threads(1)

# (k, stride, dil, ci, co, side)
CASES = [(3, 1, 1, 16, 16, 8), (1, 1, 1, 16, 16, 8), (1, 1, 1, 16, 8, 8),
         (1, 1, 1, 8, 1, 8), (5, 1, 1, 32, 8, 8), (3, 1, 2, 16, 16, 9),
         (3, 2, 1, 16, 32, 8), (3, 2, 1, 8, 16, 9), (5, 2, 1, 8, 16, 10),
         (3, 2, 2, 8, 8, 8), (3, 1, 1, 64, 128, 6), (3, 2, 1, 64, 128, 6)]


def _ids(c):
    return f"k{c[0]}-s{c[1]}-d{c[2]}-{c[3]}to{c[4]}-{c[5]}"


def _flax_dgrad(x, kernel, dy, stride, dil):
    """dL/dx of flax's SAME conv at x for the output gradient dy."""
    k, co = kernel.shape[0], kernel.shape[-1]
    conv = nn.Conv(co, (k, k), strides=(stride, stride), padding="SAME",
                   kernel_dilation=(dil, dil))
    params = {"params": {"kernel": kernel, "bias": np.zeros(co, np.float32)}}
    _, vjp = jax.vjp(lambda v: conv.apply(params, v), x)
    return np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("k,stride,dil,ci,co,side", CASES,
                         ids=[_ids(c) for c in CASES])
def test_dgrad_matches_flax_vjp(rng, k, stride, dil, ci, co, side):
    x = rng.standard_normal((2, side, side, ci)).astype(np.float32)
    kernel = rng.standard_normal((k, k, ci, co)).astype(np.float32)
    ho = -(-side // stride)
    dy = rng.standard_normal((2, ho, ho, co)).astype(np.float32)
    want = _flax_dgrad(x, kernel, dy, stride, dil)
    tol = 1e-5 * np.abs(want).max()
    got = conv_grad.conv2d_dgrad(torch.from_numpy(dy), torch.from_numpy(kernel),
                                 dil, stride, (side, side))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # The packed layout: zero input rows up to 32, zero output columns up
    # to 32 (4 for an output layer), dy stored as wide; the real counts.
    xs = -(-ci // 32) * 32
    ys = 4 if co == 1 else -(-co // 32) * 32
    w_p = np.zeros((k, k, xs, ys), np.float32)
    w_p[:, :, :ci, :co] = kernel
    dy_p = np.zeros((2, ho, ho, ys), np.float32)
    dy_p[..., :co] = dy
    got = conv_grad.conv2d_dgrad(torch.from_numpy(dy_p), torch.from_numpy(w_p),
                                 dil, stride, (side, side), ci, co).numpy()
    assert got.shape == (2, side, side, xs)
    np.testing.assert_allclose(got[..., :ci], want, rtol=0, atol=tol)
    assert not got[..., ci:].any()


def _through_classes(dy, w_hwio, k, stride, dil, hw):
    """dx from the class tables: for each class and each of its taps, dy
    at the class cells shifted by the tap's offset (zero outside dy) times
    the tap's weight, added into the class's cells of dx."""
    n, ho, wo, _ = dy.shape
    dx = torch.zeros((n, hw[0], hw[1], w_hwio.shape[2]), dtype=dy.dtype)
    for c in conv_grad.dgrad_classes(hw[0], hw[1], k, stride, dil):
        acc = torch.zeros((n, c.hq, c.wq, w_hwio.shape[2]), dtype=dy.dtype)
        for tap, oy, ox in c.taps:
            pad = torch.nn.functional.pad(
                dy, (0, 0, c.wq + abs(ox), c.wq + abs(ox), c.hq + abs(oy),
                     c.hq + abs(oy)))
            y0, x0 = c.hq + abs(oy) + oy, c.wq + abs(ox) + ox
            win = pad[:, y0:y0 + c.hq, x0:x0 + c.wq]
            acc += win @ w_hwio[tap // k, tap % k].T
        dx[:, c.y0::stride, c.x0::stride][:, :c.hq, :c.wq] = acc
    return dx


# (k, stride, dil, hi, wi)
GEOMS = [(1, 1, 1, 5, 7), (3, 1, 1, 6, 5), (5, 1, 1, 6, 6), (3, 1, 2, 7, 6),
         (3, 2, 1, 16, 16), (3, 2, 1, 9, 8), (5, 2, 1, 10, 11),
         (3, 2, 2, 8, 9), (1, 2, 1, 8, 7), (5, 2, 2, 12, 12)]


@pytest.mark.parametrize("k,stride,dil,hi,wi", GEOMS,
                         ids=[f"k{g[0]}-s{g[1]}-d{g[2]}-{g[3]}x{g[4]}"
                              for g in GEOMS])
def test_parity_classes(rng, k, stride, dil, hi, wi):
    classes = conv_grad.dgrad_classes(hi, wi, k, stride, dil)
    ho, wo = -(-hi // stride), -(-wi // stride)
    py = conv_grad.same_pads(hi, k, stride, dil)[0]
    px = conv_grad.same_pads(wi, k, stride, dil)[0]
    cover = np.zeros((hi, wi), int)
    seen = []
    for c in classes:
        ys = c.y0 + stride * np.arange(c.hq)
        xs = c.x0 + stride * np.arange(c.wq)
        assert ys[-1] < hi and xs[-1] < wi
        cover[np.ix_(ys, xs)] += 1
        for tap, oy, ox in c.taps:
            ky, kx = divmod(tap, k)
            seen.append(tap)
            # Every class cell's tap lands on a dy cell, at the table's
            # offset: no zero tap.
            assert ((ys + py - ky * dil) % stride == 0).all()
            assert ((xs + px - kx * dil) % stride == 0).all()
            np.testing.assert_array_equal(
                (ys + py - ky * dil) // stride, np.arange(c.hq) + oy)
            np.testing.assert_array_equal(
                (xs + px - kx * dil) // stride, np.arange(c.wq) + ox)
    assert (cover == 1).all()
    # Every tap in exactly one class: the class of its parity.
    assert len(classes) == stride * stride
    assert sorted(seen) == list(range(k * k))
    if (k, stride, dil) == (3, 2, 1):
        assert [len(c.taps) for c in classes] == [4, 2, 2, 1]
    dy = torch.from_numpy(rng.standard_normal((2, ho, wo, 6)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((k, k, 5, 6)).astype(
        np.float32))
    want = conv_grad.conv2d_dgrad_plain(dy, w, dil, stride, (hi, wi))
    got = _through_classes(dy, w, k, stride, dil, (hi, wi))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


def _rna_model(x):
    """cvt.rna.tf32.f32 in float64 arithmetic: 11 significant bits,
    rounded to nearest, ties away from zero."""
    m, e = np.frexp(x.astype(np.float64))
    r = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5)
    return np.ldexp(r / 2.0 ** 11, e).astype(np.float32)


def test_tf32_split(rng):
    # Normal numbers (the hardware rounds a subnormal's bits, not its
    # significant digits), and ties: bit 12 set, the 12 below it clear.
    ties = ((np.uint32(127) << 23) | (rng.integers(0, 1 << 10, 256).astype(
        np.uint32) << 13) | np.uint32(1 << 12))
    x = np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096),
        ties.view(np.float32), (ties | np.uint32(1 << 31)).view(np.float32),
        np.float32([0.0, -0.0, 1.0, -1.5])]).astype(np.float32)
    big, small = conv_grad.tf32_split(torch.from_numpy(x))
    big, small = big.numpy(), small.numpy()
    assert not (big.view(np.uint32) & 0x1fff).any()
    assert not (small.view(np.uint32) & 0x1fff).any()
    np.testing.assert_array_equal(big, _rna_model(x))
    rest = x - big  # exact in float32
    np.testing.assert_array_equal(small, _rna_model(rest))
    err = np.abs((big.astype(np.float64) + small) - x)
    assert (err <= 2.0 ** -22 * np.abs(x)).all()
