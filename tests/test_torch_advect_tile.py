"""The one-launch tiles of kernel E, held bit for bit to its plain
version on the CPU, and their tile planner.

``csrc/advect_all.cu::advect_tile`` gives each block a tw x th output
tile. It copies into shared memory orig over the tile's kInHalo
(cp.async) and a fluid byte a cell over kFwdHalo, their rows widened to
multiples of kAlign columns; it computes the forward field over kFwdHalo there and
runs the backward samples, correction and Selle clamp of its own cells
from shared memory alone. U's MAC vectors come from orig's copy, or from
global memory when orig is given. The kernel runs only on the card, so
here a plain-torch twin of that decomposition, with the halos and the
regions' origin read from the CUDA source by regex, is held with
``torch.equal`` to ``ops/advection.py::advect_velocity``. The twin reads
NaN for every cell of a region that the block does not hold (outside the
region, or off the grid, where the kernel loads zeros that no read may
use) and for every forward cell it does not compute (off the grid); a
flag it does not hold puts a NaN into the value that depends on it. A
NaN that reached an output fails the comparison. Cases: D = 1, 2, 4 and
the built limit; 37 x 21 and b = 2 19 x 45; random obstacles and the
cylinder's flag pattern; with and without orig; every tile of the
planner. One case holds the twin to the interpreted TPU kernel at D = 1
within 1e-5 of the largest output, as tests/test_torch_advect_split.py
holds the plain version.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.ops.pallas.advect_pallas import advect_velocity_pallas
from fluidnet_cxx_tpu_torch.celltype import FLUID, OBSTACLE
from fluidnet_cxx_tpu_torch.ops import advection
from fluidnet_cxx_tpu_torch.ops.common import F32, I32
from fluidnet_cxx_tpu_torch.ops.kernels import advect
from fluidnet_cxx_tpu_torch.ops.kernels.advect import plan_tile, tile_smem

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "fluidnet_cxx_tpu_torch" / "csrc"
NAN = float("nan")
DT, STRENGTH = 0.3, 0.6
HALF = STRENGTH * 0.5


def constants(src=None):
    """kInHalo, kFwdHalo (a, lo, hi), kAlign, kMaxD, kSmemMax and the
    shift (dx, dy) of region()'s origin from the tile - (left, before),
    of csrc/advect_all.cu."""
    src = src or (CSRC / "advect_all.cu").read_text()
    halo = {name: tuple(int(v) for v in re.search(
        rf"constexpr Halo {name}\{{(\d+), (\d+), (\d+)\}};", src).groups())
        for name in ("kInHalo", "kFwdHalo")}
    one = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
           for name in ("kAlign", "kMaxD", "kSmemMax")}
    m = re.search(r"return Region\{X0 - left([^,]*), Y0 - before([^,]*),",
                  src)
    shift = tuple(int(e.replace(" ", "") or 0) for e in m.groups())
    return dict(halo, **one, shift=shift)


class Tiles:
    """The blocks of a (b, h, w) grid's tw x th tiles as broadcastable
    index tensors (b, ny, nx, 1, 1), and their regions of shared memory."""

    def __init__(self, b, h, w, tile, D, c):
        self.b, self.h, self.w, self.D, self.c = b, h, w, D, c
        self.tw, self.th = tile
        ny, nx = -(-h // self.th), -(-w // self.tw)
        self.bi = torch.arange(b).view(-1, 1, 1, 1, 1)
        self.xi = torch.arange(nx).view(1, 1, -1, 1, 1)
        self.yi = torch.arange(ny).view(1, -1, 1, 1, 1)
        self.X0, self.Y0 = self.xi * self.tw, self.yi * self.th

    def span(self, halo, copied=False):
        """Origin (x0, y0) and size (rw, rh) of a halo's region: a copied
        one's rows start and end on multiples of kAlign columns."""
        a, lo, hi = halo
        before, after = a * self.D + lo, a * self.D + hi
        k = self.c["kAlign"] if copied else 1
        left, right = -(-before // k) * k, -(-after // k) * k
        dx, dy = self.c["shift"]
        return (self.X0 - left + dx, self.Y0 - before + dy,
                self.tw + left + right, self.th + before + after)

    def cells(self, halo, copied=False):
        """Absolute (X, Y) of every cell of the region (b, ny, nx, rh, rw)."""
        x0, y0, rw, rh = self.span(halo, copied)
        return (x0 + torch.arange(rw).view(1, 1, 1, 1, -1),
                y0 + torch.arange(rh).view(1, 1, 1, -1, 1))

    def region(self, field, halo):
        """A copy of ``field`` (b, h, w) over the region of every block, NaN
        off the grid; and the reader of it at absolute cells."""
        X, Y = self.cells(halo, True)
        on = (X >= 0) & (X < self.w) & (Y >= 0) & (Y < self.h)
        data = torch.where(on, field[self.bi, Y.clamp(0, self.h - 1),
                                     X.clamp(0, self.w - 1)], NAN)
        return self.reader(data, halo, True)

    def reader(self, data, halo, copied=False):
        """The reader of ``data`` (b, ny, nx, rh, rw), a region of every
        block, at absolute cells (X, Y) of each block's own (5-d tensors):
        NaN outside the region."""
        x0, y0, rw, rh = self.span(halo, copied)

        def read(X, Y):
            lx, ly = X - x0, Y - y0
            ok = (lx >= 0) & (lx < rw) & (ly >= 0) & (ly < rh)
            v = data[self.bi, self.yi, self.xi, ly.clamp(0, rh - 1),
                     lx.clamp(0, rw - 1)]
            return torch.where(ok, v, NAN)
        return read


def global_reader(field, t):
    """Reads of ``field`` (b, h, w) in global memory at cells of the
    grid."""
    def read(X, Y):
        return field[t.bi, Y.clamp(0, t.h - 1), X.clamp(0, t.w - 1)]
    return read


def fluid_reader(read):
    """The fluid test of a region of 1.0 (fluid) / 0.0 bytes and its
    poison: NaN where the block does not hold the byte, else 0."""
    def at(X, Y):
        v = read(X, Y)
        return v == 1.0, v * 0.0
    return at


def clamp_win(p, c, D):
    return torch.minimum(torch.maximum(p, c - D), c + D)


def corner(px, py, h, w):
    qx, qy = px - 0.5, py - 0.5
    ix, iy = torch.trunc(qx).to(I32), torch.trunc(qy).to(I32)
    s1 = torch.clamp(qx - ix.to(F32), 0.0, 1.0)
    t1 = torch.clamp(qy - iy.to(F32), 0.0, 1.0)
    return (ix.clamp(0, w - 2), iy.clamp(0, h - 2), 1.0 - s1, s1, 1.0 - t1,
            t1)


def bilinear(f, h, w, px, py):
    x0, y0, s0, s1, t0, t1 = corner(px, py, h, w)
    va, vb = f(x0, y0), f(x0, y0 + 1)
    vc, vd = f(x0 + 1, y0), f(x0 + 1, y0 + 1)
    return t0 * (s0 * va + s1 * vc) + t1 * (s0 * vb + s1 * vd)


def mac_vectors(u, v, x, y):
    """MAC-x (mxu, mxv) and MAC-y (myu, myv) at interior cells."""
    mxv = 0.25 * (((v(x, y) + v(x - 1, y)) + v(x, y + 1)) + v(x - 1, y + 1))
    myu = 0.25 * (((u(x, y) + u(x, y - 1)) + u(x + 1, y)) + u(x + 1, y - 1))
    return u(x, y), mxv, myu, v(x, y)


def vel_sl(f, fluid, x, y, vx, vy, sdt, h, w, D):
    cx, cy = x.to(F32) + 0.5, y.to(F32) + 0.5
    px, py = cx + (-sdt) * vx, cy + (-sdt) * vy
    s = bilinear(f, h, w, clamp_win(px, cx, D), clamp_win(py, cy, D))
    return torch.where(fluid, s, f(x, y))


def selle(dst, orig, x, y, vdx, vdy, h, w, D):
    vx, vy = torch.clamp(vdx, -D, D), torch.clamp(vdy, -D, D)
    mn = torch.full_like(dst, float("inf"))
    mx = torch.full_like(dst, float("-inf"))
    for sx, sy in ((-vx, -vy), (vx, vy)):
        i0 = (x.to(F32) + sx).to(I32).clamp(0, w - 2)
        j0 = (y.to(F32) + sy).to(I32).clamp(0, h - 2)
        for dj in (0, 1):
            for di in (0, 1):
                o = orig(i0 + di, j0 + dj)
                mn, mx = torch.minimum(mn, o), torch.maximum(mx, o)
    return torch.maximum(torch.minimum(dst, mx), mn)


def twin_tile(U, flags, D, orig=None, tile=None, c=None):
    """Plain-torch twin of advect_tile: returns U'."""
    c = c or constants()
    b, _, h, w = U.shape
    tile = tile or plan_tile(b, h, w, D)
    t = Tiles(b, h, w, tile, D, c)
    src = U if orig is None else orig
    k_in, k_fwd = c["kInHalo"], c["kFwdHalo"]
    Ou, Ov = t.region(src[:, 0], k_in), t.region(src[:, 1], k_in)
    Fl = fluid_reader(t.region((flags == FLUID).to(F32), k_fwd))

    def interior(x, y):
        return (x >= 1) & (x <= w - 2) & (y >= 1) & (y <= h - 2)

    Uu, Uv = ((Ou, Ov) if orig is None else
              (global_reader(U[:, 0], t), global_reader(U[:, 1], t)))

    # ---- forward over the tile's kFwdHalo, NaN where not computed ----
    x, y = t.cells(k_fwd)
    x, y = torch.broadcast_tensors(x, y, t.bi)[:2]
    on = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    fluid, fpoison = Fl(x, y)
    inn = interior(x, y)
    mxu, mxv, myu, myv = mac_vectors(Uu, Uv, x, y)
    fwd = [torch.where(on, torch.where(
        inn, vel_sl(O, fluid, x, y, vx, vy, DT, h, w, D) + fpoison, 0.0),
        NAN) for O, vx, vy in ((Ou, mxu, mxv), (Ov, myu, myv))]
    Fu, Fv = t.reader(fwd[0], k_fwd), t.reader(fwd[1], k_fwd)

    # ---- backward of the tile's own cells ----
    x = t.X0 + torch.arange(t.tw).view(1, 1, 1, 1, -1)
    y = t.Y0 + torch.arange(t.th).view(1, 1, 1, -1, 1)
    x, y = torch.broadcast_tensors(x, y, t.bi)[:2]
    own = (x < w) & (y < h)
    fluid, fpoison = Fl(x, y)
    inn = interior(x, y)
    mxu, mxv, myu, myv = mac_vectors(Uu, Uv, x, y)
    out = []
    for F, O, vx, vy, (fl_nb, p_nb) in (
            (Fu, Ou, mxu, mxv, Fl(x - 1, y)), (Fv, Ov, myu, myv,
                                                Fl(x, y - 1))):
        bwd = vel_sl(F, fluid, x, y, vx, vy, -DT, h, w, D)
        skip = ~fluid | ~fl_nb
        f0 = F(x, y)
        dst = torch.where(skip, f0, f0 + HALF * (O(x, y) - bwd)) + (
            fpoison + p_nb)
        out.append(torch.where(inn, selle(dst, O, x, y, vx * DT, vy * DT,
                                          h, w, D), 0.0))
    return _scatter(out, x, y, own, t, (b, 2, h, w))


def _scatter(planes, x, y, own, t, shape):
    out = torch.full(shape, NAN)
    bi = t.bi.expand_as(x)
    for k, p in enumerate(planes):
        out[bi[own], k, y[own], x[own]] = p[own]
    return out


def random_flags(rng, b, h, w, kind):
    """The border shell with 10% random obstacles, or with the cylinder's
    pattern (a disc at a quarter of the width, radius h/5)."""
    f = np.full((b, h, w), FLUID, np.int32)
    if kind == "random":
        f[rng.random((b, h, w)) < 0.1] = OBSTACLE
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        f[:, (xx - w / 4) ** 2 + (yy - h / 2) ** 2 < (h / 5) ** 2] = OBSTACLE
    f[:, 0, :] = f[:, -1, :] = OBSTACLE
    f[:, :, 0] = f[:, :, -1] = OBSTACLE
    return torch.from_numpy(f)


def inputs(seed, shape, D, kind):
    """Flags, U reaching 1.5 (D + 1) cells at DT (past the window clamp)
    and an orig far from U."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    flags = random_flags(rng, b, h, w, kind)
    U = (1.5 * (D + 1) / DT * rng.uniform(-1, 1, (b, 2, h, w))).astype(
        np.float32)
    orig = (U + 1.5 * (D + 1) / DT * rng.uniform(-1, 1, U.shape)).astype(
        np.float32)
    return flags, torch.from_numpy(U), torch.from_numpy(orig)


MAX_D = constants()["kMaxD"]


@pytest.mark.parametrize("kind", ["random", "cylinder"])
@pytest.mark.parametrize("shape", [(1, 21, 37), (2, 45, 19)])
@pytest.mark.parametrize("D", [1, 2, 4, MAX_D])
def test_twin_equals_plain(D, shape, kind):
    """E with and without orig equals its plain version."""
    flags, U, orig = inputs(D + sum(shape), shape, D, kind)
    for o in (None, orig):
        want = advection.advect_velocity(DT, U if o is None else o, U, flags,
                                         STRENGTH, max_disp=D)
        assert torch.equal(twin_tile(U, flags, D, orig=o), want)


@pytest.mark.parametrize("tile", list(advect.TILES))
def test_twin_every_tile(tile):
    """Each tile the planner may pick, on a grid that is not a multiple of
    any, with and without orig, at D = 2."""
    flags, U, orig = inputs(3, (1, 70, 150), 2, "random")
    for o in (None, orig):
        want = advection.advect_velocity(DT, U if o is None else o, U, flags,
                                         STRENGTH, max_disp=2)
        assert torch.equal(twin_tile(U, flags, 2, orig=o, tile=tile), want)


def test_twin_matches_jax():
    """The twin against the interpreted TPU kernel at D = 1 (block 16),
    from the same numpy inputs, within 1e-5 of the largest output."""
    flags, U, orig = inputs(11, (1, 32, 32), 1, "random")
    for o in (None, orig):
        want = np.asarray(advect_velocity_pallas(
            DT, jnp.asarray(U.numpy()), jnp.asarray(flags.numpy()), STRENGTH,
            max_disp=1, block=16, interpret=True,
            orig=None if o is None else jnp.asarray(o.numpy())))
        got = twin_tile(U, flags, 1, orig=o)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def test_planner_fills_the_card():
    """Every main path's shape of E gets at least one block an SM (132) at
    max_disp 4: the 512^2 plume and the 8000x800 cylinder (and the
    128x512 Rayleigh-Taylor box); the largest tile that does so."""
    for b, h, w in ((1, 512, 512), (1, 512, 128), (1, 800, 8000)):
        tw, th = plan_tile(b, h, w, 4)
        assert b * -(-h // th) * -(-w // tw) >= advect.SMS
        bigger = advect.TILES[:advect.TILES.index((tw, th))]
        assert all(b * -(-h // y) * -(-w // x) < advect.SMS
                   for x, y in bigger)


def test_capacity_gate_follows_the_source():
    """The wrapper's halos, alignment and shared-memory limit are the
    source's; its byte count is the source's layout(); every tile fits a
    block at every max_disp up to the built limit; tiles are multiples of
    the block."""
    c = constants()
    assert c["shift"] == (0, 0)
    assert (advect.IN_HALO, advect.FWD_HALO, advect.ALIGN) == (
        c["kInHalo"], c["kFwdHalo"], c["kAlign"])
    assert advect.SMEM_MAX == c["kSmemMax"] and MAX_D >= 8
    src = (CSRC / "advect_all.cu").read_text()
    for line in ("L.fwd = L.orig + 2 * in.w * in.h;",
                 "L.fluid = L.fwd + 2 * fw.w * fw.h;",
                 "L.bytes = 4 * L.fluid + fl.w * fl.h;",
                 "return D > kMaxD || tw < 32 || tw % 32 || th < 8 || "
                 "th % 8 || tw > 128 ||"):
        assert line in src
    for tw, th in advect.TILES:
        assert tw % 32 == 0 and th % 8 == 0 and tw <= 128 and th <= 64
        for D in range(1, MAX_D + 1):
            t = Tiles(1, 1, 1, (tw, th), D, c)
            n_in = math.prod(t.span(c["kInHalo"], True)[2:])
            n_f = math.prod(t.span(c["kFwdHalo"])[2:])
            n_fl = math.prod(t.span(c["kFwdHalo"], True)[2:])
            nbytes = 4 * 2 * (n_in + n_f) + n_fl
            assert tile_smem(tw, th, D) == nbytes <= c["kSmemMax"]
