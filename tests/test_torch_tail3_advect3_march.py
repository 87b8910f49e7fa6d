"""The z-marches of kernels J and M, held bit for bit to their plain
versions on the CPU.

Kernel J (``csrc/jacobi3.cu::fn_tail3``) runs a prologue launch (the
divergence RHS, the mask byte, the warm start zeroed on obstacles), its
damped sweeps in kernel I's z-marches of up to kMaxSweeps3 sweeps a launch,
and an epilogue launch (velocity update, free-slip walls). Kernel M
(``csrc/advect3.cu::vel3_march``) runs two z-marches over kVTX x kVTY
column tiles: the forward one keeps a ring of U's planes in shared memory,
the backward one a ring of U's and one of the forward field's, each plane
the tile plus D cells before and D + 1 after it in x and y, the ring
holding planes z-D .. z+D+1 around output plane z and kVAhead more in
flight (plane Z in slot Z % depth). The kernels run only on the card, so
here plain-torch twins of both schedules, with their constants read from
the CUDA sources, are held with ``torch.equal`` to
``ops/kernels/proj_tail3.py::project_tail3_plain`` and
``ops/ops3d.py::advect_velocity3``. A twin reads NaN wherever the kernel
reads memory that holds no exact value: a ring cell off the grid, a slot
whose plane lies off the grid or past the segment's loads, a cell outside
a ring plane, a plane whose copy the last cp.async wait did not cover; a
NaN that reached a written cell would fail the comparison, and a read of
the wrong plane gives a wrong value. Cases: b = 1
and 2, shapes that are not multiples of the tiles, several z segments;
J cold and warm, damping 2/3, 16, 8, 3, 2 and 1 sweeps; M at D = 1, 2 and
4 on random obstacles and on the scene's flags (the border shell alone),
with displacements past the window clamp; M with a viscous ``orig`` (a
third ring, orig's, in both launches, the rings' depth set for three) at
D = 1, 2 and 3. One case each holds a twin to the JAX package: J to the
interpreted TPU kernel at 1e-6 of max|p|, M to the XLA window path at
1e-5.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.ops import ops3d as j_ops3d
from fluidnet_cxx_tpu.ops.pallas.proj_tail3_pallas import \
    project_tail3_pallas
from fluidnet_cxx_tpu_torch.celltype import EMPTY, FLUID, OBSTACLE
from fluidnet_cxx_tpu_torch.ops.kernels.proj_tail3 import \
    project_tail3_plain
from fluidnet_cxx_tpu_torch.ops.ops3d import (add_viscosity3,
                                              advect_velocity3,
                                              empty_domain3)
from test_torch_jacobi_blocking import i_constants, twin_i
from test_torch_ops3d import random_flags3

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "fluidnet_cxx_tpu_torch" / "csrc"
NAN = float("nan")
DT, STRENGTH = 0.8, 0.6


def _constant(text, pattern):
    return int(re.search(pattern, text).group(1))


def m_constants():
    """kVTX, kVTY, kVSegZ, kVAhead and kVMaxD of csrc/advect3.cu."""
    src = (CSRC / "advect3.cu").read_text()
    return tuple(_constant(src, rf"constexpr int {name} = (\d+);")
                 for name in ("kVTX", "kVTY", "kVSegZ", "kVAhead", "kVMaxD"))


def max_d_orig():
    """kVMaxDOrig of csrc/advect3.cu: the largest D M takes with orig."""
    return _constant((CSRC / "advect3.cu").read_text(),
                     r"constexpr int kVMaxDOrig = (\d+);")


SMEM_MAX = 232448   # bytes of shared memory a block may have


def ring_shape(D, rings=2):
    """The ring's plane width and height and its depth in planes at
    max_disp D (Ring<kD, kRings> in csrc/advect3.cu): at least 2D + 2 +
    kVAhead planes, a power of two where the backward block's ``rings``
    rings fit (2 without orig, 3 with it)."""
    tx, ty, _, ahead, _ = m_constants()
    kw, kh, least = tx + 2 * D + 1, ty + 2 * D + 1, 2 * D + 2 + ahead
    pow2 = 1 << (least - 1).bit_length()
    fits = rings * pow2 * 3 * kw * kh * 4 <= SMEM_MAX
    return kw, kh, pow2 if fits else least


# ---- J ----

def twin_j(flags, U, p0, iters, damping):
    """Plain-torch twin of fn_tail3: the prologue, kernel I's marches (the
    twin of tests/test_torch_jacobi_blocking.py) and the epilogue."""
    b, d, h, w = flags.shape
    ob = flags == OBSTACLE
    inner = torch.zeros_like(ob)
    inner[:, 1:-1, 1:-1, 1:-1] = True
    u, v, wz = U[:, 0], U[:, 1], U[:, 2]
    # Prologue: ((u - u[x+1]) + (v - v[y+1])) + (w - w[z+1]) on interior
    # non-obstacle cells, the warm start zeroed on obstacles.
    r = ((u - torch.roll(u, -1, 3)) + (v - torch.roll(v, -1, 2))) + (
        wz - torch.roll(wz, -1, 1))
    rhs = torch.where(inner & ~ob, r, torch.zeros(()))
    p_init = torch.where(ob, torch.zeros(()), p0)
    p = twin_i(flags, rhs, iters, p0=p_init, damping=damping) if iters \
        else p_init
    # Epilogue: the update from the lower neighbour along each axis
    # (border faces keep U), then the walls.
    fl, em = flags == FLUID, flags == EMPTY
    out = []
    for c, dim in enumerate((3, 2, 1)):
        fm = torch.roll(flags, 1, dim)
        pm = torch.roll(p, 1, dim)
        vel = U[:, c]
        val = torch.where(
            fl & (fm == FLUID), vel - (p - pm),
            torch.where(fl & (fm == EMPTY), vel - p,
                        torch.where(em & (fm == FLUID), vel + pm,
                                    torch.zeros(()))))
        val = torch.where(inner, val, vel)
        idx = torch.arange(flags.shape[dim]).view(
            [-1 if k == dim else 1 for k in range(4)])
        fb = torch.where(idx > 0, fm, flags)
        kill = (fl | ob) & ((fb == OBSTACLE) | (ob & (fb == FLUID)))
        out.append(torch.where(kill, torch.zeros(()), val))
    return p, torch.stack(out, dim=1)


def tail_inputs(seed, shape):
    """Flags with 10% obstacles and 5% empty cells inside the border shell,
    U and a warm start, from a numpy seed."""
    rng = np.random.default_rng(seed)
    flags = random_flags3(rng, shape, p_obstacle=0.10, p_empty=0.05)
    b = shape[0]
    U = np.clip(rng.standard_normal((b, 3) + shape[1:]), -2, 2).astype(
        np.float32)
    p0 = rng.standard_normal(shape).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (flags, U, p0))


K_I = i_constants()[2]


@pytest.mark.parametrize("iters", [16, 8, K_I, 2, 1])
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("shape", [(1, 21, 27, 37), (2, 35, 12, 19)])
def test_j_twin_equals_plain(shape, start, iters):
    flags, U, p0 = tail_inputs(sum(shape), shape)
    if start == "cold":
        p0 = torch.zeros_like(p0)
    got = twin_j(flags, U, p0, iters, 2.0 / 3.0)
    want = project_tail3_plain(flags, U, p0, iters, 2.0 / 3.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_j_twin_matches_jax():
    """Against the interpreted TPU kernel, 16 warm sweeps damped 2/3."""
    flags, U, p0 = tail_inputs(3, (2, 8, 16, 12))
    got = twin_j(flags, U, p0, 16, 2.0 / 3.0)
    want = project_tail3_pallas(flags.numpy(), U.numpy(), p0.numpy(), 16,
                                damping=2.0 / 3.0, interpret=True)
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g.numpy(), w_, rtol=0,
                                   atol=1e-6 * np.abs(w_).max())


# ---- M ----

class Tiles:
    """The cells of every column tile of a (b, d, h, w) grid as (b, ny, nx,
    TY, TX) index arrays, and reads from rings of planes over those
    tiles."""

    def __init__(self, shape, D, seg_z=None, rings=2):
        tx, ty, seg, _, _ = m_constants()
        self.b, self.d, self.h, self.w = shape
        self.D, self.seg = D, seg_z or seg
        self.kw, self.kh, self.depth = ring_shape(D, rings)
        ny, nx = -(-self.h // ty), -(-self.w // tx)
        self.bi = torch.arange(self.b).view(-1, 1, 1, 1, 1)
        self.yi = torch.arange(ny).view(1, -1, 1, 1, 1)
        self.xi = torch.arange(nx).view(1, 1, -1, 1, 1)
        # The ring's first row and column of each tile.
        self.y0 = self.yi * ty - D
        self.x0 = self.xi * tx - D
        self.Y = self.y0 + D + torch.arange(ty).view(1, 1, 1, -1, 1)
        self.X = self.x0 + D + torch.arange(tx).view(1, 1, 1, 1, -1)
        self.owns = (self.X < self.w) & (self.Y < self.h)

    def empty_ring(self, fields):
        """A ring of ``fields`` x 3 component planes, NaN (garbage), the
        plane each slot holds (-1: none) and the commit group that loaded
        it; no group issued or waited for yet."""
        shape = (self.depth, self.b, self.yi.shape[1], self.xi.shape[2],
                 fields * 3, self.kh, self.kw)
        self.groups = self.ready = 0
        return (torch.full(shape, NAN), torch.full((self.depth,), -1),
                torch.zeros(self.depth, dtype=torch.long))

    def wait(self, pending):
        """cp.async.wait_group(pending): every group but the last
        ``pending`` issued has landed."""
        self.ready = self.groups - pending

    def load(self, ring, Z, z1, sources):
        """Plane Z of each (b, 3, d, h, w) source into slot Z % depth: the
        ring's cells on the grid, NaN off it; nothing for a plane off the
        grid or past the segment's last read (the kernel loads nothing
        there). One commit group either way."""
        data, held, group = ring
        self.groups += 1
        if not (0 <= Z < self.d and Z <= z1 + self.D):
            return
        slot = Z % self.depth
        group[slot] = self.groups - 1
        ly = torch.arange(self.kh).view(1, 1, 1, -1, 1)
        lx = torch.arange(self.kw).view(1, 1, 1, 1, -1)
        Y, X = self.y0 + ly, self.x0 + lx
        on = (Y >= 0) & (Y < self.h) & (X >= 0) & (X < self.w)
        planes = torch.cat(sources, dim=1)[:, :, Z]   # (b, 3 f, h, w)
        vals = planes[self.bi.view(-1, 1, 1, 1, 1, 1),
                      torch.arange(planes.shape[1]).view(1, 1, 1, -1, 1, 1),
                      Y.clamp(0, self.h - 1).unsqueeze(3),
                      X.clamp(0, self.w - 1).unsqueeze(3)]
        data[slot] = torch.where(on.unsqueeze(3), vals, NAN)
        held[slot] = Z

    def read(self, ring, k, X, Y, Z):
        """Component plane k of the ring at absolute (X, Y, Z) for every
        tile cell; NaN outside a ring plane, where the slot holds another
        plane, and for a plane whose copy may still be in flight (its group
        not covered by the last wait)."""
        data, held, group = ring
        ly, lx = Y - self.y0, X - self.x0
        slot = Z.clamp(min=0) % self.depth
        ok = ((ly >= 0) & (ly < self.kh) & (lx >= 0) & (lx < self.kw)
              & (held[slot] == Z) & (group[slot] < self.ready))
        v = data[slot, self.bi, self.yi, self.xi, k,
                 ly.clamp(0, self.kh - 1), lx.clamp(0, self.kw - 1)]
        return torch.where(ok, v, NAN)

    def at_cells(self, a, z, dx=0, dy=0, dz=0):
        """a[b, z + dz, Y + dy, X + dx] of a (b, d, h, w) grid at the tile
        cells (clamped to the grid: only cells whose neighbour lies on it
        use the value)."""
        return a[self.bi, (z + dz) % self.d,
                 (self.Y + dy).clamp(0, self.h - 1),
                 (self.X + dx).clamp(0, self.w - 1)]


def _mac(at, c):
    """csrc/advect3.cu::mac_vector on an interior cell."""
    def avg4(a, b, c_, d):
        return 0.25 * (((a + b) + c_) + d)
    if c == 0:
        return [at(0, 0, 0, 0),
                avg4(at(1, 0, 0, 0), at(1, -1, 0, 0), at(1, 0, 1, 0),
                     at(1, -1, 1, 0)),
                avg4(at(2, 0, 0, 0), at(2, -1, 0, 0), at(2, 0, 0, 1),
                     at(2, -1, 0, 1))]
    if c == 1:
        return [avg4(at(0, 0, 0, 0), at(0, 0, -1, 0), at(0, 1, 0, 0),
                     at(0, 1, -1, 0)),
                at(1, 0, 0, 0),
                avg4(at(2, 0, 0, 0), at(2, 0, -1, 0), at(2, 0, 0, 1),
                     at(2, 0, -1, 1))]
    return [avg4(at(0, 0, 0, 0), at(0, 0, 0, -1), at(0, 1, 0, 0),
                 at(0, 1, 0, -1)),
            avg4(at(1, 0, 0, 0), at(1, 0, 0, -1), at(1, 0, 1, 0),
                 at(1, 0, 1, -1)),
            at(2, 0, 0, 0)]


def _trilinear(f, dims, D, c, pos):
    """csrc/advect3.cu::trilinear: f(X, Y, Z) reads the field."""
    lo, a0, a1 = [], [], []
    for a in range(3):
        q = torch.minimum(torch.maximum(pos[a], c[a] - D), c[a] + D) - 0.5
        iq = torch.trunc(q).to(torch.int32)
        w1 = torch.clamp(q - iq.to(torch.float32), 0.0, 1.0)
        a1.append(w1)
        a0.append(1.0 - w1)
        lo.append(iq.clamp(0, dims[a] - 2).long())
    pl = []
    for k in range(2):
        Z = lo[2] + k
        v0 = a0[0] * f(lo[0], lo[1], Z) + a1[0] * f(lo[0] + 1, lo[1], Z)
        v1 = (a0[0] * f(lo[0], lo[1] + 1, Z)
              + a1[0] * f(lo[0] + 1, lo[1] + 1, Z))
        pl.append(a0[1] * v0 + a1[1] * v1)
    return a0[2] * pl[0] + a1[2] * pl[1]


def twin_m(U, flags, D, seg_z=None, orig=None):
    """Plain-torch twin of M's two marches (fn_advect3_forward and
    fn_advect3_backward with parts 2): the forward field, then U' (with
    ``orig``: orig's ring after U's (and the forward field's), which the
    samples, the correction and the clamp read)."""
    b, _, d, h, w = U.shape
    t = Tiles(flags.shape, D, seg_z, 2 if orig is None else 3)
    dims = (w, h, d)
    halfstr = STRENGTH * 0.5
    fluid = flags == FLUID
    fwd = torch.full_like(U, NAN)
    out = torch.full_like(U, NAN)
    for backward in (False, True):
        dst = out if backward else fwd
        for z0 in range(0, d, t.seg):
            z1 = min(z0 + t.seg, d)
            sources = ((U, fwd) if backward else (U,)) + (
                () if orig is None else (orig,))
            ring = t.empty_ring(len(sources))
            ko = 0 if orig is None else 3 * (len(sources) - 1)
            _, _, _, ahead, _ = m_constants()
            for Z in range(z0 - D, z0 + D + ahead + 1):
                t.load(ring, Z, z1, sources)
            for z in range(z0, z1):
                t.wait(ahead - 1)
                t.load(ring, z + D + 1 + ahead, z1, sources)
                Zc = torch.full_like(t.X, z)
                cell = (t.X, t.Y, Zc)
                c = [t.X.float() + 0.5, t.Y.float() + 0.5,
                     Zc.float() + 0.5]
                fl = t.at_cells(fluid, z)
                inside = ((t.X >= 1) & (t.X <= w - 2) & (t.Y >= 1)
                          & (t.Y <= h - 2) & (1 <= z <= d - 2))

                def at(k, dx, dy, dz):
                    return t.read(ring, k, t.X + dx, t.Y + dy, Zc + dz)

                for comp in range(3):
                    m = _mac(at, comp)
                    src = lambda X, Y, Z, k=ko + comp: t.read(ring, k, X, Y,
                                                              Z)
                    if not backward:
                        pos = [c[a] - DT * m[a] for a in range(3)]
                        val = torch.where(
                            fl, _trilinear(src, dims, D, c, pos),
                            src(*cell))
                    else:
                        ff = lambda X, Y, Z, k=comp: t.read(ring, 3 + k, X,
                                                            Y, Z)
                        pos = [c[a] - (-DT) * m[a] for a in range(3)]
                        bwd = torch.where(
                            fl, _trilinear(ff, dims, D, c, pos),
                            ff(*cell))
                        f0 = ff(*cell)
                        nb = t.at_cells(fluid, z,
                                        *[-int(a == comp) for a in range(3)])
                        skip = ~fl | ~nb
                        dst_v = torch.where(
                            skip, f0, f0 + halfstr * (src(*cell) - bwd))
                        vel = [torch.clamp(m[a] * DT, -D, D)
                               for a in range(3)]
                        mn = torch.full_like(dst_v, float("inf"))
                        mx = torch.full_like(dst_v, float("-inf"))
                        for sgn in (-1.0, 1.0):
                            lo = [(cell[a].float() + sgn * vel[a])
                                  .to(torch.int32).clamp(0, dims[a] - 2)
                                  .long() for a in range(3)]
                            for dk in (0, 1):
                                for dj in (0, 1):
                                    for di in (0, 1):
                                        o = src(lo[0] + di, lo[1] + dj,
                                                lo[2] + dk)
                                        mn = torch.minimum(mn, o)
                                        mx = torch.maximum(mx, o)
                        val = torch.maximum(torch.minimum(dst_v, mx), mn)
                    val = torch.where(inside, val, torch.zeros(()))
                    sel = t.owns.expand_as(val)
                    plane = dst[:, comp, z]
                    plane[t.bi.expand_as(val)[sel], t.Y.expand_as(val)[sel],
                          t.X.expand_as(val)[sel]] = val[sel]
    return out


def vel_inputs(seed, shape, D, scene=False):
    """Random obstacles (8%) or the scene's flags (the border shell
    alone), and U reaching 1.5 (D + 1) cells at DT: past the window clamp
    of D."""
    rng = np.random.default_rng(seed)
    flags = (empty_domain3(*shape).numpy() if scene
             else random_flags3(rng, shape))
    U = (1.5 * (D + 1) / DT * (2.0 * rng.random((shape[0], 3) + shape[1:])
                               - 1.0)).astype(np.float32)
    return torch.from_numpy(flags), torch.from_numpy(U)


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("scene", [False, True])
@pytest.mark.parametrize("shape", [(1, 19, 21, 37), (2, 37, 11, 13)])
def test_m_twin_equals_plain(shape, scene, D):
    flags, U = vel_inputs(D + sum(shape), shape, D, scene)
    want = advect_velocity3(DT, U, flags, STRENGTH, max_disp=D)
    assert torch.equal(twin_m(U, flags, D), want)


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("scene", [False, True])
def test_m_twin_with_orig_equals_plain(scene, D):
    """M with a viscous orig: the three-ring marches against
    ops3d.advect_velocity3(..., orig=orig)."""
    shape = (2, 13, 11, 37)
    flags, U = vel_inputs(7 + D, shape, D, scene)
    orig = add_viscosity3(DT, U, flags, 0.25)
    want = advect_velocity3(DT, U, flags, STRENGTH, max_disp=D, orig=orig)
    assert not torch.equal(want, advect_velocity3(DT, U, flags, STRENGTH,
                                                  max_disp=D))
    assert torch.equal(twin_m(U, flags, D, orig=orig), want)


@pytest.mark.parametrize("seg_z", [5, 1])
def test_m_twin_segments(seg_z):
    """Shorter z segments than the source's: more segment ends."""
    flags, U = vel_inputs(40 + seg_z, (2, 13, 10, 35), 2)
    want = advect_velocity3(DT, U, flags, STRENGTH, max_disp=2)
    assert torch.equal(twin_m(U, flags, 2, seg_z=seg_z), want)


def test_m_twin_matches_jax():
    """Against the JAX package's XLA window path at D = 1 (its D = 2 graph
    compiles for tens of seconds here)."""
    flags, U = vel_inputs(5, (1, 8, 16, 12), 1)
    want = np.asarray(jax.jit(lambda u, f: j_ops3d.advect_velocity3(
        DT, u, f, STRENGTH, impl="window", max_disp=1))(U.numpy(),
                                                        flags.numpy()))
    np.testing.assert_allclose(twin_m(U, flags, 1).numpy(), want, rtol=0,
                               atol=1e-5)


def test_constants_follow_the_sources():
    """The regexes find the kernels' constants; the ring's geometry and the
    capacity gate follow the sources; J runs I's march and counts its
    launches from it; the one-sweep path is gone."""
    tx, ty, seg, ahead, max_d = m_constants()
    assert tx == 32 and ty >= 1 and seg >= 1 and ahead >= 1 and max_d >= 4
    src = (CSRC / "advect3.cu").read_text()
    for expr in ("kW = kVTX + 2 * kD + 1", "kH = kVTY + 2 * kD + 1",
                 "kMinDepth = 2 * kD + 2 + kVAhead",
                 f"constexpr int kSmemMax = {SMEM_MAX};"):
        assert expr in src
    # The backward ring pair fits a block's 227 KB at every D, with a
    # power-of-two depth at D = 2 (the main paths'); with orig the three
    # rings fit up to kVMaxDOrig (power-of-two deep at D = 2) and not one
    # D further.
    for D in range(1, max_d + 1):
        kw, kh, depth = ring_shape(D)
        assert 2 * depth * 3 * kw * kh * 4 <= SMEM_MAX
    assert ring_shape(2)[2] == 8
    d_orig = max_d_orig()
    for D in range(1, d_orig + 2):
        kw, kh, depth = ring_shape(D, 3)
        assert (3 * depth * 3 * kw * kh * 4 <= SMEM_MAX) == (D <= d_orig)
    assert ring_shape(2, 3)[2] == 8 and d_orig >= 2
    assert "kRings * pow2_at_least(kMinDepth)" in src
    jac = (CSRC / "jacobi3.cu").read_text()
    assert "jacobi3_marches(init, rhs" in jac
    assert "jacobi3_sweep(" not in jac and not (CSRC / "jacobi3.cuh").exists()
    wrapper = (CSRC.parent / "ops" / "kernels" / "proj_tail3.py").read_text()
    assert "fn_jacobi3_max_sweeps" in wrapper
    advect = (CSRC.parent / "ops" / "kernels" / "advect3.py").read_text()
    assert "fn_advect3_velocity_max_disp" in advect
