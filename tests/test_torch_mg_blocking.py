"""The per-level launches of kernels G and H (``csrc/mg.cu``), held bit for
bit to the plain multigrid chain on the CPU.

A level too large for the single-block tail runs two launches a V-cycle
on square tiles of T x T cells (T = 32 or 64) with an even halo:

* the down launch: the compatibility projection of the RHS, k pre-sweeps
  from p (or zeros), the residual, ``_fold_border`` and the 2x2 child sum
  of the output tile into the coarse RHS, and the output tile's p (halo:
  k plus the residual's ring, rounded up to even; the fold reads one cell
  further only next to the border ring, whose p every sweep pins to 0);
* the up launch: both ``_neumann_extend`` passes over the tile's coarse
  region (the tile's coarse cells and kExtHalo more a side, indices
  wrapped as the plain version's rolls wrap), the prolongation added onto
  p over the whole tile, k post-sweeps, the output tile's p (halo: k
  rounded up to even).

The kernels run only on the card, so here plain-torch twins of both
launches, with their constants read from the CUDA source, are held with
``torch.equal`` to ``ops/multigrid.py``'s chain, given the same level
mean (the launches take it from per-block partial sums, in another order
than PyTorch's reduction): ``_remove_incompatible``, the sweeps,
``residual``, ``_restrict_sum`` (which folds) for the down launch;
``_neumann_extend``, ``_prolong``, the add and the sweeps for the up
launch. A twin reads NaN wherever the kernel reads memory with no exact
value (past the tile's or the coarse region's edge): a NaN that reached a
written cell would fail the comparison. Cases: shapes that are not
multiples of the tile, b = 2, both tile sides, the periodic
Rayleigh-Taylor flags, 8% obstacles, pre/post 1 and 4, cold and warm.
One case holds a V-cycle whose upper levels run the twins to the JAX
package's ``solve_mg`` (1e-5 of max|p|: the sums run in another order).
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.ops import multigrid as j_mg
from fluidnet_cxx_tpu_torch.ops import multigrid as t_mg
from fluidnet_cxx_tpu_torch.ops.jacobi import solve_jacobi_fixed
from fluidnet_cxx_tpu_torch.sim.scenes import create_rayleigh_taylor_scene
from test_torch_jacobi_blocking import _axis, _inner, _shift, _tiles

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "fluidnet_cxx_tpu_torch" / "csrc"
DAMPING = 2.0 / 3.0
NEIGHBOURS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def mg_constants():
    """kMaxSweeps, kResidHalo, kExtHalo and the tile sides of csrc/mg.cu."""
    src = (CSRC / "mg.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    sides = sorted({int(t) for t in re.findall(r"launch_down<(\d+)>\(", src)})
    return dict(max_sweeps=const("kMaxSweeps"),
                resid_halo=const("kResidHalo"),
                ext_halo=const("kExtHalo"), sides=sides)


C = mg_constants()


def down_halo(k):
    """A down launch's halo: k sweeps, then the residual's ring."""
    return (k + C["resid_halo"] + 1) & ~1


def up_halo(k):
    return (k + 1) & ~1


def _level_tiles(flags, side, halo):
    """Tile index grids of a level and its cell masks as tiles: cont, the
    obstacle-neighbour bits, in-grid, and the cells' global (y, x)."""
    _, h, w = flags.shape
    out = side - 2 * halo
    ys, in_y = _axis(out, halo, side, h)
    xs, in_x = _axis(out, halo, side, w)
    ob = flags == 2
    inner = torch.zeros_like(ob)
    inner[:, 1:-1, 1:-1] = True
    cont = _tiles(inner & ~ob, ys, in_y, xs, in_x, False)
    nbr = {d: _tiles(torch.roll(ob, (-d[0], -d[1]), (1, 2)), ys, in_y, xs,
                     in_x, False) for d in NEIGHBOURS}
    ingrid = _tiles(torch.ones_like(ob), ys, in_y, xs, in_x, False)
    gy = ys[:, None, :, None].expand(-1, xs.shape[0], -1, side)
    gx = xs[None, :, None, :].expand(ys.shape[0], -1, side, -1)
    return dict(ys=ys, in_y=in_y, xs=xs, in_x=in_x, cont=cont, nbr=nbr,
                ingrid=ingrid, gy=gy, gx=gx, h=h, w=w, halo=halo)


def _sweeps(t, rhs, g, k, damping):
    """k Jacobi sweeps of tiles t (common.cuh::jacobi_update's order)."""
    for _ in range(k):
        p1 = torch.where(g["nbr"][0, -1], t, _shift(t, 0, -1))
        p2 = torch.where(g["nbr"][0, 1], t, _shift(t, 0, 1))
        p3 = torch.where(g["nbr"][-1, 0], t, _shift(t, -1, 0))
        p4 = torch.where(g["nbr"][1, 0], t, _shift(t, 1, 0))
        upd = (p1 + p2 + p3 + p4 + rhs) * 0.25
        if damping != 1.0:
            upd = (1.0 - damping) * t + damping * upd
        t = torch.where(g["cont"], upd, torch.zeros(()))
    return t


def _projected(rhs, g, mean):
    """The tiles' RHS after the compatibility projection with ``mean``."""
    raw = _tiles(rhs, g["ys"], g["in_y"], g["xs"], g["in_x"], 0.0)
    return (raw - mean[:, None, None, None, None]) * g["cont"].float()


def _fold_rows(R, Y, h):
    r = torch.where(Y == 2, R + _shift(R, -1, 0), R)
    r = torch.where(Y == h - 3, r + _shift(R, 1, 0), r)
    return torch.where((Y == 1) | (Y == h - 2), torch.zeros(()), r)


def _fold(R, g):
    """_fold_border of residual tiles R (the kernel's fold, cell by cell)."""
    Y, X, h, w = g["gy"], g["gx"], g["h"], g["w"]
    rr = _fold_rows(R, Y, h)
    r = torch.where(X == 2, rr + _fold_rows(_shift(R, 0, -1), Y, h), rr)
    r = torch.where(X == w - 3, r + _fold_rows(_shift(R, 0, 1), Y, h), r)
    return torch.where((X == 1) | (X == w - 2), torch.zeros(()), r)


def twin_down(flags, rhs, mean, k, side, p=None, damping=DAMPING):
    """The down launch at tile side ``side``: (p after k sweeps, the coarse
    RHS) as the kernel writes them."""
    b, h, w = flags.shape
    halo = down_halo(k)
    g = _level_tiles(flags, side, halo)
    rhs_t = _projected(rhs, g, mean)
    t = _tiles(torch.zeros_like(rhs) if p is None else p, g["ys"], g["in_y"],
               g["xs"], g["in_x"], 0.0)
    t = _sweeps(t, rhs_t, g, k, damping)
    acc = torch.zeros(())
    for d in NEIGHBOURS:
        acc = acc + torch.where(g["nbr"][d], t, _shift(t, *d))
    res = torch.where(g["cont"], rhs_t - (4.0 * t - acc), torch.zeros(()))
    f = _fold(res, g)
    coarse = ((f[..., 0::2, 0::2] + f[..., 0::2, 1::2])
              + (f[..., 1::2, 0::2] + f[..., 1::2, 1::2]))
    return (_inner(t, halo, h, w), _inner(coarse, halo // 2, h // 2, w // 2))


def _region(field, g, side):
    """The up launch's coarse region of every tile, indices wrapped."""
    _, hc, wc = field.shape
    cr = side // 2 + 2 * C["ext_halo"]
    oy = g["ys"][:, 0] // 2 - C["ext_halo"]
    ox = g["xs"][:, 0] // 2 - C["ext_halo"]
    cy = (oy[:, None] + torch.arange(cr)[None]) % hc
    cx = (ox[:, None] + torch.arange(cr)[None]) % wc
    return field[..., cy[:, None, :, None], cx[None, :, None, :]]


def _extend_pass(e, live):
    num = torch.zeros(())
    den = torch.zeros(())
    for d in NEIGHBOURS:
        num = num + _shift(e, *d) * _shift(live, *d)
    for d in NEIGHBOURS:
        den = den + _shift(live, *d)
    fill = num / torch.clamp(den, min=1.0)
    return (torch.where(live > 0.5, e, fill),
            torch.maximum(live, (den > 0.5).float()))


def twin_up(flags, flags_c, rhs, mean, e_c, p, k, side, damping=DAMPING):
    """The up launch at tile side ``side``: p after the prolongation of the
    extended correction ``e_c`` and k sweeps, as the kernel writes it."""
    b, h, w = flags.shape
    halo = up_halo(k)
    g = _level_tiles(flags, side, halo)
    ob_c = flags_c == 2
    inner_c = torch.zeros_like(ob_c)
    inner_c[:, 1:-1, 1:-1] = True
    live = _region((inner_c & ~ob_c).float(), g, side)
    e = _region(e_c, g, side) * live
    e, live = _extend_pass(e, live)
    e, _ = _extend_pass(e, live)
    # Fine tile cell (ly, lx) -> coarse region cell ((ly >> 1) + kExtHalo,
    # ...) and its -/+ 1 neighbour by the cell's parity.
    lc = torch.arange(side) // 2 + C["ext_halo"]
    lc2 = lc + torch.where(torch.arange(side) % 2 == 1, 1, -1)

    def at(ry, rx):
        return e[..., ry[:, None], rx[None, :]]

    gy_ = 0.75 * at(lc, lc) + 0.25 * at(lc2, lc)
    gy2 = 0.75 * at(lc, lc2) + 0.25 * at(lc2, lc2)
    v = torch.where(g["cont"], 0.75 * gy_ + 0.25 * gy2, torch.zeros(()))
    t = _tiles(p, g["ys"], g["in_y"], g["xs"], g["in_x"], 0.0)
    t = torch.where(g["ingrid"], t + v, t)
    t = _sweeps(t, _projected(rhs, g, mean), g, k, damping)
    return _inner(t, halo, h, w)


def plain_mean(flags, rhs):
    """The level mean of ops/multigrid.py::_remove_incompatible."""
    m = t_mg._cont_mask(flags)
    return (torch.sum(rhs * m, dim=(1, 2))
            / torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0))


def plain_down(flags, rhs, k, p=None, damping=DAMPING):
    rhsp = t_mg._remove_incompatible(flags, rhs)
    p = solve_jacobi_fixed(flags, rhsp, k, p0=p, damping=damping)
    return p, t_mg._restrict_sum(t_mg.residual(flags, rhsp, p))


def plain_up(flags, flags_c, rhs, e_c, p, k, damping=DAMPING):
    rhsp = t_mg._remove_incompatible(flags, rhs)
    e = t_mg._neumann_extend(flags_c, e_c)
    p = p + torch.where(t_mg._cont(flags), t_mg._prolong(e),
                        torch.zeros(()))
    return solve_jacobi_fixed(flags, rhsp, k, p0=p, damping=damping)


def _system(kind, b, h, w, seed):
    """(flags, a RHS, a warm p, a coarse correction) of one level."""
    rng = np.random.default_rng(seed)
    if kind == "rt":
        flags = create_rayleigh_taylor_scene(w, h, batch=b).flags
    else:
        flags = torch.from_numpy(random_flags(rng, b, h, w,
                                              p_obstacle=0.08))
    rhs = torch.from_numpy(rng.standard_normal((b, h, w)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((b, h, w)).astype(np.float32))
    e_c = torch.from_numpy(
        rng.standard_normal((b, h // 2, w // 2)).astype(np.float32))
    return flags, rhs, p, e_c


# 78x102 and 58x86: the fold's column w-3 (k = 4, 32^2 tiles) and row h-3
# (k = 1, 64^2 tiles) fall on a tile's last output cell, so the fold reads
# the residual of a halo cell there.
CASES = [("obstacles", 2, 78, 102), ("rt", 1, 64, 32),
         ("obstacles", 1, 140, 120), ("obstacles", 1, 58, 86)]


def case_id(case):
    kind, b, h, w = case
    return f"{kind}{b}x{h}x{w}"


def test_constants_follow_the_sources():
    """The regexes find the kernels' constants; the halo rules of the
    Solve class are the twins'; the wrapper counts what C reports."""
    assert C["sides"] == [32, 64]
    assert C["max_sweeps"] >= 4 and C["resid_halo"] == 1
    assert C["ext_halo"] == 3
    src = (CSRC / "mg.cu").read_text()
    assert "const int halo = restrict_ ? ((k + kResidHalo + 1) & ~1) : k;" \
        in src
    assert "const int halo = (k + 1) & ~1;" in src
    for side in C["sides"]:
        assert side - 2 * down_halo(C["max_sweeps"]) > 0
    wrapper = (CSRC.parent / "ops" / "kernels" / "mg.py").read_text()
    assert "fn_mg_launches" in wrapper and "fn_mg_workspace" in wrapper


@pytest.mark.parametrize("side", [32, 64])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_down_twin_equals_plain(case, start, k, side):
    flags, rhs, p, _ = _system(*case, seed=case[2] + k)
    p0 = p if start == "warm" else None
    got = twin_down(flags, rhs, plain_mean(flags, rhs), k, side, p=p0)
    want = plain_down(flags, rhs, k, p=p0)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("side", [32, 64])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_up_twin_equals_plain(case, k, side):
    flags, rhs, p, e_c = _system(*case, seed=case[3] + k)
    flags_c = t_mg._coarsen_flags(flags)
    got = twin_up(flags, flags_c, rhs, plain_mean(flags, rhs), e_c, p, k,
                  side)
    assert torch.equal(got, plain_up(flags, flags_c, rhs, e_c, p, k))


def twin_vcycle(lvls, rhs, p, lvl, twin_levels, side, pre=4, post=4,
                coarse=32):
    """One V-cycle whose levels above ``twin_levels`` run the twins (the
    per-level launches) and the rest ops/multigrid.py's recursion (the
    single-block tail, whose per-cell order is the same)."""
    if lvl >= twin_levels:
        return t_mg._vcycle(lvls, rhs, p, lvl, pre, post, coarse, DAMPING)
    flags = lvls[lvl]
    mean = plain_mean(flags, rhs)
    p, rhs_c = twin_down(flags, rhs, mean, pre, side, p=p)
    e = twin_vcycle(lvls, rhs_c, torch.zeros_like(rhs_c), lvl + 1,
                    twin_levels, side, pre, post, coarse)
    return twin_up(flags, lvls[lvl + 1], rhs, mean, e, p, post, side)


def test_twin_vcycle_matches_jax():
    """Two warm V-cycles with the top two levels of 96x64 (8% obstacles)
    on the twins against the JAX package's solve_mg."""
    flags, rhs, p0, _ = _system("obstacles", 1, 96, 64, seed=5)
    lvls = t_mg._levels(flags, 8)
    assert len(lvls) == 4
    p = p0
    for _ in range(2):
        p = twin_vcycle(lvls, rhs, p, 0, 2, 32)
    cont = t_mg._cont_mask(flags)
    mean = (torch.sum(p * cont, dim=(1, 2), keepdim=True)
            / torch.clamp(torch.sum(cont, dim=(1, 2), keepdim=True), min=1.0))
    got = (cont * (p - mean)).numpy()
    want = np.asarray(jax.jit(lambda f, d, q: j_mg.solve_mg(
        f, d, n_vcycles=2, p0=q))(flags.numpy(), rhs.numpy(), p0.numpy()))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
