"""The learned projections with the width split over the mesh's sx axis:
each runs on one receptive-field halo.

A learned projection reads, for each output cell, the input columns its
network can see (its receptive field) and those its tail reads. So the
sharded step exchanges the projection's inputs (p, U, flags, density, the
BC arrays) once with ``halo`` columns on each side (``pad_columns``: a
halo wider than a neighbour's slab takes several hops), runs the
single-device projection on the padded slab unchanged (kernel B and C for
the fused PUNet; the tower, ScaleNet or PUNet on B with the polish of
``polish_impl`` on the flax path; N and J or N's flax route and I in
3-D), and keeps the owned columns. Every owned output reads real data:
the 'SAME' zero padding at the padded slab's edge lies farther away than
the net can see. One exchange, not one a layer: the per-layer halos (less
redundant work, more exchanges) are a later candidate (ROADMAP §D).

``receptive_halo`` derives the reach from the nets' layer tables: kernel,
stride and dilation at each level's cell size, the patch, the pools, the
resizes' taps, the skip concats (the longer side counts). It bounds the
columns an output cell reads on each side and gives the alignment a
slab's first column needs: the patch times 2^(levels - 1) for PUNet (the
space-to-depth patch and the stride-2 levels start on the grid's
multiples), 4 for the tower (its pools) and ScaleNet (its quarter
scale). ``sharding_of`` adds the tail (its sweeps, 1 for the
divergence, 1 for the velocity update, 1 for the walls), the input's
divergence and the columns the step reads after the projection, and
rounds up to the alignment.

The scale is global: the networks normalise by a per-sample std over the
whole grid (``models/fluidnet.py::scale_std``). The sharded path computes
it over the owned cells (a two-pass mean and Bessel-corrected variance,
each sum all-reduced over the sx group, then the clamp at
``normalize_input_threshold``) and hands it to the projection as
``scale=``; halo cells never enter it.

Every projection factory (``make_project_fn``,
``make_project_fn_fused_forward``, ``make_project_fn3``,
``make_project_fn3_fused_forward``, ``make_project_fn_mg_learned``) sets
``project.kind`` with ``project.cfg`` and ``project.net`` (or
``project.mg``); ``sharding_of`` derives from them, in this one place,
how to shard it (a ``Sharding``). Where the projection runs kernel H's
"mg" polish, the net runs on the halo (``net_only=True``) and the sharded
kernel-H projection of ``parallel/multigrid.py`` follows; ``mg_learned``
runs ``solve_mg_learned_sharded``. The fused 3-D forward takes the whole
grid's shape (``grid=``) for its cube check.
"""
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..models.multi_scale import BRANCHES, resize_weights
from ..ops.ops3d import velocity_divergence3
from ..ops.stencils import set_wall_bcs, velocity_divergence, velocity_update
from .halo import crop, pad_columns
from .multigrid import (mg_epilogue_sharded, solve_mg_learned_sharded,
                        solve_mg_raw)


# The projections the factories make: ``project.kind`` names one, with
# ``project.cfg`` and ``project.net`` ("flax": models/fluidnet.py::
# make_project_fn; "fused": make_project_fn_fused_forward; "flax3" and
# "fused3": models/punet3d.py's twins) or ``project.mg``, the V-cycle's
# arguments ("mg_learned": models/mg_coarse.py).
KINDS = ("flax", "fused", "flax3", "fused3", "mg_learned")


class Sharding(NamedTuple):
    """How a projection runs width-sharded (``sharding_of``).

    ``kind``: the projection's; ``halo``: columns each side of the
    padded slab, a multiple of ``align``, the alignment of a slab's first
    column and width; ``polish``: "own" (the projection's own tail on the
    padded slab) or "mg" (the sharded kernel H after the net)."""
    kind: str
    halo: int
    align: int
    polish: str = "own"


# Columns the sharded step reads around the owned ones after an unfused
# projection (the stick walls read the next column's velocity).
OUT_HALO = 2


def _interval_conv(L, R, c, k, d=1):
    r = (k - 1) // 2 * d * c
    return L + r, R + r


def _unet_reach(table, patch):
    """(reach, alignment) of a PUNet or PUNet3 table (names embed, down*,
    enc*, mid*, up*, dec*, head, ref*)."""
    geo = {t[0]: (t[3], t[4], t[5] if len(t) > 5 else 1) for t in table}
    n = 1 + max((int(nm[4:]) for nm in geo if nm.startswith("down")),
                default=0)
    c, L, R = patch, 0, 0
    skips = []

    def convs(prefix, L, R, c):
        for nm in sorted(k for k in geo if k.startswith(prefix)):
            k, _, d = geo[nm]
            L, R = _interval_conv(L, R, c, k, d)
        return L, R

    for i in range(n):
        if i > 0:
            # A stride-2 'SAME' conv on an even input reads inputs 2j ..
            # 2j + k - 2 of output j (padding (0, k - 2)).
            k = geo[f"down{i}"][0]
            L, R, c = L, R + (k - 2) * c, 2 * c
        L, R = convs(f"enc{i}_", L, R, c)
        skips.append((L, R))
    L, R = convs("mid", L, R, c)
    for i in range(n - 2, -1, -1):
        c //= 2
        L, R = L + c, R + c
        L, R = max(L, skips[i][0]), max(R, skips[i][1])
        L, R = convs(f"dec{i}_", L, R, c)
    L, R = L + patch - 1, R + patch - 1
    L, R = convs("ref", L, R, 1)
    return max(L, R), patch * (1 << (n - 1))


def _resize_reach(L, R, c_in, c_out):
    """(L, R) after ``models/multi_scale.py::resize`` from cells of
    ``c_in`` to cells of ``c_out`` fine columns, from its own taps."""
    m = 64 * max(c_out // c_in, 1)
    n = m * c_in // c_out
    wt = resize_weights(m, n)
    L2 = R2 = 0
    for o in range(n // 4, 3 * n // 4):
        idx = torch.nonzero(wt[:, o]).flatten()
        lo, hi = int(idx.min()), int(idx.max())
        L2 = max(L2, o * c_out - (lo * c_in - L))
        R2 = max(R2, (hi + 1) * c_in - 1 + R - ((o + 1) * c_out - 1))
    return L2, R2


def _tower_reach(table):
    geo = {t[0]: t[3] for t in table}
    L = R = (geo["conv1"] - 1) // 2
    best = 0
    for k in (1, 2, 4):
        a = b = L
        for nm in ("bank_conv1", "bank_conv2"):
            a, b = _interval_conv(a, b, k, geo[nm])
        best = max(best, a + k - 1, b + k - 1)
    return best, 4


def _multiscale_reach(table):
    def branch(name, L, R, c):
        kernels = next(ks for b, _, ks in BRANCHES if b == name)
        for k in kernels:
            L, R = _interval_conv(L, R, c, k)
        return L, R

    q = branch("convN_4", *_resize_reach(0, 0, 1, 4), 4)
    qh = _resize_reach(*q, 4, 2)
    xh = _resize_reach(0, 0, 1, 2)
    hf = branch("convN_2", max(qh[0], xh[0]), max(qh[1], xh[1]), 2)
    up = _resize_reach(*hf, 2, 1)
    f = branch("convN_1", up[0], up[1], 1)
    return max(f), 4


def receptive_halo(layer_table, patch=None):
    """(columns an output cell reads on each side, alignment of a slab's
    first column) of a network's layer table: ``models/punet.py::
    layer_table`` or ``models/punet3d.py::layer_table3`` (with ``patch``),
    ``models/fluidnet.py::tower_table`` or ``models/multi_scale.py::
    multiscale_table``."""
    names = {t[0] for t in layer_table}
    if "embed" in names:
        return _unet_reach(layer_table, patch)
    if "bank_conv1" in names:
        return _tower_reach(layer_table)
    if "final" in names:
        return _multiscale_reach(layer_table)
    raise ValueError(f"no receptive field rule for the layers {sorted(names)}")


def _round_up(x, a):
    return -(-x // a) * a


def sharding_of(project_fn) -> Sharding:
    """The ``Sharding`` of a projection the factories made, from its
    ``kind``, ``cfg`` and ``net``; raises ``ValueError`` naming what it
    lacks. The halo is the net's reach, 1 for the input's divergence, the
    tail's reach (its sweeps, 1 for the divergence, 1 for the velocity
    update, 1 for the walls; none before the sharded "mg" polish) and
    ``OUT_HALO``, rounded up to the alignment."""
    kind = getattr(project_fn, "kind", None)
    if kind not in KINDS:
        raise ValueError(
            "the width-sharded step needs a projection that says how to "
            f"shard it (parallel/project.py::sharding_of): a `kind` of "
            f"{KINDS}, as make_project_fn, make_project_fn_fused_forward, "
            "make_project_fn3, make_project_fn3_fused_forward and "
            "make_project_fn_mg_learned set it; this one has none")
    if kind == "mg_learned":
        return Sharding(kind, OUT_HALO + 2, 1)
    cfg, net = project_fn.cfg, project_fn.net
    # The fused forward runs kernel H whenever polish_impl is "mg"; the
    # flax path only with polish sweeps (models/fluidnet.py).
    mg = cfg.polish_impl == "mg" and (
        kind == "fused" or (kind == "flax" and cfg.polish_sweeps > 0))
    reach, align = receptive_halo(net.table, getattr(net, "patch", None))
    sweeps = cfg.polish_sweeps
    tail = 0 if mg else (sweeps + 3 if sweeps else 2)
    halo = _round_up(reach + 1 + tail + OUT_HALO, align)
    return Sharding(kind, halo, align, "mg" if mg else "own")


def global_std(mesh, x, threshold: float):
    """(b,) std of ``x`` (this rank's owned cells, b leading) over the
    whole grid: a two-pass mean and Bessel-corrected variance, each sum in
    float64 all-reduced over the sx group, clamped below at
    ``threshold``."""
    y = x.reshape(x.shape[0], -1).to(torch.float64)
    n = torch.full((x.shape[0],), float(y.shape[1]), dtype=torch.float64,
                   device=x.device)
    s1 = torch.sum(y, dim=1)
    both = torch.stack([s1, n])
    if mesh.sx > 1:
        dist.all_reduce(both, group=mesh.row)
    mean = both[0] / both[1]
    s2 = torch.sum((y - mean[:, None]) ** 2, dim=1)
    if mesh.sx > 1:
        dist.all_reduce(s2, group=mesh.row)
    std = torch.sqrt(s2 / (both[1] - 1.0)).to(torch.float32)
    return torch.clamp(std, min=threshold)


def _scale(mesh, cfg, f, bcs, lw, wl):
    """The global input scale of the padded fields ``f`` (the inlet BCs
    ``bcs`` applied first, as the fused projection does), or None without
    ``normalize_input``."""
    if not cfg.normalize_input:
        return None
    U = f["U"]
    if bcs:
        U = U * bcs["U_bc_inv_mask"] + bcs["U_bc"]
    chan = {"pDiv": lambda: crop(f["p"], lw, wl),
            "UDiv": lambda: crop(U, lw, wl),
            "div": lambda: _divergence(U, f["flags"], lw, wl)}[
                cfg.normalize_input_chan]()
    return global_std(mesh, chan, cfg.normalize_input_threshold)


def project_sharded(project_fn, mesh, fields: dict, out_halo: int = 0,
                    fused: bool = False):
    """Run ``project_fn`` width-sharded on this rank's slabs ``fields``
    (p, U, flags, density and, where the state has them, U_bc and
    U_bc_inv_mask), each the owned columns; ``fused``: the step's fused
    branch, which hands the projection the inlet BCs. Returns (p of the
    owned columns, U of the owned columns and up to ``out_halo`` more each
    side, the left and right widths of that window)."""
    sh = sharding_of(project_fn)
    flags = fields["flags"]
    wl = flags.shape[-1]
    if wl % sh.align:
        raise ValueError(
            f"a slab {wl} columns wide does not split the projection's "
            f"strided levels: its width must be a multiple of {sh.align}")
    names = [n for n in ("p", "U", "flags", "density", "U_bc",
                         "U_bc_inv_mask") if fields.get(n) is not None]
    padded, lw, rw = pad_columns(mesh, [fields[n] for n in names], sh.halo)
    f = dict(zip(names, padded))
    l2, r2 = min(out_halo, lw), min(out_halo, rw)
    if sh.kind == "mg_learned":
        return _mg_learned(mesh, project_fn.mg, f, lw, wl, out_halo)
    bcs = ({k: f[k] for k in ("U_bc", "U_bc_inv_mask") if k in f}
           if fused else {})
    kw = dict(bcs, scale=_scale(mesh, project_fn.cfg, f, bcs, lw, wl))
    if sh.kind == "fused3":
        # The cube check is the whole grid's, not the padded slab's.
        kw["grid"] = (*flags.shape[1:-1], wl * mesh.sx)
    args = (f["p"], f["U"], f["flags"], f["density"])
    if sh.polish == "mg":
        p0 = crop(project_fn(*args, **kw, net_only=True), lw, wl)
        U_in = f["U"]
        if "U_bc" in bcs:
            U_in = U_in * bcs["U_bc_inv_mask"] + bcs["U_bc"]
        div = _divergence(U_in, f["flags"], lw, wl)
        _, p, sums = solve_mg_raw(mesh, crop(f["flags"], lw, wl), div,
                                  n_vcycles=1, p0=p0)
        p, U, l2, r2 = mg_epilogue_sharded(mesh, f["flags"], U_in, lw, p,
                                           sums, out_halo)
        if "U_bc" in bcs:
            a, b = lw - l2, lw + wl + r2
            U = U * bcs["U_bc_inv_mask"][..., a:b] + bcs["U_bc"][..., a:b]
        return p, U, l2, r2
    p, U = project_fn(*args, **kw)
    return (crop(p, lw, wl), U[..., lw - l2:lw + wl + r2].contiguous(), l2,
            r2)


def _divergence(U, flags, lw, wl):
    """The owned columns of the divergence of a padded slab."""
    div_of = velocity_divergence3 if flags.dim() == 4 else velocity_divergence
    return crop(div_of(U, flags), lw, wl)


def _mg_learned(mesh, mg, f, lw, wl, out_halo):
    """mg_learned on the slabs: the divergence, the sharded learned
    V-cycle, the velocity update and the walls on the owned columns and
    ``out_halo`` more."""
    mg = dict(mg)
    coarse_fn = mg.pop("coarse_fn")
    div = _divergence(f["U"], f["flags"], lw, wl)
    p = solve_mg_learned_sharded(mesh, crop(f["flags"], lw, wl), div,
                                 coarse_fn, **mg)
    (p3,), l3, r3 = pad_columns(mesh, [p], out_halo + 1)
    a, b = lw - l3, lw + wl + r3
    flags = f["flags"][..., a:b]
    U = set_wall_bcs(velocity_update(p3, f["U"][..., a:b], flags), flags)
    l2, r2 = min(out_halo, l3), min(out_halo, r3)
    return p, U[..., l3 - l2:l3 + wl + r2].contiguous(), l2, r2


__all__ = ["KINDS", "Sharding", "receptive_halo", "global_std",
           "project_sharded", "sharding_of", "OUT_HALO"]
