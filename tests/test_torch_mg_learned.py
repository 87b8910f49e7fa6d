"""mg_learned, the learned coarse-grid correction inside the multigrid
V-cycle, port against the JAX package on the CPU: ``cut_level``,
``solve_mg(coarse_fn=...)``, ``mg_cut_rhs``, ``MGCoarseNet``, the plume
step with ``make_project_fn_mg_learned``; the kernel route's split of a
V-cycle at the cut as a plain-torch twin; its planner.

The flax ``MGCoarseNet`` computes its PUNet in bfloat16 (flax PUNet's
default dtype, which ``models/mg_coarse.py`` does not set), and so does
the port's by default (kernel B's bfloat16 route, flax's rounding points:
tests/test_torch_bf16_conv.py). Most tests here run the float32 variant
on both sides (JAX's ``PUNet`` name in ``models/mg_coarse.py`` bound to a
float32 PUNet for the module's tests, the port's ``dtype="float32"``),
held at 1e-4 of the largest output. Two tests hold the port's bfloat16
net to JAX's, under JAX's default XLA settings (``_default_xla``; the
module's fixture turns its optimisations off, which moves JAX's own
V-cycle pressure by 4.5e-3 and 3.0e-3 of its largest value on the trained
case): random weights at 32^2, and the trained MGCoarse_128 on a 128^2
coarse solve, the net's output and the pressure of the V-cycle around
it. At 32^2 every layer is bit-equal (held at 2e-7, twice the gap). On
the trained case the gap is set by a few values of one layer that a float32 sum
taken in another order rounds to the other bfloat16 (enc0_0: 1-3 of
16384 on the trained case, every other layer bit-equal), which the net
carries to its output: the output within 3e-2 of its largest value, the
pressure within 8e-3 (twice its largest gap, 3.66e-3).

Tolerances: the net 1e-4 of its largest output (the two frameworks sum a
convolution in another order); ``solve_mg`` and ``mg_cut_rhs`` 1e-5 of
max|p| (the level means sum in another order); the plume steps 1e-4 of
each field's largest value (tests/test_torch_step.py's). The twin is held
with ``torch.equal``.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.models import mg_coarse as j_mgc
from fluidnet_cxx_tpu.models.punet import PUNet as FlaxPUNet
from fluidnet_cxx_tpu.ops import multigrid as j_mg
from fluidnet_cxx_tpu.ops import stencils as j_st
from fluidnet_cxx_tpu.sim import create_plume_scene as j_scene
from fluidnet_cxx_tpu.sim import plume_config as j_config
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu_torch.models import mg_coarse as t_mgc
from fluidnet_cxx_tpu_torch.models.convert import (
    flax_mg_coarse_to_state_dict, random_flax_params)
from fluidnet_cxx_tpu_torch.ops import multigrid as t_mg
from fluidnet_cxx_tpu_torch.ops.kernels import mg as k_mg
from fluidnet_cxx_tpu_torch.run_plume import build_mg_coarse, plume_case
from fluidnet_cxx_tpu_torch.sim.step import simulate_step
from test_torch_jacobi_blocking import _inner, _tiles
from test_torch_mg_blocking import (_level_tiles, _projected, _sweeps,
                                    plain_mean, twin_down, twin_up)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "fluidnet_cxx_tpu_torch" / "csrc"
SMALL = t_mgc.MGCoarseConfig(widths=(32, 32))
# The bfloat16 nets at 32^2 with random weights (gap 6.6e-8: every layer
# bit-equal, the float32 glue around them summed in another order).
BF16_NET_TOL = 2e-7


@pytest.fixture
def _default_xla():
    """JAX's default XLA settings for one test (scripts/ run so), the
    module's setting restored after."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(autouse=True, scope="module")
def _float32_flax_net():
    """The JAX MGCoarseNet with a float32 PUNet, and XLA's optimisation
    passes off (they change no result beyond rounding and double the
    compile time); both restored for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_mgc, "PUNet", functools.partial(FlaxPUNet,
                                                     dtype="float32"))
        yield
    jax.config.update("jax_disable_most_optimizations", old)


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def nets(cfg=SMALL, seed=0, dtype="float32"):
    """(the port's MGCoarseNet in ``dtype``, the flax one, its flax
    params) with the same flax-initialised weights."""
    net = t_mgc.MGCoarseNet(cfg, dtype)
    params = {"punet": random_flax_params(net.punet.table, seed)}
    net.load_state_dict(flax_mg_coarse_to_state_dict(params))
    jnet = j_mgc.MGCoarseNet(j_mgc.MGCoarseConfig(**vars(cfg)))
    return net.eval(), jnet, {"params": params}


def scene(rng, h=64, w=64):
    """JAX's tests/test_mg_learned.py scene: walls, a box obstacle, the
    divergence of a random U after the wall BCs."""
    flags = np.array(j_st.empty_domain(1, h, w))
    flags[0, 20:28, 30:40] = 2
    U = j_st.set_wall_bcs(
        jnp.asarray(rng.standard_normal((1, 2, h, w)), jnp.float32),
        jnp.asarray(flags))
    div = np.array(j_st.velocity_divergence(U, jnp.asarray(flags)))
    return flags, div


@pytest.mark.parametrize("h,w,size,want", [
    (64, 64, 32, 1), (64, 64, 16, 2), (64, 64, 64, None), (64, 64, 4, None),
    (512, 512, 128, 2), (512, 128, 128, 2), (800, 8000, 128, None),
    (96, 160, 48, 2)])
def test_cut_level_matches_jax(h, w, size, want):
    shapes = t_mg.level_shapes(h, w)
    lvls = [np.zeros((1,) + s, np.int32) for s in shapes]
    assert j_mg._cut_level(lvls, size) == want
    assert t_mg.cut_level(shapes, size) == want
    assert t_mg._cut_level([torch.from_numpy(f) for f in lvls],
                           size) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mg_coarse_net_matches_jax(rng, dtype, monkeypatch, request):
    """The port's MGCoarseNet against flax's with the weights carried
    across, 32^2, 10% obstacles: output, gauge and pinning; the bfloat16
    nets under JAX's default XLA settings."""
    if dtype == "bfloat16":
        monkeypatch.setattr(j_mgc, "PUNet", FlaxPUNet)
        request.getfixturevalue("_default_xla")
    net, jnet, params = nets(dtype=dtype)
    flags = random_flags(rng, 2, 32, 32, p_obstacle=0.1)
    rhs = (3.0 * rng.standard_normal((2, 32, 32))).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)(params, flags, rhs))
    with torch.no_grad():
        got = net(T(flags), T(rhs))
    close(got, want, 1e-4 if dtype == "float32" else BF16_NET_TOL)
    cont = t_mgc._cont(T(flags))
    assert float((got * (1 - cont)).abs().max()) == 0.0
    assert float((got * cont).sum(dim=(1, 2)).abs().max()) < 1e-3


@pytest.mark.parametrize("start", ["1 cold", "2 warm"])
def test_solve_mg_with_coarse_fn_matches_jax(rng, start):
    """solve_mg with the learned coarse solve at 64^2, coarse_size 32 (the
    cut at 32^2), as tests/test_mg_learned.py runs it."""
    flags, div = scene(rng)
    n, p0 = (1, None) if start == "1 cold" else (
        2, rng.standard_normal(div.shape).astype(np.float32))
    net, jnet, params = nets()
    want = np.asarray(jax.jit(lambda f, d, q: j_mg.solve_mg(
        f, d, n_vcycles=n, p0=q, coarse_size=32,
        coarse_fn=j_mgc.make_coarse_fn(jnet, params)))(flags, div, p0))
    got = k_mg.solve_mg(T(flags), T(div), n_vcycles=n,
                        p0=None if p0 is None else T(p0), coarse_size=32,
                        coarse_fn=t_mgc.make_coarse_fn(net))
    close(got, want, 1e-5)


def test_mg_cut_rhs_matches_jax(rng):
    flags, div = scene(rng)
    want_f, want_r = jax.jit(lambda f, d: j_mg.mg_cut_rhs(
        f, d, coarse_size=32))(flags, div)
    got_f, got_r = t_mg.mg_cut_rhs(T(flags), T(div), coarse_size=32)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    close(got_r, want_r, 1e-5)
    with pytest.raises(ValueError, match="no level"):
        t_mg.mg_cut_rhs(T(flags), T(div), coarse_size=4)


def to_flax(state_dict):
    """The port's MGCoarseNet state_dict -> flax params (inverse of
    flax_mg_coarse_to_state_dict)."""
    out = {}
    for key, t in state_dict.items():
        _, _, name, kind = key.split(".")
        leaf = out.setdefault(name, {})
        leaf["kernel" if kind == "weight" else "bias"] = (
            t.permute(2, 3, 1, 0).numpy() if kind == "weight" else t.numpy())
    return {"params": {"punet": out}}


def test_mg_learned_plume_steps_match_jax():
    """Three steps of the 64^2 plume with the trained MGCoarse_128 taking
    over the 32^2 level, through the step's unfused branch. JAX runs
    max_disp 1 and the port 4: equal while no back-trace exceeds one cell
    (asserted), as in tests/test_torch_step.py."""
    cfg, state, _ = plume_case(64, device="cpu", sim_method="mg_learned")
    assert cfg.sim_method == "convnet" and cfg.max_disp == 4
    model = build_mg_coarse(dtype="float32")
    project = t_mgc.make_project_fn_mg_learned(model, coarse_size=32)
    assert not getattr(project, "handles_const_vals", False)
    jnet = j_mgc.MGCoarseNet(j_mgc.MGCoarseConfig(**vars(model.cfg)))
    j_project = j_mgc.make_project_fn_mg_learned(
        jnet, to_flax(model.state_dict()), coarse_size=32)
    jcfg = j_config(dt=0.1, line_trace=True, line_trace_impl="firsthit",
                    max_disp=1, use_pallas=False, sim_method="convnet")
    jstate = j_scene(64, 64, density_val=0.1, u_scale=1.0, rad=0.145)
    jax_step = jax.jit(lambda s: j_step(jcfg, s, project_fn=j_project))
    with torch.no_grad():
        for _ in range(3):
            assert 0.1 * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step(cfg, state, project)
            for field in ("U", "density", "p"):
                close(getattr(state, field), getattr(jstate, field), 1e-4)
        with pytest.raises(ValueError, match="project_fn"):
            simulate_step(cfg, state)



@pytest.mark.parametrize("p_obstacle", [0.0, 0.08])
def test_trained_net_matches_bfloat16_jax(rng, p_obstacle, monkeypatch,
                                          _default_xla):
    """The trained MGCoarse_128 through JAX's own bfloat16 MGCoarseNet
    against the port's bfloat16 net (its default), on a 128^2 coarse
    solve: the cut level of one cold V-cycle at 256^2 (walls, 0 or 8%
    obstacles, the divergence of a random U after the wall BCs). The
    net's output within 3e-2 of its largest value and the V-cycle's
    pressure within 8e-3 (the module's docstring); the gaps are printed
    (``pytest -s``)."""
    monkeypatch.setattr(j_mgc, "PUNet", FlaxPUNet)
    flags = random_flags(rng, 1, 256, 256, p_obstacle=p_obstacle)
    U = j_st.set_wall_bcs(jnp.asarray(rng.standard_normal((1, 2, 256, 256)),
                                      jnp.float32), jnp.asarray(flags))
    div = np.array(j_st.velocity_divergence(U, jnp.asarray(flags)))
    model = build_mg_coarse()
    jnet = j_mgc.MGCoarseNet(j_mgc.MGCoarseConfig(**vars(model.cfg)))
    params = to_flax(model.state_dict())
    flags_c, rhs_c = t_mg.mg_cut_rhs(T(flags), T(div), coarse_size=128)
    assert flags_c.shape == (1, 128, 128)
    want = jax.jit(jnet.apply)(params, flags_c.numpy(), rhs_c.numpy())
    want_p = jax.jit(lambda f, d: j_mg.solve_mg(
        f, d, n_vcycles=1, coarse_fn=j_mgc.make_coarse_fn(jnet, params)))(
            flags, div)
    with torch.no_grad():
        got = model(flags_c, rhs_c)
        got_p = k_mg.solve_mg(T(flags), T(div), n_vcycles=1,
                              coarse_fn=t_mgc.make_coarse_fn(model))
    gaps = [float(np.abs(g.numpy() - w).max() / np.abs(w).max())
            for g, w in ((got, np.asarray(want)), (got_p, np.asarray(want_p)))]
    print(f"obstacles {p_obstacle}: gap to JAX's bfloat16 net, output "
          f"{gaps[0]:.2e}, p {gaps[1]:.2e} of the largest value")
    close(got, want, 3e-2)
    close(got_p, want_p, 8e-3)


def twin_smooth(flags, rhs, p, k, side):
    """The smoothing launch (mg_down without the restriction, halo k) on
    a RHS already projected: the cut level's post-sweeps from e."""
    _, h, w = flags.shape
    g = _level_tiles(flags, side, k)
    t = _tiles(p, g["ys"], g["in_y"], g["xs"], g["in_x"], 0.0)
    rhs_t = _projected(rhs, g, torch.zeros(rhs.shape[0]))
    return _inner(_sweeps(t, rhs_t, g, k, 2.0 / 3.0), k, h, w)


def twin_split(flags, div, coarse_fn, cut, n_vcycles, p0, side, pre=4,
               post=4):
    """Kernel G's learned V-cycles as fn_mg_learned_down and _up issue
    them: per V-cycle the down launches of levels 0 .. cut-1, the cut
    level's flags and projected RHS, coarse_fn, the cut level's
    post-sweeps from its correction on that RHS, the up launches; the
    gauge after the last."""
    lvls = t_mg._levels(flags, 8)
    p = p0
    for _ in range(n_vcycles):
        rhs, q, above = div, p, []
        for j in range(cut):
            mean = plain_mean(lvls[j], rhs)
            q, rhs_c = twin_down(lvls[j], rhs, mean, pre, side, p=q)
            above.append((rhs, mean, q))
            rhs, q = rhs_c, None
        rhs_cut = t_mg._remove_incompatible(lvls[cut], rhs)
        q = twin_smooth(lvls[cut], rhs_cut,
                        coarse_fn(lvls[cut], rhs_cut), post, side)
        for j in range(cut - 1, -1, -1):
            rhs_j, mean_j, p_j = above[j]
            q = twin_up(lvls[j], lvls[j + 1], rhs_j, mean_j, q, p_j, post,
                        side)
        p = q
    return t_mg._gauge(flags, p)


@pytest.mark.parametrize("side", [32, 64])
@pytest.mark.parametrize("start", ["1 cold", "2 warm"])
@pytest.mark.parametrize("h,w", [(256, 256), (256, 64)])
def test_split_twin_equals_plain(rng, h, w, start, side):
    """The split at 256^2 (the cut at 128^2, above the tail's 64^2) and at
    256x64 (the cut at 128x32, the tail's first level), 8% obstacles,
    cold and warm, equal to the plain solve_mg(coarse_fn=...)."""
    flags = torch.from_numpy(random_flags(rng, 1, h, w, p_obstacle=0.08))
    div = torch.from_numpy(rng.standard_normal((1, h, w)).astype(np.float32))
    n, p0 = (1, None) if start == "1 cold" else (2, torch.from_numpy(
        rng.standard_normal((1, h, w)).astype(np.float32)))
    net, _, _ = nets()
    coarse_fn = t_mgc.make_coarse_fn(net)
    cut = k_mg.plan_learned_cut(h, w)
    assert cut == 1 and k_mg.tail_first_level(t_mg.level_shapes(h, w)) == (
        2 if h == w else 1)
    got = twin_split(flags, div, coarse_fn, cut, n, p0, side)
    want = t_mg.solve_mg(flags, div, n_vcycles=n, p0=p0, coarse_fn=coarse_fn)
    assert torch.equal(got, want)


def test_planner_follows_the_cut_rule_of_the_source():
    """plan_learned_cut's tail rule is fn_mg_cut_level's (csrc/mg.cu:
    tail_args' layout, kTailBudget): the levels the source's comment names
    at 512^2 and 512x128; a cut inside the tail raises, one above it or at
    its first level is taken, none without a level of side <=
    coarse_size."""
    src = (CSRC / "mg.cu").read_text()
    budget = re.search(r"constexpr int kTailBudget = (\d+) \* 1024;", src)
    assert int(budget.group(1)) * 1024 == k_mg.TAIL_BUDGET
    for line in ("A.r[j] = f + n;", "f += 2 * n;",
                 "f += L.h[first] * L.w[first];", "int byte = 4 * f;",
                 "byte += (L.h[j] * L.w[j] + 3) & ~3;",
                 "A.bytes = (byte + 15) & ~15;",
                 "if (tail_args(L, j).bytes <= kTailBudget) return j;",
                 "bool learned_ok(int cut) const { return cut >= 1 && "
                 "cut <= cut_ &&"):
        assert line in src, line
    assert k_mg.tail_first_level(t_mg.level_shapes(512, 512)) == 3
    assert k_mg.tail_first_level(t_mg.level_shapes(512, 128)) == 2
    assert k_mg.plan_learned_cut(512, 512) == 2
    assert k_mg.plan_learned_cut(512, 128) == 2
    assert k_mg.plan_learned_cut(128, 128) is None
    for h, w, size in ((64, 64, 32), (512, 512, 32)):
        with pytest.raises(ValueError, match="inside the single-block tail"):
            k_mg.plan_learned_cut(h, w, coarse_size=size)
