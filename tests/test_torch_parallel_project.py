"""The width-sharded V-cycles (``fluidnet_cxx_tpu_torch/parallel/
multigrid.py``), the learned projections on one receptive-field halo
(``parallel/project.py``) and the gather engine under sx, on four gloo
ranks on the CPU at sx = 4 (one spawn for the module,
``tests/torch_parallel_project_ranks.py::project_ranks``), gathered and
held to the port's single-device step and to the JAX package's:

* kernel H's step on a 32x512 plume with 8% obstacles (two steps: the
  finest level exceeds the tail's budget, so one level runs sharded
  before the gather), kernel G's on a 32x512 Rayleigh-Taylor box made
  periodic in x, mg_learned with a seed-weight MGCoarseNet and
  ``coarse_size`` 256 (its cut at 16x256, the tail's first level);
* a small fused PUNet (patch 2, two levels, dilation 2, 4 polish sweeps)
  with the "fused" tail on a 32x128 plume and with the "mg" polish on the
  32x512 one (and with no polish sweeps, which the fused forward's "mg"
  polish ignores); the flax-path tower and ScaleNet with seed weights;
* the gather engine from a dyadic U (multiples of 1/8, dt 1/4, no line
  trace), bit for bit;
* 3-D: ``solve_mg3`` on a 16x16x32 plume, a small fused PUNet3 (with and
  without the input's normalisation) and the flax-path FluidNet3 on a
  16^3 plume;
* the tail's output on the gathered coarse levels, bit-equal on every
  rank; G's and the learned V-cycle under dp alone (sx = 1); the refusals (a projection without ``sharding``, a slab width
  off the projection's alignment, a slab width that does not split into
  the gather level).

Without a spawn: the plain versions of ``csrc/mg.cu``'s slab entries
(``ops/multigrid.py::slab_*``, ``tail_solve``) equal, on the whole grid,
the per-level functions of ``ops/multigrid.py`` they stand for, and on a
slab of the grid the whole grid's window; ``receptive_halo`` on the
shipped nets; each learned projection's reach held directly (the inputs
beyond its halo perturbed, the owned outputs bit-equal); which polish
the sharded step gives the "mg" projections.

Tolerances. Against the port's single-device step, 1e-5 of each field's
largest value (at least 1): the V-cycle's means and the input scale sum
in another order (the largest gap seen is 3.0e-6 of the largest value,
on kernel H's p). Against JAX, 1e-5 as ``tests/test_parallel.py``; JAX
runs the window engine at max_disp 1 (a cheaper compile), where every
displacement of these scenes' first steps is below one cell (asserted).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_project_ranks as ranks
from fluidnet_cxx_tpu.config import ModelConfig as JModelConfig
from fluidnet_cxx_tpu.models import fluidnet as j_fn
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu.sim.step3d import SimState3 as JState3
from fluidnet_cxx_tpu.sim.step3d import simulate_step3 as j_step3
from fluidnet_cxx_tpu.state import SimState as JState
from fluidnet_cxx_tpu_torch.config import ModelConfig
from fluidnet_cxx_tpu_torch.models.fluidnet import make_net, tower_table
from fluidnet_cxx_tpu_torch.models.multi_scale import multiscale_table
from fluidnet_cxx_tpu_torch.models.punet import layer_table
from fluidnet_cxx_tpu_torch.models.punet3d import layer_table3
from fluidnet_cxx_tpu_torch.ops import multigrid as mgp
from fluidnet_cxx_tpu_torch.parallel.launch import spawn
from fluidnet_cxx_tpu_torch.parallel.project import receptive_halo
from fluidnet_cxx_tpu_torch.sim.step import simulate_step
from fluidnet_cxx_tpu_torch.sim.step3d import simulate_step3

torch.set_num_threads(1)
TOL = 1e-5
CASES = ranks.project_cases()


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding; this
    module runs without them and restores the setting after."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("project")
    spawn(ranks.project_ranks, ranks.WORLD, (str(d),), timeout_s=120,
          join_s=180)
    return [dict(np.load(d / f"project_r{r}.npz"))
            for r in range(ranks.WORLD)]


def _port(name):
    steps, three_d, cfg, state = CASES[name]
    step = simulate_step3 if three_d else simulate_step
    project = ranks.projection(name)
    with torch.no_grad():
        for _ in range(steps):
            state = step(cfg, state, project)
    return state


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_projection_is_the_single_device_step(run, name):
    want = _port(name)
    for out in run:
        for field in ("p", "U", "density"):
            w = getattr(want, field).numpy()
            if name in ranks.EXACT:
                np.testing.assert_array_equal(out[f"{name}_{field}"], w)
            else:
                np.testing.assert_allclose(
                    out[f"{name}_{field}"], w, rtol=0,
                    atol=TOL * max(float(np.abs(w).max()), 1.0))
    assert np.isfinite(want.U.numpy()).all()
    assert float(want.p.abs().max()) > 0


def test_gathered_levels_are_bit_equal_across_ranks(run):
    """Every rank runs the tail on the same gathered coarse grid and gets
    the same bits (the multigrid cases' V-cycles, in order)."""
    assert run[0]["tails"].size > 0
    for out in run[1:]:
        np.testing.assert_array_equal(out["tails"], run[0]["tails"])


def test_sharded_step_refusals(run):
    for out in run:
        assert "sharding_of" in str(out["refuse_attr"])
        assert "`kind`" in str(out["refuse_attr"])
        assert "multiple of 4" in str(out["refuse_align"])
        assert "does not split into level 1" in str(out["refuse_mg"])
        assert int(out["halo_punet"]) % 4 == 0


def test_sharded_v_cycles_under_dp_alone(run):
    """A mesh with sx = 1 (dp = 4) solves each rank's batch entry on one
    device: kernel G's V-cycles and the learned one, bit for bit."""
    from fluidnet_cxx_tpu_torch.ops.multigrid import solve_mg

    flags, div = ranks.dp_mg_inputs()
    for r, out in enumerate(run):
        f, d = flags[r:r + 1], div[r:r + 1]
        np.testing.assert_array_equal(out["dp_mg"], solve_mg(f, d).numpy())
        np.testing.assert_array_equal(
            out["dp_mg_learned"],
            solve_mg(f, d, n_vcycles=1, coarse_fn=ranks.dp_coarse_fn,
                     coarse_size=256).numpy())


def _flax_tree(net):
    """A port net's parameters as the flax tree (HWIO kernels)."""
    tree = {}
    for key, t in net.state_dict().items():
        _, name, kind = key.rsplit(".", 2)
        *outer, last = name.split("/")
        node = tree
        for part in outer:
            node = node.setdefault(part, {})
        node.setdefault(last, {})["kernel" if kind == "weight" else "bias"] = (
            t.permute(2, 3, 1, 0).numpy() if kind == "weight" else t.numpy())
    return tree


def _jax_state(state, three_d):
    cls = JState3 if three_d else JState
    return cls(**{k: None if v is None else jnp.asarray(v.numpy())
                  for k, v in state._asdict().items()})


def _jax_want(name):
    """JAX's steps of the case, jitted (a quicker compile than its eager
    ops here), the window engine at max_disp 1."""
    from fluidnet_cxx_tpu.sim import scenes as j_scenes

    steps, three_d, cfg, state = CASES[name]
    fields = dataclasses.asdict(cfg)
    if cfg.advection_impl == "window":
        assert cfg.dt * float(state.U.abs().max()) < 1.0
        fields["max_disp"] = 1
    jcfg = type(j_scenes.plume_config())(**fields)
    project = None
    if name == "tower":
        net = ranks._seeded(make_net(ModelConfig()))
        model = j_fn.FluidNet(JModelConfig())
        project = j_fn.make_project_fn(
            model, {"params": {"FluidNetTower_0": _flax_tree(net)}})
    js = _jax_state(state, three_d)
    step = j_step3 if three_d else j_step
    jitted = jax.jit(lambda s: step(jcfg, s, project_fn=project))
    for _ in range(steps):
        js = jitted(js)
    return js


@pytest.mark.parametrize("name", ["mg_H", "mg_G", "gather", "tower", "mg3"])
def test_sharded_step_matches_jax(run, name):
    want = _jax_want(name)
    for out in run:
        for field in ("p", "U", "density"):
            w = np.asarray(getattr(want, field))
            np.testing.assert_allclose(
                out[f"{name}_{field}"], w, rtol=0,
                atol=TOL * max(float(np.abs(w).max()), 1.0))


def _slab_inputs(seed=0, h=16, w=64):
    g = torch.Generator().manual_seed(seed)
    flags = torch.ones((1, h, w), dtype=torch.int32)
    flags[:, [0, -1], :] = 2
    flags[:, :, [0, -1]] = 2
    inner = flags[:, 1:-1, 1:-1]
    inner[torch.rand(inner.shape, generator=g) < 0.1] = 2
    flags[:, 3:7, 2:4] = 2
    rhs = torch.randn((1, h, w), generator=g)
    p = torch.randn((1, h, w), generator=g)
    e = torch.randn((1, h // 2, w // 2), generator=g)
    return flags, rhs, p, e


def _whole(entry):
    """(plain slab entry on the whole grid, the per-level function)."""
    flags, rhs, p, e = _slab_inputs()
    w = flags.shape[-1]
    sums = mgp.slab_sums(rhs, flags, 0, w, 0, w)
    proj = mgp._remove_incompatible(flags, rhs)
    cf = mgp._coarsen_flags(flags)
    if entry == "coarsen":
        return mgp.slab_coarsen(flags, 0, w), cf
    if entry == "sums":
        m = mgp._cont_mask(flags)
        return sums, torch.stack([torch.sum(rhs * m, dim=(1, 2)),
                                  torch.sum(m, dim=(1, 2))], dim=1)
    if entry == "down":
        got = mgp.slab_down(flags, 0, w, p, rhs, sums, 3, 0, w, True)
        q = mgp.solve_jacobi_fixed(flags, proj, 3, p0=p, damping=2.0 / 3.0)
        return torch.cat([got[0].flatten(), got[1].flatten()]), torch.cat(
            [q.flatten(), mgp._restrict_sum(mgp.residual(flags, proj, q))
             .flatten()])
    if entry == "up":
        got = mgp.slab_up(flags, 0, w, cf, 0, p, rhs, sums, e, 5, 0, w)
        q = p + mgp.where0(mgp._cont(flags),
                           mgp._prolong(mgp._neumann_extend(cf, e)))
        return got, mgp.solve_jacobi_fixed(flags, proj, 5, p0=q,
                                           damping=2.0 / 3.0)
    if entry == "epilogue":
        got = mgp.slab_epilogue(flags, 0, w, p, mgp.slab_sums(
            p, flags, 0, w, 0, w), 0, w)[0]
        return got, mgp._gauge(flags, p)
    got = mgp.tail_solve(flags, rhs, min_size=4)
    want = mgp._vcycle(mgp._levels(flags, 4), rhs, torch.zeros_like(rhs), 0,
                       4, 4, 32, 2.0 / 3.0)
    return got, want


ENTRIES = ["coarsen", "sums", "down", "up", "epilogue", "tail"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_slab_plain_versions_are_the_per_level_functions(entry):
    got, want = _whole(entry)
    assert torch.equal(got, want)


@pytest.mark.parametrize("entry", ["down", "up", "epilogue"])
def test_slab_plain_versions_on_a_slab_are_the_whole_grids_window(entry):
    """A periodic slab (columns 20 .. 19 + 28 of 64, a halo of 16 on each
    side, the left one past the domain's edge) gives the whole grid's
    window to the bit."""
    flags, rhs, p, e = _slab_inputs()
    w = flags.shape[-1]
    x0, lo, hi = -12, 16, 16 + 28
    cols = torch.remainder(torch.arange(x0, x0 + 60), w)
    sl = lambda t: t.index_select(-1, cols)  # noqa: E731
    sums = mgp.slab_sums(rhs, flags, 0, w, 0, w)
    if entry == "down":
        got = mgp.slab_down(sl(flags), x0, w, sl(p), sl(rhs), sums, 8, lo,
                            hi, True)
        want = mgp.slab_down(flags, 0, w, p, rhs, sums, 8, 0, w, True)
        assert torch.equal(got[0], want[0][..., x0 + lo:x0 + hi])
        assert torch.equal(got[1], want[1][..., (x0 + lo) // 2:
                                           (x0 + hi) // 2])
        return
    if entry == "up":
        cf = mgp._coarsen_flags(flags)
        ccols = torch.remainder(torch.arange(x0 // 2 - 4, x0 // 2 + 34),
                                w // 2)
        got = mgp.slab_up(sl(flags), x0, w, cf.index_select(-1, ccols),
                          x0 // 2 - 4, sl(p), sl(rhs), sums,
                          e.index_select(-1, ccols), 8, lo, hi)
        want = mgp.slab_up(flags, 0, w, cf, 0, p, rhs, sums, e, 8, 0, w)
        assert torch.equal(got, want[..., x0 + lo:x0 + hi])
        return
    got = mgp.slab_epilogue(sl(flags), x0, w, sl(p), sums, lo, hi)[0]
    want = mgp.slab_epilogue(flags, 0, w, p, sums, 0, w)[0]
    assert torch.equal(got, want[..., x0 + lo:x0 + hi])


@pytest.mark.parametrize("name", ranks.REACH)
def test_owned_columns_see_nothing_beyond_the_halo(name):
    """The reach held directly: perturbing every input column beyond the
    projection's halo leaves the owned outputs bit-equal; with a halo two
    alignments narrower they move (the check sees a short halo)."""
    assert ranks.reach_moved(name) == 0.0
    assert ranks.reach_moved(name, short=2) > 0.0


def test_halo_of_the_mg_polish_follows_what_the_projection_runs():
    """The fused forward runs kernel H under polish_impl "mg" with any
    sweep count, so both shard it with the sharded "mg" polish; the flax
    path runs H only with sweeps."""
    from fluidnet_cxx_tpu_torch.models import fluidnet as fn
    from fluidnet_cxx_tpu_torch.parallel.project import sharding_of

    assert sharding_of(ranks.projection("punet_mg0")).polish == "mg"
    assert sharding_of(ranks.projection("punet_mg")).polish == "mg"
    cfg = ModelConfig(**dict(ranks.PUNET, polish_sweeps=0), polish_impl="mg")
    flax = fn.make_project_fn(cfg, ranks._seeded(fn.make_net(cfg)))
    assert sharding_of(flax).polish == "own"


def test_receptive_halo_of_the_shipped_nets(capsys):
    """The reach and alignment of the nets the chip's cases run:
    PUNetD2_128 (patch 8, widths 96/128/128, three dilation-2 convs at
    the 32-cell level), FluidNetTower, ScaleNet, PUNet3p8_64."""
    punet, a = receptive_halo(layer_table(2, 8, (96, 128, 128), 1, 3, 2), 8)
    assert a == 32 and 290 <= punet <= 340
    assert receptive_halo(tower_table(2)) == (12, 4)
    scale, a = receptive_halo(multiscale_table(2))
    assert a == 4 and 30 <= scale <= 60
    p3, a = receptive_halo(layer_table3(2, 8, (96, 128), 1, 2), 8)
    assert a == 16 and p3 > 0
    with capsys.disabled():
        print(f"\nreach: PUNetD2_128 {punet}, tower 12, ScaleNet {scale}, "
              f"PUNet3p8_64 {p3}")
