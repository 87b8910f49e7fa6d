"""The port's training modules against the JAX package on the CPU, from the
same numpy inputs (and, for the synthetic data, from the numbers JAX
draws): the loss terms, the step's ``dyn`` and ``output_div``, the unfused
convnet step's walls, the synthetic fields and the label tail, the
rollout-frame collector, Adam with reduce-on-plateau against optax, the
``.npz`` and ``.bin`` files across the two packages, the checkpoint
resume, ``TrainConfig`` against ``configs/train.yaml``, a short
on-device run whose loss falls, and PUNet with polish training on the CPU
while the card refuses it.

Tolerances: the losses 1e-6 of each term; steps and the collector 1e-5 of
each field's largest value (sums in another order); the noise 1e-5 (two
FFT libraries); discs exact; bumps and the label tail 1e-6 and 1e-5; the
optimiser 1e-6 (optax's and torch's Adam round in another order); files
and the resume exact. The JAX steps run ``max_disp`` 1-2 (cheap
compiles).
"""
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from optax.contrib import reduce_on_plateau

from conftest import random_flags
from fluidnet_cxx_tpu import ops as j_ops
from fluidnet_cxx_tpu.config import SimConfig as JSimConfig
from fluidnet_cxx_tpu.config import TrainConfig as JTrainConfig
from fluidnet_cxx_tpu.config import (sim_config_from_mconf,
                                     train_config_from_yaml)
from fluidnet_cxx_tpu.data import dataset as j_dataset
from fluidnet_cxx_tpu.data import manta_io as j_manta
from fluidnet_cxx_tpu.data import synthetic as j_syn
from fluidnet_cxx_tpu.sim import create_plume_scene as j_plume
from fluidnet_cxx_tpu.sim import plume_config as j_plume_config
from fluidnet_cxx_tpu.sim.step import DynParams as JDyn
from fluidnet_cxx_tpu.sim.step import simulate_step as j_step
from fluidnet_cxx_tpu.train import losses as j_losses
from fluidnet_cxx_tpu.train.trainer import collect_rollout_frames as j_collect
from fluidnet_cxx_tpu_torch.config import ModelConfig, SimConfig, TrainConfig
from fluidnet_cxx_tpu_torch.data import dataset, manta_io, synthetic
from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet
from fluidnet_cxx_tpu_torch.ops.stencils import velocity_divergence
from fluidnet_cxx_tpu_torch.sim.scenes import create_plume_scene, plume_config
from fluidnet_cxx_tpu_torch.sim.step import DynParams, simulate_step
from fluidnet_cxx_tpu_torch.state import SimState
from fluidnet_cxx_tpu_torch.train import losses
from fluidnet_cxx_tpu_torch.train.checkpoint import (load_train_checkpoint,
                                                     save_train_checkpoint)
from fluidnet_cxx_tpu_torch.train.trainer import (
    Batch, Optimizer, Plateau, _sample_dyn, check_trainable,
    collect_rollout_frames, init_train_state, make_on_device_train_step,
    make_train_step)
from fluidnet_cxx_tpu_torch.utils.diagnostics import LossLogger

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """The JAX reference is compile-bound here; XLA's optimisation passes
    change no result beyond rounding, so this module runs without them
    (as tests/test_torch_nets2d.py) and restores the setting after."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def test_train_config_holds_train_yaml():
    """TrainConfig() and SimConfig() are configs/train.yaml's values, as
    the JAX package reads them."""
    with open(ROOT / "configs" / "train.yaml") as f:
        conf = yaml.safe_load(f)
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        train_config_from_yaml(conf))
    jsc = dataclasses.asdict(sim_config_from_mconf(conf["modelParam"]))
    assert dataclasses.asdict(SimConfig()) == jsc
    assert conf["modelParam"]["model"] == ModelConfig().model


@pytest.mark.parametrize("masked", [False, True])
def test_loss_terms_match_jax(rng, masked):
    tc = TrainConfig(p_l2_lambda=0.3, p_l1_lambda=0.2, div_l1_lambda=0.5,
                     div_lt_lambda=0.7)
    jtc = JTrainConfig(**dataclasses.asdict(tc))
    flags = random_flags(rng, 2, 24, 20)
    U = rng.standard_normal((2, 2, 24, 20)).astype(np.float32)
    p, pt = rng.standard_normal((2, 2, 24, 20)).astype(np.float32)
    mask = (rng.random((2, 24, 20)) > 0.3).astype(np.float32) if masked \
        else None
    tmask = None if mask is None else T(mask)
    got = losses.short_term_losses(tc, T(p), T(U), T(flags), T(pt), tmask)
    want = j_losses.short_term_losses(jtc, p, U, flags, pt, mask=mask)
    got += (losses.long_term_loss(tc, T(U), T(flags), tmask),)
    want += (j_losses.long_term_loss(jtc, U, flags, mask=mask),)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


def _plume_states(rng, res=32):
    """(JAX state, port state): the plume scene with a random velocity and
    density and 8% random obstacles."""
    js = j_plume(res, res, density_val=0.5, u_scale=0.8, rad=0.2)
    flags = random_flags(rng, 1, res, res, p_obstacle=0.08)
    U = (0.6 * rng.standard_normal((1, 2, res, res))).astype(np.float32)
    rho = rng.random((1, res, res)).astype(np.float32)
    js = js._replace(flags=jnp.asarray(flags), U=jnp.asarray(U),
                     density=jnp.asarray(rho))
    ts = SimState(**{k: None if v is None else T(np.asarray(v))
                     for k, v in js._asdict().items()})
    return js, ts


# (sim_method, advect_density, viscosity, output_div)
DYN_CASES = [("jacobi", True, 0.0, False), ("jacobi", True, 0.05, True),
             ("convnet", False, 0.0, True)]


@pytest.mark.parametrize("method,adv_rho,nu,out_div", DYN_CASES,
                         ids=["jacobi", "viscous-output_div",
                              "rollout-output_div"])
def test_step_with_dyn_matches_jax(rng, method, adv_rho, nu, out_div):
    """``dyn``'s dt in every term (A or E, viscosity, sources), buoyancy
    and gravity from ``dyn`` whatever their scale, ``output_div`` before
    the projection; JAX's XLA branch, which ``dyn`` selects."""
    kw = dict(dt=0.1, jacobi_iter=10, max_disp=2, line_trace=False,
              sim_method=method, advect_density=adv_rho, viscosity=nu,
              buoyancy_scale=0.0)
    jdyn = JDyn(jnp.float32(0.173), jnp.float32(1.3), jnp.float32(0.4),
                jnp.array([0.0, -1.0, 0.0], jnp.float32))
    dyn = DynParams(float(jdyn.dt), float(jdyn.buoyancy_scale),
                    float(jdyn.gravity_scale), (0.0, -1.0, 0.0))
    js, ts = _plume_states(rng)
    want = jax.jit(j_step, static_argnums=(0, 3))(JSimConfig(**kw), js, None,
                                                  out_div, jdyn)
    with torch.no_grad():
        got = simulate_step(SimConfig(**kw), ts, output_div=out_div, dyn=dyn)
    for field in ("U", "density", "p"):
        _close(getattr(got, field), getattr(want, field), 1e-5)


def test_unfused_convnet_step_skips_free_slip_walls(rng):
    """The convnet step's unfused branch applies no free-slip walls around
    the projection (the JAX step skips them there: the learned projection
    applies its own); stick walls and const BCs only. With an identity
    projection the step's output is the advected, sourced velocity."""
    js, ts = _plume_states(rng)
    kw = dict(jacobi_iter=10, max_disp=2, line_trace=False,
              sim_method="convnet")
    want = jax.jit(lambda s: j_step(JSimConfig(**kw), s,
                                    project_fn=lambda p, U, f, r: (p, U)))(js)
    with torch.no_grad():
        got = simulate_step(SimConfig(**kw), ts, lambda p, U, f, r: (p, U))
    for field in ("U", "density"):
        _close(getattr(got, field), getattr(want, field), 1e-5)


def test_sample_dyn_draws_like_jax():
    """The host draw's distribution: n_steps, dt range, buoyancy on about
    train_buoyancy_prob of the draws, no gravity, a cardinal unit vector."""
    tc, sc = TrainConfig(), SimConfig()
    gen = torch.Generator().manual_seed(0)
    draws = [_sample_dyn(gen, sc, tc) for _ in range(400)]
    assert {n for _, n in draws} == {4, 16}
    assert 0.8 < np.mean([n == 4 for _, n in draws]) < 0.97
    dts = np.array([d.dt for d, _ in draws])
    assert dts.min() >= np.float32(0.1) * np.float32(0.2028)
    assert abs(dts.mean() - 0.1) < 0.01
    on = np.mean([d.buoyancy_scale != 0 for d, _ in draws])
    assert 0.2 < on < 0.4
    assert all(d.gravity_scale == 0 for d, _ in draws)
    assert all(sorted(map(abs, d.gravity_vec)) == [0, 0, 1] for d, _ in draws)
    for d, _ in draws:   # float32 values
        assert np.float32(d.dt) == d.dt


def test_synthetic_fields_match_jax():
    """band_limited, disc_flags and gaussian_bumps on the numbers JAX's
    _smooth_noise, _random_obstacles and _gaussian_bumps draw."""
    b, h, w = 2, 32, 24
    key = jax.random.PRNGKey(7)
    kr, ki = jax.random.split(key)
    re, im = (np.asarray(jax.random.normal(k, (b, h, w))) for k in (kr, ki))
    _close(synthetic.band_limited(T(re), T(im)),
           j_syn._smooth_noise(key, b, h, w), 1e-5)
    ks = jax.random.split(key, 4)
    n = jax.random.randint(ks[0], (b,), 0, 4)
    lo, hi = 0.03 * min(h, w), 0.12 * min(h, w)
    cx, cy, r = (jax.random.uniform(k, (b, 3), minval=a, maxval=z)
                 for k, a, z in ((ks[1], 0.2 * w, 0.8 * w),
                                 (ks[2], 0.2 * h, 0.8 * h), (ks[3], lo, hi)))
    got = synthetic.disc_flags(*(T(np.asarray(a)) for a in (n, cx, cy, r)),
                               h, w)
    want = np.asarray(j_syn._random_obstacles(key, b, h, w))
    assert (want == 2).sum() > 2 * (2 * h + 2 * w - 4)   # discs present
    np.testing.assert_array_equal(got.numpy(), want)
    shape = (b, 3, 1, 1)
    args = [jax.random.uniform(k, shape, minval=a, maxval=z)
            for k, a, z in ((ks[0], 0.1 * w, 0.9 * w),
                            (ks[1], 0.1 * h, 0.9 * h),
                            (ks[2], 0.02 * w, 0.12 * w), (ks[3], -1.0, 1.0))]
    _close(synthetic.gaussian_bumps(*(T(np.asarray(a)) for a in args), h, w),
           j_syn._gaussian_bumps(key, b, h, w), 1e-6)


def test_label_tail_matches_jax_and_targets_are_projected(rng):
    """label_batch against JAX's generate_batch tail on the same divergent
    field; then the JAX test's check on a port batch: the inputs are
    divergent, the targets projected."""
    flags = random_flags(rng, 2, 32, 32, p_obstacle=0.05)
    U = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    rho = rng.random((2, 32, 32)).astype(np.float32)
    got = synthetic.label_batch(T(U), T(flags), T(rho), 60)
    Uw = j_ops.set_wall_bcs(U, flags)
    p = j_ops.solve_jacobi_fixed(flags, j_ops.velocity_divergence(Uw, flags),
                                 60)
    want = dict(U_div=Uw, p_target=p, U_target=j_ops.set_wall_bcs(
        j_ops.velocity_update(p, Uw, flags), flags))
    for k, v in want.items():
        _close(getattr(got, k), v, 1e-5)
    b = synthetic.generate_batch(torch.Generator().manual_seed(1), 2, 32, 32,
                                 jacobi_iters=800, device="cpu")
    div_in = float(velocity_divergence(b.U_div, b.flags).abs().max())
    div_out = float(velocity_divergence(b.U_target, b.flags).abs().max())
    assert div_in > 1e-2
    assert div_out < div_in * 0.2
    assert bool((b.flags == 2).sum() > (2 * 32 + 2 * 30) * 2)


def test_collect_rollout_frames_matches_jax():
    """The plume frames (pre-projection, convnet-input distribution) and
    their Jacobi pressures against JAX's collector; each stored p is the
    solver's output for its stored U."""
    cfg = dict(jacobi_iter=20, line_trace=False, max_disp=1)
    js = j_plume(32, 32, u_scale=1.0, rad=0.2)
    frames, p_frames, flags = j_collect(j_plume_config(**cfg), js, 3,
                                       stride=2, warmup=4)
    ts = create_plume_scene(32, 32, u_scale=1.0, rad=0.2)
    got, got_p, got_flags = collect_rollout_frames(
        plume_config(use_pallas=True, **cfg), ts, 3, stride=2, warmup=4)
    assert got.shape == (3, 2, 32, 32) and got_p.shape == (3, 32, 32)
    _close(got, frames, 1e-5)
    _close(got_p, p_frames, 1e-5)
    assert torch.equal(got_flags, T(np.asarray(flags)))
    assert float(velocity_divergence(got[:1], got_flags).abs().max()) > 1e-3


def test_adam_and_plateau_match_optax():
    """Three updates of Adam + reduce_on_plateau with scripted gradients
    and losses (1, 2, 3 at patience 1: the scale halves on the second
    update and again on the third); the plateau's scale applies to the
    update of the step whose loss triggers it. At lr 1e-3: optax's float32
    bias correction, 1 - float32(0.999)^t, sits 1.3e-5 from torch's at
    t = 1 (6.4e-6 of an update, 6e-9 here)."""
    tc = TrainConfig(lr=1e-3, plateau_factor=0.5, plateau_patience=1,
                     plateau_threshold=1e-4)
    rng = np.random.default_rng(3)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    grads = [[rng.standard_normal(a.shape).astype(np.float32) for a in p0]
             for _ in range(3)]
    opt = optax.chain(optax.adam(tc.lr), reduce_on_plateau(
        factor=0.5, patience=1, rtol=1e-4, atol=0.0, accumulation_size=1))
    jp = [jnp.asarray(a) for a in p0]
    state = opt.init(jp)
    params = [torch.nn.Parameter(T(a)) for a in p0]
    topt = Optimizer(params, tc)
    scales = []

    @jax.jit
    def update(g, state, jp, value):
        upd, state = opt.update(g, state, jp, value=value)
        return optax.apply_updates(jp, upd), state

    for g, value in zip(grads, (1.0, 2.0, 3.0)):
        jp, state = update([jnp.asarray(a) for a in g], state, jp,
                           jnp.float32(value))
        for p, a in zip(params, g):
            p.grad = T(a)
        topt.step(torch.tensor(value))
        scales.append(topt.plateau.scale)
        for p, a in zip(params, jp):
            _close(p, a, 1e-6)
    assert scales == [1.0, 0.5, 0.25]
    assert float(state[1].scale) == 0.25


def test_plateau_scale_follows_optax_over_a_loss_sequence():
    """accumulation_size 3, patience 2: the scale after every value."""
    rng = np.random.default_rng(5)
    values = np.concatenate([np.linspace(5, 1, 12), 1 + rng.random(24),
                             np.linspace(1, 0.2, 9), 0.3 + rng.random(15)])
    tr = reduce_on_plateau(factor=0.6, patience=2, rtol=3e-4, atol=0.0,
                           accumulation_size=3)
    state = tr.init(jnp.zeros(1))
    update = jax.jit(lambda st, v: tr.update(jnp.zeros(1), st, value=v)[1])
    plateau = Plateau(0.6, 2, 3e-4, accumulation_size=3)
    want, got = [], []
    for v in values.astype(np.float32):
        state = update(state, jnp.float32(v))
        want.append(float(state.scale))
        got.append(plateau.update(torch.tensor(v)))
    assert got == want
    assert min(got) < 0.6 ** 2


def test_files_cross_between_the_packages(tmp_path, rng):
    """.npz scenes and Manta .bin files (2-D and 3-D) written by one
    package read by the other, exactly; the port's Manta preprocessing
    read by the JAX dataset."""
    synthetic.write_synthetic_dataset(str(tmp_path / "port" / "tr"), 2,
                                      steps_per_scene=2, h=16, w=16,
                                      jacobi_iters=10, device="cpu")
    j_syn.write_synthetic_dataset(str(tmp_path / "jax" / "tr"), 1,
                                  steps_per_scene=2, h=16, w=16,
                                  jacobi_iters=10)
    for root in ("port", "jax"):
        a = dataset.FluidDataset(str(tmp_path / root), "tr")
        b = j_dataset.FluidDataset(str(tmp_path / root), "tr")
        assert len(a) == len(b) and (a.h, a.w) == (b.h, b.w) == (16, 16)
        for x, y in zip(a.batches(2, seed=3), b.batches(2, seed=3)):
            for f in dataset.Sample._fields:
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    p = rng.standard_normal((12, 16)).astype(np.float32)
    U = rng.standard_normal((2, 12, 16)).astype(np.float32)
    flags = rng.integers(1, 3, (12, 16)).astype(np.int32)
    rho = rng.random((12, 16)).astype(np.float32)
    raw = tmp_path / "manta" / "ds" / "tr" / "000000"
    raw.mkdir(parents=True)
    manta_io.save_manta_file(str(raw / "000000.bin"), p, U, flags, rho)
    j_manta.save_manta_file(str(raw / "000000_divergent.bin"), p * 2, U * 2,
                            flags, rho)
    for path, scale in (("000000.bin", 1), ("000000_divergent.bin", 2)):
        ours = manta_io.load_manta_file(str(raw / path))
        theirs = j_manta.load_manta_file(str(raw / path), use_native=False)
        for x, y, z in zip(ours[:4], theirs[:4], (p * scale, U * scale,
                                                  flags, rho)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    p3 = rng.standard_normal((3, 4, 5)).astype(np.float32)
    U3 = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    f3 = np.ones((3, 4, 5), np.int32)
    manta_io.save_manta_file3d(str(tmp_path / "a3.bin"), p3, U3, f3, p3)
    theirs = j_manta.load_manta_file(str(tmp_path / "a3.bin"),
                                     use_native=False)
    assert theirs[4]
    for x, y in zip(theirs[:4], (p3, U3, f3, p3)):
        np.testing.assert_array_equal(x, y)
    dataset.preprocess_manta_scenes(str(tmp_path / "manta"), "ds", "tr",
                                    str(tmp_path / "npz"), save_dt=4,
                                    steps_per_scene=1, n_workers=1)
    s = j_dataset.FluidDataset(str(tmp_path / "npz"), "tr")[0]
    np.testing.assert_array_equal(s.p_div, p * 2)
    np.testing.assert_array_equal(s.U_target, U)
    log = LossLogger(str(tmp_path / "loss.npy"))
    log.append(3, losses.LossTerms(*map(torch.tensor, range(6))))
    log.save()
    np.testing.assert_array_equal(np.load(tmp_path / "loss.npy"),
                                  [[3, 0, 1, 2, 3, 4, 5]])


def _tiny_run(ts, step, batch, draws):
    for d in draws:
        ts, _ = step(ts, batch, draw=d)
    return ts


def test_checkpoint_resume_equals_an_unbroken_run(tmp_path, rng):
    """Four steps straight, and two steps, a checkpoint, a fresh state
    restored from it and two more: the same parameters, Adam state and
    plateau state bit for bit; model_config.json in the JAX layout."""
    tc = TrainConfig(lt_num_steps=(1, 2), lr=1e-3)
    sc = SimConfig(max_disp=2)
    flags = random_flags(rng, 2, 16, 16, p_obstacle=0.05)
    U = (0.5 * rng.standard_normal((2, 2, 16, 16))).astype(np.float32)
    zero = torch.zeros((2, 16, 16))
    batch = Batch(zero, T(U), T(flags), zero, zero, T(U), zero)
    gen = torch.Generator().manual_seed(0)
    draws = [_sample_dyn(gen, sc, tc) for _ in range(4)]

    def fresh():
        model = FluidNet(ModelConfig())
        ts = init_train_state(model, tc, seed=2, steps_per_epoch=3)
        return ts, make_train_step(model, sc, tc)[0]

    ts_a, step_a = fresh()
    ts_a = _tiny_run(ts_a, step_a, batch, draws)
    ts_b, step_b = fresh()
    ts_b = _tiny_run(ts_b, step_b, batch, draws[:2])
    save_train_checkpoint(str(tmp_path), ts_b, 1, 0.5, ModelConfig(),
                          is_best=True)
    ts_c, step_c = fresh()
    ts_c, epoch, best = load_train_checkpoint(str(tmp_path), ts_c)
    assert (epoch, best, ts_c.step) == (1, 0.5, 2)
    ts_c = _tiny_run(ts_c, step_c, batch, draws[2:])
    assert ts_c.step == ts_a.step == 4
    for a, c in zip(ts_a.model.parameters(), ts_c.model.parameters()):
        assert torch.equal(a, c)
    sa, sc_ = (t.optimizer.adam.state_dict()["state"] for t in (ts_a, ts_c))
    for k in sa:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k][name], sc_[k][name])
    assert ts_a.optimizer.plateau.state_dict().keys() == \
        ts_c.optimizer.plateau.state_dict().keys()
    assert torch.equal(ts_a.optimizer.plateau.avg_value,
                       ts_c.optimizer.plateau.avg_value)
    from fluidnet_cxx_tpu.train.checkpoint import load_model_config
    assert dataclasses.asdict(load_model_config(str(tmp_path))) == \
        dataclasses.asdict(ModelConfig())
    assert os.path.isfile(tmp_path / "best" / "train_state.pt")


def test_on_device_train_step_reduces_loss():
    """tests/test_train.py's on-device run: 24^2, batch 4, 10 steps of
    fresh synthetic batches (60-sweep labels), no LT, lr 2e-3: the last
    three losses' mean below the first three's."""
    model = FluidNet(ModelConfig())
    tc = TrainConfig(batch_size=4, div_lt_lambda=0.0, lr=2e-3)
    ts = init_train_state(model, tc)
    step = make_on_device_train_step(model, SimConfig(), tc, 24, 24, 4, 60,
                                     device="cpu")
    gen = torch.Generator().manual_seed(0)
    host_gen = torch.Generator().manual_seed(1)
    totals = []
    for _ in range(10):
        ts, terms = step(ts, gen, host_gen)
        totals.append(float(terms.total))
    assert np.isfinite(totals).all()
    assert np.mean(totals[-3:]) < np.mean(totals[:3]), totals
    assert ts.step == 10


def test_punet_and_polish_train_on_the_cpu_and_raise_for_the_card():
    """PUNet and the damped "xla" polish have a backward on the card
    (stride-2 and skip-split input gradients, the polish's transposed
    sweeps): check_trainable passes them there, as it does the tower and
    ScaleNet, and refuses only the "fused" and "mg" polish tails (JAX does
    not differentiate them either); on the CPU the plain versions train
    them: one step of a small PUNet with 4 damped polish sweeps, finite
    terms and a gradient on every parameter."""
    punet = ModelConfig(model="PUNet", punet_patch=4, punet_widths=(32, 32),
                        polish_sweeps=4)
    for mcfg in (punet, ModelConfig(polish_sweeps=3)):
        check_trainable(mcfg, "cuda")
        check_trainable(mcfg, "cpu")
    with pytest.raises(NotImplementedError, match="polish tail"):
        check_trainable(ModelConfig(polish_sweeps=3, polish_impl="fused"),
                        "cuda")
    for model in ("FluidNet", "ScaleNet"):
        check_trainable(ModelConfig(model=model), "cuda")
    model = FluidNet(punet)
    tc = TrainConfig(batch_size=2, lt_num_steps=(1, 2))
    ts = init_train_state(model, tc)
    step = make_on_device_train_step(model, SimConfig(max_disp=2), tc, 32, 32,
                                     2, 20, device="cpu")
    ts, terms = step(ts, torch.Generator().manual_seed(0),
                     torch.Generator().manual_seed(1))
    assert np.isfinite([float(t) for t in terms]).all()
    assert all(float(p.grad.abs().max()) > 0 for p in model.parameters())
