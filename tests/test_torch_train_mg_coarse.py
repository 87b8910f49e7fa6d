"""The coarse net's training (``scripts/train_mg_coarse.py``'s twin and
``models/mg_coarse.py``'s training functions) against the JAX package on
the CPU, on the same numpy inputs.

* One plume frame's cut problem (``plume_frame``: steps, the step's
  pre-projection conditioning, the V-cycle's leg to the cut) against JAX's
  ``simulate_step(output_div=True)``, ``set_wall_bcs``,
  ``apply_const_vals`` and ``mg_cut_rhs`` at 64^2 (max_disp 1, as the
  other step tests run it): 1e-4 of each field's largest value, as
  tests/test_torch_nets2d.py holds steps.
* The synthetic leg (``synth_frame``) on fields JAX's ``_smooth_noise``,
  ``_gaussian_bumps`` and ``_random_obstacles`` draw, and the labels (8
  V-cycles at the cut): 1e-5 of the largest value.
* One bfloat16 train step of MGCoarseNet (its shipped config) at a 32^2
  cut, batch 4, against ``jax.value_and_grad`` of the JAX script's loss:
  the loss within 1e-5 of its value, each parameter's gradient within 3%
  of its norm (relative L2; bfloat16 roundings that flip, as in 3-D,
  tests/test_torch_train3d.py).
* The cosine schedule against ``optax.cosine_decay_schedule`` within 1e-7,
  and three Adam updates under it against ``optax.adam`` within 1e-6 of
  the parameter's scale.
* The eval's three rows against the JAX script's ``eval_params`` written
  out with JAX's functions: mg1v and mg2v within 1e-4 relative, learned1v
  within 2% (the bfloat16 net's output differs from flax's by its
  roundings, ROADMAP C.7).
* A save -> ``load_mg_coarse`` -> ``make_project_fn_mg_learned`` round
  trip, and the CLI on the CPU (``--res 64 --coarseSize 32``) whose dir
  the ``run_plume`` twin runs under ``--simMethod mg_learned``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu import ops as j_ops
from fluidnet_cxx_tpu.data.synthetic import (_gaussian_bumps,
                                             _random_obstacles,
                                             _smooth_noise)
from fluidnet_cxx_tpu.models import mg_coarse as j_mgc
from fluidnet_cxx_tpu.ops import multigrid as j_mg
from fluidnet_cxx_tpu.ops import stencils as j_st
from fluidnet_cxx_tpu.sim import apply_const_vals as j_const_vals
from fluidnet_cxx_tpu.sim import create_plume_scene as j_plume
from fluidnet_cxx_tpu.sim import plume_config as j_plume_config
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu_torch.models import mg_coarse as t_mgc
from fluidnet_cxx_tpu_torch.models.convert import flax_to_state_dict
from fluidnet_cxx_tpu_torch.ops.kernels.punet import pack_weights
from fluidnet_cxx_tpu_torch.scripts import run_plume as twin_plume
from fluidnet_cxx_tpu_torch.scripts import train_mg_coarse as tmc
from fluidnet_cxx_tpu_torch.sim.scenes import create_plume_scene

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """The JAX reference is compile-bound here; XLA's optimisation passes
    change no result beyond rounding (the bfloat16 layer gradients are the
    same under both settings, tests/test_torch_bf16_grad.py), so this
    module runs without them and restores the setting after."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _flax_params(model):
    """``model``'s (a port MGCoarseNet) parameters as the flax tree."""
    tree = {}
    for key, t in model.punet.state_dict().items():
        _, name, kind = key.split(".")
        tree.setdefault(name, {})["kernel" if kind == "weight" else "bias"] = (
            t.permute(2, 3, 1, 0).numpy() if kind == "weight" else t.numpy())
    return {"params": {"punet": tree}}


def _seeded(seed=3):
    return t_mgc.init_mg_coarse_params(t_mgc.MGCoarseNet(), seed)


def test_plume_frame_cut_matches_jax():
    """One stride step, the pre-projection frame and its cut problem at
    64^2 (cut 32), and the state the collector goes on from."""
    cfg = dataclasses.replace(tmc.frames_config(), max_disp=1)
    jcfg = j_plume_config(sim_method="multigrid", mg_vcycles=2,
                          line_trace=False, use_pallas=False, max_disp=1)
    scene = dict(density_val=0.1, u_scale=8.0 * 64 / 512.0, rad=0.145)
    state = create_plume_scene(64, 64, **scene)
    js = j_plume(64, 64, **scene)
    nxt, fc, rc, U = tmc.plume_frame(cfg, state, 1, 32)

    step = jax.jit(lambda s: j_step(jcfg, s))
    js = step(js)
    d = jax.jit(lambda s: j_step(jcfg, s, output_div=True))(js)
    jU = j_st.set_wall_bcs(d.U, d.flags)
    jU, _ = j_const_vals(d, jU, d.density)
    jfc, jrc = j_mg.mg_cut_rhs(d.flags, j_ops.velocity_divergence(jU,
                                                                  d.flags),
                               coarse_size=32)
    jnext = step(js)
    assert np.array_equal(fc.numpy(), np.asarray(jfc))
    assert tuple(rc.shape) == (1, 32, 32) and float(rc.abs().max()) > 0
    _close(rc, jrc, 1e-4)
    _close(U, jU, 1e-4)
    for field in ("U", "density", "p"):
        _close(getattr(nxt, field), getattr(jnext, field), 1e-4)


def test_synthetic_leg_and_labels_match_jax():
    """synth_frame on JAX's draws (two frames at 64^2, cut 32) and the
    labels, 8 V-cycles at the cut, against JAX's."""
    fcs, rcs, jfcs, jrcs = [], [], [], []
    for seed in (0, 1):
        ks = jax.random.split(jax.random.PRNGKey(seed), 5)
        u = (_smooth_noise(ks[0], 1, 64, 64) * 3.0
             + _gaussian_bumps(ks[1], 1, 64, 64) * 3.0)
        v = (_smooth_noise(ks[2], 1, 64, 64) * 3.0
             + _gaussian_bumps(ks[3], 1, 64, 64) * 3.0)
        flags = _random_obstacles(ks[4], 1, 64, 64)
        fc, rc, fl, U = tmc.synth_frame(T(u), T(v), T(flags), 32)
        jU = j_st.set_wall_bcs(jnp.stack([u, v], axis=1), flags)
        jfc, jrc = j_mg.mg_cut_rhs(flags, j_ops.velocity_divergence(
            jU, flags), coarse_size=32)
        assert np.array_equal(fc.numpy(), np.asarray(jfc))
        assert np.array_equal(fl.numpy(), np.asarray(flags))
        _close(U, jU, 1e-5)
        _close(rc, jrc, 1e-5)
        fcs.append(fc[0])
        rcs.append(rc[0])
        jfcs.append(jfc[0])
        jrcs.append(jrc[0])
    labels = tmc.make_labels(torch.stack(fcs), torch.stack(rcs), 8)
    want = j_mg.solve_mg(jnp.stack(jfcs), jnp.stack(jrcs), n_vcycles=8)
    _close(labels, want, 1e-5)
    u, v, flags = tmc.synth_fields(torch.Generator().manual_seed(0), 64,
                                   "cpu")
    assert u.shape == v.shape == flags.shape == (1, 64, 64)
    assert flags.dtype == torch.int32 and float(u.abs().max()) > 0


def test_bf16_train_step_matches_jax_value_and_grad(rng):
    """MGCoarseNet in bfloat16: the loss and every parameter's gradient at
    a 32^2 cut, batch 4 (module docstring)."""
    model = _seeded()
    flags = random_flags(rng, 4, 32, 32)
    rhs = rng.standard_normal((4, 32, 32)).astype(np.float32)
    e_star = rng.standard_normal((4, 32, 32)).astype(np.float32)
    jmodel = j_mgc.MGCoarseNet(j_mgc.MGCoarseConfig())

    def j_loss(p):
        e = jmodel.apply(p, flags, rhs)
        cont = j_mgc._cont(jnp.asarray(flags))
        num = jnp.sum((e - e_star) ** 2 * cont, axis=(1, 2))
        den = jnp.sum(e_star ** 2 * cont, axis=(1, 2)) + 1e-12
        return jnp.mean(num / den)

    want, jgrads = jax.value_and_grad(j_loss)(_flax_params(model))
    loss = tmc.coarse_loss(model, pack_weights(model.punet), T(flags),
                           T(rhs), T(e_star))
    loss.backward()
    wgrads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jgrads["params"]["punet"]))
    gaps = {n: float((p.grad - wgrads[n]).norm()
                     / wgrads[n].norm().clamp_min(1e-30))
            for n, p in model.punet.named_parameters()}
    print(f"bf16 MGCoarseNet step: loss {float(loss):.7g} vs JAX "
          f"{float(want):.7g}; gradient gaps (relative L2) "
          f"{ {n: round(g, 5) for n, g in gaps.items()} }")
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    assert max(gaps.values()) <= 3e-2


def test_schedule_and_adam_match_optax():
    """cosine_lr against optax's schedule at every update and past the
    end; three Adam updates of the twin's optimizer under it against
    optax.adam's."""
    lr, steps = 2e-3, 40
    sched = optax.cosine_decay_schedule(lr, steps, 0.05)
    for t in list(range(steps + 1)) + [steps + 7]:
        assert abs(tmc.cosine_lr(lr, steps, t) - float(sched(t))) <= 1e-7
    p0 = np.linspace(-1, 1, 12).astype(np.float32)
    grads = [np.cos(np.arange(12) * (i + 1)).astype(np.float32)
             for i in range(3)]
    opt = optax.adam(sched)
    jp, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    param = torch.nn.Parameter(T(p0))
    topt = tmc.make_optimizer([param], lr)
    for t, g in enumerate(grads):
        up, st = opt.update(jnp.asarray(g), st)
        jp = optax.apply_updates(jp, up)
        param.grad = T(g)
        for group in topt.param_groups:
            group["lr"] = tmc.cosine_lr(lr, steps, t)
        topt.step()
    _close(param, jp, 1e-6)


def test_eval_rows_match_jax(rng):
    """eval_params' learned1v, mg1v and mg2v rows on two fine 64^2 frames
    (cut 32) against the JAX script's eval written out with JAX's
    functions (module docstring)."""
    model = _seeded()
    frames = []
    for _ in range(2):
        flags = random_flags(rng, 1, 64, 64, p_obstacle=0.05)
        U = rng.standard_normal((1, 2, 64, 64)).astype(np.float32)
        frames.append((flags, U))
    got = tmc.eval_params(model, [(T(f), T(U)) for f, U in frames], 32)
    jmodel = j_mgc.MGCoarseNet(j_mgc.MGCoarseConfig())
    project = j_mgc.make_project_fn_mg_learned(jmodel, _flax_params(model),
                                               coarse_size=32)
    rows = {"learned1v": [], "mg1v": [], "mg2v": []}
    for flags, U in frames:
        _, U_l = project(None, U, flags, None)
        rows["learned1v"].append(j_ops.velocity_divergence(U_l, flags))
        for name, nv in (("mg1v", 1), ("mg2v", 2)):
            p = j_mg.solve_mg(flags, j_ops.velocity_divergence(U, flags),
                              n_vcycles=nv)
            U_p = j_st.set_wall_bcs(j_st.velocity_update(p, U, flags), flags)
            rows[name].append(j_ops.velocity_divergence(U_p, flags))
    m = np.concatenate([f == 1 for f, _ in frames])
    print(f"eval rows: port {got}")
    for name, divs in rows.items():
        d = np.abs(np.concatenate(divs))
        want = (float(np.where(m, d, 0).max()), float((d * m).sum()
                                                      / m.sum()))
        tol = 2e-2 if name == "learned1v" else 1e-4
        for g, w in zip(got[name], want):
            assert abs(g - w) <= tol * abs(w), (name, g, w)


def test_save_load_round_trip(tmp_path, rng):
    """save_mg_coarse's dir: last/ (and best/) train states, the converted
    parameters and the config; load_mg_coarse returns the same net, whose
    learned projection equals the saved model's bit for bit."""
    model = _seeded()
    opt = tmc.make_optimizer(model.parameters(), 1e-3)
    d = str(tmp_path / "mgc")
    t_mgc.save_mg_coarse(d, model.cfg, model, opt, 5, 0.25, is_best=True)
    t_mgc.save_mg_coarse(d, model.cfg, model, opt, 7, 0.25, is_best=False)
    assert sorted(os.listdir(d)) == ["best", "last", "mg_coarse_config.json",
                                     "torch_state_dict.pt"]
    last = torch.load(os.path.join(d, "last", t_mgc.STATE_FILE),
                      weights_only=True)
    best = torch.load(os.path.join(d, "best", t_mgc.STATE_FILE),
                      weights_only=True)
    assert (last["step"], best["step"], last["best"]) == (7, 5, 0.25)
    loaded = t_mgc.load_mg_coarse(d)
    for (n, a), (m, b) in zip(model.state_dict().items(),
                              loaded.state_dict().items()):
        assert n == m and torch.equal(a, b)
    flags = T(random_flags(rng, 1, 64, 64))
    U = T(rng.standard_normal((1, 2, 64, 64)).astype(np.float32))
    outs = [t_mgc.make_project_fn_mg_learned(mdl, coarse_size=32)(
        None, U, flags, None) for mdl in (model, loaded)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_cli_on_cpu_and_run_plume_from_its_dir(tmp_path, capsys):
    """The twin at --res 64 --coarseSize 32 on the CPU: the JAX script's
    lines, finite losses, an eval every 2 steps, the model dir; the
    run_plume twin runs it under --simMethod mg_learned at 256^2 (its
    128^2 cut)."""
    d = str(tmp_path / "mgc")
    res = tmc.main(["--res", "64", "--coarseSize", "32", "--frames", "6",
                    "--warmup", "2", "--stride", "1", "--steps", "4",
                    "--evalEvery", "2", "--modelDir", d, "--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("buffer: 6 coarse problems", "coarse problems at 32x32",
                 "labels done", "MGCoarseNet params: 324.4k",
                 "step 2: loss", "step 4: loss"):
        assert line in out, line
    assert len(res["losses"]) == 4 and np.isfinite(res["losses"]).all()
    assert [s for s, _ in res["evals"]] == [2, 4]
    assert os.path.isfile(os.path.join(d, "torch_state_dict.pt"))
    run = twin_plume.main(["--simMethod", "mg_learned", "--modelDir", d,
                           "--resX", "256", "--resY", "256", "--maxIter",
                           "1", "--outputFolder", str(tmp_path / "out"),
                           "--device", "cpu"])
    assert run["finite"] and run["sim_method"] == "mg_learned"
