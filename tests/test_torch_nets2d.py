"""The reference's own 2-D networks and the flax-path projection, port
against the JAX package on the CPU from the same numpy inputs.

FluidNetTower (``DataTrain_128``) and MultiScaleNet (the ``ScaleNet_*``
checkpoints) against flax on seed and trained weights; ``resize`` against
``jax.image.resize``; the padded chain (``ops/kernels/punet.py::
net_forward`` on a CPU tensor: kernel B's thin-channel route, every layer
on zero-padded weights and 32-channel activations, through
``conv2d_nhwc``'s plain version) against the unpadded chain;
``assemble_inputs``; the flax-path ``FluidNet`` and ``make_project_fn``
against JAX's, without polish and with the "xla", "pallas" (the Pallas
kernel interpreted, as the JAX package's own tests run it), "fused" and
"mg" polishes, and with a refinement PUNet; three 64^2 plume steps under
each of the two architectures' checkpoints and one 64x256 cylinder step
against JAX's ``simulate_step``; the entry points' dispatch.

The trained weights reach flax as the committed torch files converted back
(``_flax_tree``); ``tests/test_torch_weights.py`` holds each file equal to
its checkpoint's conversion bit for bit.

Tolerances: ``resize`` 1e-6 (the same filter, summed in another order);
the padded chain 1e-6 of the largest output (the zero channels add exact
zeros, the sums run in another order); the networks and the projection
1e-5 of each output's largest value (convolutions summed in another
order); steps 1e-4 of each field's largest value, as
tests/test_torch_step.py holds the PUNet step. The JAX steps run max_disp
1, as there: the same fields while no back-trace exceeds one cell
(asserted).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_flags
from fluidnet_cxx_tpu.config import ModelConfig as JModelConfig
from fluidnet_cxx_tpu.models import fluidnet as j_fn
from fluidnet_cxx_tpu.models.multi_scale import MultiScaleNet as JScaleNet
from fluidnet_cxx_tpu.models.multi_scale import _resize as j_resize
from fluidnet_cxx_tpu.sim import create_plume_scene as j_plume
from fluidnet_cxx_tpu.sim import plume_config as j_plume_config
from fluidnet_cxx_tpu.sim import scenes as j_scenes
from fluidnet_cxx_tpu.sim import simulate_step as j_step
from fluidnet_cxx_tpu_torch import run_cylinder as rc
from fluidnet_cxx_tpu_torch.config import ModelConfig, load_model_config
from fluidnet_cxx_tpu_torch.models import fluidnet as t_fn
from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                   random_flax_params)
from fluidnet_cxx_tpu_torch.models.multi_scale import MultiScaleNet, resize
from fluidnet_cxx_tpu_torch.models.punet import PUNet
from fluidnet_cxx_tpu_torch.ops.kernels import punet as k_punet
from fluidnet_cxx_tpu_torch.run_plume import (MODEL_DIR, build_net,
                                              plume_case)
from fluidnet_cxx_tpu_torch.sim.step import simulate_step

torch.set_num_threads(1)

MODELS = MODEL_DIR.parent
TOWER, SCALENETS = "DataTrain_128", ("ScaleNet_jets_128",
                                     "ScaleNet_onDevice_128",
                                     "ScaleNet_rollout_128")
# A refinement PUNet small enough for the CPU.
REFINE = dict(model="PUNet", punet_patch=4, punet_widths=(32, 32),
              punet_bottleneck_convs=1, punet_refine_ch=8,
              punet_refine_convs=2)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """The JAX reference is compile-bound here (one small XLA program per
    op and window offset); XLA's optimisation passes change no result
    beyond rounding and double its compile time, so this module runs
    without them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _flax_tree(net):
    """A port net's parameters as the flax tree (HWIO kernels, a name
    with "/" nested)."""
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


def _seeded(mcfg, seed=1):
    net = t_fn.make_net(mcfg)
    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table,
                                                              seed)))
    return net.eval()


def _jax_fluidnet(net, **cfg):
    """(the JAX FluidNet of ``cfg``, its params holding ``net``'s
    weights)."""
    model = j_fn.FluidNet(JModelConfig(**cfg))
    sub = {"PUNet": "PUNet_0", "ScaleNet": "MultiScaleNet_0"}.get(
        model.cfg.model, "FluidNetTower_0")
    return model, {"params": {sub: _flax_tree(net)}}


@pytest.mark.parametrize("hw", [(32, 24), (16, 12), (17, 13), (128, 96)],
                         ids=["down2", "down4", "odd", "up2"])
def test_resize_matches_jax_image_resize(rng, hw):
    """JAX's "linear" resize antialiases when it downsamples; torch's
    bilinear matches it only with antialias=True (without, 1.5 apart at
    a 4x downsample)."""
    x = rng.standard_normal((2, 64, 48, 3)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), hw))
    _close(resize(T(x), hw), want, 1e-6)


@pytest.mark.parametrize("model", ["FluidNet", "ScaleNet", "PUNet"])
def test_padded_chain_matches_unpadded_chain(rng, monkeypatch, model):
    """net_forward on a CPU tensor (zero-padded weights, inputs widened
    to 32 channels, every conv through conv2d_nhwc) equals the plain
    unpadded chain, and routes each conv call through conv2d_nhwc. The
    refinement PUNet pads its refinement stack only."""
    mcfg = ModelConfig(**REFINE) if model == "PUNet" else ModelConfig(
        model=model)
    net = _seeded(mcfg)
    packed = k_punet.pack_weights(net)
    for name, (w, b) in packed.items():
        co, ci = net.convs[name].weight.shape[:2]
        if not net.thin(name):   # PUNet's U-Net keeps its widths
            assert w.shape[2:] == (ci, co), name
            continue
        assert w.shape[2] % 32 == 0 and w.shape[3] % (
            4 if name in net.outputs else 32) == 0, name
        assert not w[:, :, ci:].any() and not w[..., co:].any()
        assert not b[co:].any()
    calls = []
    conv = k_punet.conv2d_nhwc
    monkeypatch.setattr(k_punet, "conv2d_nhwc",
                        lambda *a, **k: calls.append(a) or conv(*a, **k))
    x = T(rng.standard_normal((2, 32, 32, 2)).astype(np.float32))
    with torch.no_grad():
        want = net(x)
        got = k_punet.net_forward(net, packed, x)
    assert got.shape == want.shape == (2, 32, 32, 1)
    _close(got, want, 1e-6)
    n_convs = {"FluidNet": 10, "ScaleNet": 17}.get(model, len(net.table))
    assert len(calls) == n_convs
    assert all(c[0].shape[-1] % 32 == 0 for c in calls)
    assert sum(map(net.thin, net.convs)) == (
        3 if model == "PUNet" else len(net.table))


@pytest.mark.parametrize("chan", ["input_div", "input_p_div",
                                  "input_u_div"])
def test_assemble_inputs_matches_jax(rng, chan):
    kw = dict(input_div=chan == "input_div",
              input_p_div=chan == "input_p_div",
              input_u_div=chan == "input_u_div",
              normalize_input_chan={"input_div": "UDiv",
                                    "input_p_div": "pDiv",
                                    "input_u_div": "div"}[chan])
    flags = random_flags(rng, 2, 24, 32)
    U = rng.standard_normal((2, 2, 24, 32)).astype(np.float32)
    p = rng.standard_normal((2, 24, 32)).astype(np.float32)
    want = j_fn.assemble_inputs(JModelConfig(**kw), p, U, flags, None)
    got = t_fn.assemble_inputs(ModelConfig(**kw), T(p), T(U), T(flags),
                               None)
    assert got[0].shape[-1] == ModelConfig(**kw).in_dims
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


NET_CASES = [(TOWER, None), (TOWER, 1)] + [(n, None) for n in SCALENETS] + [
    (SCALENETS[0], 1)]


@pytest.mark.parametrize("name,seed", NET_CASES,
                         ids=[f"{n}-{'trained' if s is None else 'seed'}"
                              for n, s in NET_CASES])
def test_net_matches_flax(rng, name, seed):
    """FluidNetTower and MultiScaleNet against flax with the trained
    weights and with seed weights, at 32^2, 64^2 and (ScaleNet) 64x32."""
    mcfg = load_model_config(str(MODELS / name))
    net = build_net(mcfg, seed, model_dir=MODELS / name)
    flax_net = (JScaleNet() if mcfg.model == "ScaleNet" else
                j_fn.FluidNetTower())
    params = {"params": _flax_tree(net)}
    apply = jax.jit(flax_net.apply)
    shapes = [(1, 32, 32), (2, 64, 64)] + (
        [(1, 64, 32)] if mcfg.model == "ScaleNet" else [])
    for shape in shapes:
        x = rng.standard_normal(shape + (2,)).astype(np.float32)
        x[..., 1] = x[..., 1] > 0
        with torch.no_grad():
            got = net(T(x))
        _close(got, apply(params, jnp.asarray(x)), 1e-5)


def test_tower_needs_sides_divisible_by_4():
    with pytest.raises(ValueError, match="divisible by 4"):
        t_fn.FluidNetTower()(torch.zeros((1, 30, 32, 2)))


PROJ_CASES = {"no polish": dict(model="FluidNet"),
              "xla": dict(model="FluidNet", polish_sweeps=4,
                          polish_impl="xla"),
              "pallas": dict(model="FluidNet", polish_sweeps=4,
                             polish_impl="pallas"),
              "fused": dict(model="FluidNet", polish_sweeps=4,
                            polish_impl="fused"),
              "mg": dict(model="FluidNet", polish_sweeps=4,
                         polish_impl="mg"),
              "refine PUNet": dict(REFINE, polish_sweeps=4),
              "ScaleNet u_div": dict(model="ScaleNet", input_div=False,
                                     input_u_div=True)}


@pytest.mark.parametrize("case", list(PROJ_CASES))
def test_flax_path_projection_matches_jax(rng, monkeypatch, case):
    """``FluidNet`` / ``make_project_fn`` against JAX's ``FluidNet.apply``
    on seed weights at 32^2; the Pallas polishes in interpret mode."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp_call)
    cfg = PROJ_CASES[case]
    mcfg = ModelConfig(**cfg)
    net = _seeded(mcfg)
    model, params = _jax_fluidnet(net, **cfg)
    flags = random_flags(rng, 2, 32, 32, p_obstacle=0.05)
    U = rng.standard_normal((2, 2, 32, 32)).astype(np.float32)
    p = rng.standard_normal((2, 32, 32)).astype(np.float32)
    want = jax.jit(lambda p, U, f: model.apply(params, p, U, f, None))(
        p, U, flags)
    project = t_fn.make_project_fn(mcfg, net)
    assert not getattr(project, "handles_const_vals", False)
    got = project(T(p), T(U), T(flags), None)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    with torch.no_grad():
        plain = t_fn.FluidNet(mcfg, net)(T(p), T(U), T(flags), None)
    for g, w in zip(plain, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("name", [TOWER, SCALENETS[0]])
def test_plume_steps_match_jax(name):
    """Three 64^2 plume steps under the trained checkpoint: the port's
    entry-point case against JAX's simulate_step with the flax
    make_project_fn (both unfused)."""
    cfg, state, project = plume_case(64, device="cpu",
                                     model_dir=MODELS / name)
    mcfg = load_model_config(str(MODELS / name))
    model, params = _jax_fluidnet(build_net(mcfg, model_dir=MODELS / name),
                                  model=mcfg.model)
    j_project = j_fn.make_project_fn(model, params)
    jcfg = j_plume_config(dt=0.1, line_trace=True, line_trace_impl="firsthit",
                          max_disp=1, use_pallas=False, sim_method="convnet")
    jstate = j_plume(64, 64, density_val=0.1, u_scale=1.0, rad=0.145)
    jax_step = jax.jit(lambda s: j_step(jcfg, s, project_fn=j_project))
    with torch.no_grad():
        for _ in range(3):
            assert 0.1 * float(jnp.abs(jstate.U).max()) < 1.0
            jstate = jax_step(jstate)
            state = simulate_step(cfg, state, project)
            for field in ("U", "density", "p"):
                _close(getattr(state, field), getattr(jstate, field), 1e-4)
    assert torch.isfinite(state.U).all()


def test_cylinder_step_matches_jax():
    """One 64x256 cylinder step under the trained DataTrain_128 (stick
    walls: the unfused branch on both sides)."""
    cfg, state, project = rc.cylinder_case(
        256, 64, "cpu", radius=8.0, center_x=40.0, sim_method="convnet",
        model_dir=MODELS / TOWER)
    net = build_net(load_model_config(str(MODELS / TOWER)),
                    model_dir=MODELS / TOWER)
    model, params = _jax_fluidnet(net, model="FluidNet")
    jstate, jnu = j_scenes.create_cylinder_scene(256, 64, center_x=40.0,
                                                 radius=8.0)
    jcfg = j_scenes.cylinder_config(jnu, max_disp=1, sim_method="convnet")
    jstate = jax.jit(lambda s: j_step(
        jcfg, s, project_fn=j_fn.make_project_fn(model, params)))(jstate)
    with torch.no_grad():
        state = simulate_step(cfg, state, project)
    for field in ("U", "p"):
        _close(getattr(state, field), getattr(jstate, field), 1e-4)


def test_entry_dispatch_builds_each_architecture():
    """plume_case builds the checkpoint's net on the flax path (no
    handles_const_vals) for the tower and ScaleNet, the refine-free
    PUNetD2_128 still on the fused path; summary counts the reference's
    parameters; run_cylinder names the net it ran."""
    for name, n_params in ((TOWER, 5361), (SCALENETS[0], 418643)):
        _, _, project = plume_case(16, device="cpu", model_dir=MODELS / name)
        assert not getattr(project, "handles_const_vals", False)
        net = build_net(load_model_config(str(MODELS / name)),
                        model_dir=MODELS / name)
        assert t_fn.summary(net).splitlines()[-1].split()[-1] == \
            f"{n_params:,d}"
    _, _, project = plume_case(16, device="cpu")
    assert project.handles_const_vals
    assert isinstance(build_net(ModelConfig(**REFINE), 0), PUNet)
    assert isinstance(build_net(ModelConfig(model="ScaleNet"), 0),
                      MultiScaleNet)
    with pytest.raises(ValueError, match="refine-free PUNet"):
        t_fn.make_project_fn_fused_forward(ModelConfig(**REFINE),
                                           build_net(ModelConfig(**REFINE),
                                                     0))
    out = rc.run_cylinder(64, 32, 1, "cpu", radius=4.0, center_x=16.0,
                          sim_method="convnet", model_dir=MODELS / TOWER,
                          weight_seed=2)
    assert (out["model"], out["weights"]) == ("FluidNet", "seed:2")
