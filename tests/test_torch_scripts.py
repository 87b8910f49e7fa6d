"""The twins of the JAX scene drivers and the training entry point's
``--trainConfig``, on the CPU at 32^2 and a few steps, into ``tmp_path``.

Each twin's ``main(argv)`` with ``--device cpu``: the files it writes, its
last line, ``sim_config.yaml`` under ``yaml.safe_load``, the VTK against
the JAX package's ``write_vtk`` of the same state (within 1e-6 of each
field's largest value), ``--restartSim`` resuming at the saved ``it``,
a missing restart file and a run that asks for plots without matplotlib.
The Rayleigh-Taylor measures are held to JAX's on the same densities.
``--trainConfig configs/train.yaml`` gives the configs JAX's
``scripts/train.py`` builds from it, flags included.
"""
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fluidnet_cxx_tpu import config as j_config
from fluidnet_cxx_tpu.state import SimState as JSimState
from fluidnet_cxx_tpu.utils import diagnostics as j_diag
from fluidnet_cxx_tpu.utils.vtk_export import write_vtk as j_write_vtk
from fluidnet_cxx_tpu_torch import config as t_config
from fluidnet_cxx_tpu_torch.scripts import run_cylinder, run_plume
from fluidnet_cxx_tpu_torch.scripts import run_rayleigh_taylor as run_rt
from fluidnet_cxx_tpu_torch.train import __main__ as t_main
from fluidnet_cxx_tpu_torch.utils import diagnostics as t_diag

torch.set_num_threads(1)


def _conf(tmp_path, src, **changes):
    """A copy of ``configs/<src>`` with ``changes``, written by PyYAML
    (its own layout: sorted keys, block style)."""
    with open(f"configs/{src}") as f:
        conf = yaml.safe_load(f)
    conf.update(changes)
    path = tmp_path / src
    path.write_text(yaml.safe_dump(conf))
    return str(path), conf


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _vtk_sections(path):
    """(the header lines, {SCALARS/VECTORS line: its numbers}) of a legacy
    VTK file."""
    head, out, key = [], {}, None
    with open(path) as f:
        for line in f:
            if line.startswith(("SCALARS", "VECTORS")):
                key = line.strip()
                out[key] = []
            elif line.startswith("LOOKUP_TABLE") or key is None:
                head.append(line.strip())
            else:
                out[key].append([float(v) for v in line.split()])
    return head, {k: np.array(v) for k, v in out.items()}


def _jax_state(state):
    return JSimState(**{k: None if v is None else jnp.asarray(v.numpy())
                        for k, v in state._asdict().items()})


def test_plume_twin_outputs_and_restart(tmp_path, capsys):
    path, conf = _conf(tmp_path, "plume.yaml", statIter=4, jacobiIter=8,
                       saveVTK=True)
    out = str(tmp_path / "out")
    argv = ["--simConf", path, "--resX", "32", "--resY", "32",
            "--outputFolder", out, "--device", "cpu"]
    res = run_plume.main(argv + ["--maxIter", "4"])
    printed = _last_json(capsys)
    assert printed == {k: v for k, v in res.items() if k != "state"}
    assert (res["it"], res["steps"], res["start_it"]) == (4, 4, 0)
    assert res["finite"] and res["sim_method"] == "jacobi"
    assert res["ms_per_step"] > 0 and res["max_div"] >= res["mean_div"] > 0
    assert sorted(os.listdir(out)) == ["restart.npz", "sim_config.yaml",
                                       "snap_000004.png", "snap_000004.vtk"]
    with open(os.path.join(out, "sim_config.yaml")) as f:
        assert yaml.safe_load(f) == dict(conf, resX=32, resY=32, maxIter=4,
                                         outputFolder=out)

    j_write_vtk(str(tmp_path / "jax.vtk"), _jax_state(res["state"]))
    head, got = _vtk_sections(os.path.join(out, "snap_000004.vtk"))
    want_head, want = _vtk_sections(str(tmp_path / "jax.vtk"))
    assert head == want_head and list(got) == list(want)
    assert len(want) == 7 and want["SCALARS density float 1"].size == 32 * 32
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=0, err_msg=key,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30))

    path, _ = _conf(tmp_path, "plume.yaml", statIter=4, jacobiIter=8,
                    saveVTK=True, realTimePlot=False)
    argv[1] = path
    again = run_plume.main(argv + ["--maxIter", "6", "--restartSim"])
    assert "restarting at it=4" in capsys.readouterr().out
    assert (again["start_it"], again["it"], again["steps"]) == (4, 6, 2)
    assert sorted(os.listdir(out))[-2:] == ["snap_000004.vtk",
                                            "snap_000006.vtk"]


def test_plume_twin_restart_file_missing_starts_from_the_scene(tmp_path,
                                                                capsys):
    path, _ = _conf(tmp_path, "plume.yaml", statIter=2, jacobiIter=4,
                    realTimePlot=False)
    res = run_plume.main(["--simConf", path, "--resX", "32", "--resY", "32",
                          "--maxIter", "2", "--outputFolder",
                          str(tmp_path / "o"), "--restartSim", "--device",
                          "cpu"])
    assert "starting from the scene at it=0" in capsys.readouterr().out
    assert res["start_it"] == 0 and res["it"] == 2


@pytest.mark.parametrize("method,model_dir", [
    ("convnet", "trained_models/PUNetD2_128"),
    ("mg_learned", "trained_models/MGCoarse_128"),
    ("multigrid", None)])
def test_plume_twin_projections(method, model_dir, tmp_path):
    path, _ = _conf(tmp_path, "plume.yaml", statIter=2, realTimePlot=False)
    argv = ["--simConf", path, "--resX", "32", "--resY", "32", "--maxIter",
            "2", "--outputFolder", str(tmp_path / "o"), "--simMethod",
            method, "--device", "cpu"]
    if model_dir is None:
        res = run_plume.main(argv)
    else:
        with pytest.raises(ValueError, match="needs modelDir"):
            run_plume.main(argv)
        res = run_plume.main(argv + ["--modelDir", model_dir])
    assert res["finite"] and res["sim_method"] == method
    assert res["max_div"] < 1.0


def test_twins_ask_for_matplotlib_before_the_first_step(tmp_path,
                                                        monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    path, _ = _conf(tmp_path, "plume.yaml", statIter=1)
    out = tmp_path / "o"
    with pytest.raises(ImportError, match="realTimePlot: false"):
        run_plume.main(["--simConf", path, "--resX", "32", "--resY", "32",
                        "--maxIter", "1", "--outputFolder", str(out),
                        "--device", "cpu"])
    with pytest.raises(ImportError, match="matplotlib"):
        run_cylinder.main(["--resX", "64", "--resY", "32", "--radius", "4",
                           "--centerX", "16", "--maxIter", "1",
                           "--outputFolder", str(out), "--device", "cpu"])
    assert not out.exists() or not any(out.iterdir())


def test_rayleigh_taylor_twin(tmp_path, capsys):
    path, _ = _conf(tmp_path, "rayleighTaylor.yaml", resX=32, resY=32,
                    statIter=2, simMethod="multigrid")
    out = str(tmp_path / "rt")
    res = run_rt.main(["--simConf", path, "--maxIter", "4", "--outputFolder",
                       out, "--device", "cpu"])
    assert _last_json(capsys)["interface_distance"] == \
        res["interface_distance"]
    assert res["finite"] and res["sim_method"] == "multigrid"
    assert sorted(os.listdir(out)) == [
        "avg_density.npy", "distance.npy", "restart.npz", "snap_000002.png",
        "snap_000004.png"]
    dist = np.load(os.path.join(out, "distance.npy"))
    rho = np.load(os.path.join(out, "avg_density.npy"))
    assert dist.shape == rho.shape == (2, 2) and np.isfinite(dist).all()
    np.testing.assert_array_equal(dist[:, 0], [1.0, 2.0])   # it * dt 0.5
    dens = jnp.asarray(res["state"].density.numpy())
    assert dist[-1, 1] == pytest.approx(
        float(j_diag.rt_interface_distance(dens, 32)), abs=1e-6)
    # The mean's float32 sums run in another order: 1e-6 of the largest
    # density.
    assert rho[-1, 1] == pytest.approx(float(j_diag.mean_density(dens)),
                                       abs=1e-6 * 0.01)
    path, _ = _conf(tmp_path, "rayleighTaylor.yaml", resX=32, resY=32,
                    statIter=2, simMethod="multigrid", realTimePlot=False)
    again = run_rt.main(["--simConf", path, "--maxIter", "6",
                         "--outputFolder", out, "--restartSim", "--device",
                         "cpu"])
    assert (again["start_it"], again["it"]) == (4, 6)
    assert np.load(os.path.join(out, "distance.npy")).shape == (1, 2)
    with pytest.raises(ValueError, match="runs jacobi, multigrid"):
        run_rt.main(["--simConf", _conf(tmp_path, "rayleighTaylor.yaml",
                                        simMethod="convnet")[0],
                     "--device", "cpu"])


@pytest.mark.parametrize("method", ["jacobi", "multigrid"])
def test_rt_case_is_the_shipped_yaml(method):
    """The entry point's ``rt_case`` and the twin's case from the shipped
    YAML are one case: ``rayleigh_taylor_config`` and the default tanh
    interface."""
    from fluidnet_cxx_tpu_torch.run_rayleigh_taylor import (
        rt_case, rt_case_from_conf)
    from fluidnet_cxx_tpu_torch.sim.scenes import (
        create_rayleigh_taylor_scene, rayleigh_taylor_config)

    want_cfg = rayleigh_taylor_config(sim_method=method, use_pallas=True,
                                      jacobi_iter=200, mg_vcycles=2)
    want = create_rayleigh_taylor_scene(32, 64)
    conf = dict(t_config.load_yaml("configs/rayleighTaylor.yaml"), resX=32,
                resY=64, simMethod=method)
    for cfg, state in (rt_case(32, 64, "cpu", method),
                       rt_case_from_conf(conf, "cpu")):
        assert cfg == want_cfg
        for got, w in zip(state, want):
            assert (got is None and w is None) or torch.equal(got, w)


@pytest.mark.parametrize("case", ["interface", "flat", "none"])
def test_rt_measures_match_jax(case):
    rng = np.random.default_rng(3)
    rho = rng.normal(0.0, 0.01, (1, 48, 20)).astype(np.float32)
    col = np.linspace(-0.01, 0.01, 48, dtype=np.float32)
    if case == "interface":
        rho[0, :, 10] = col
    elif case == "flat":
        rho[0, :, 10] = 0.0
        rho[0, 30, 10], rho[0, 31, 10] = -1e-14, 1e-14
    else:
        rho[0, :, 10] = 0.5
    got = t_diag.rt_interface_distance(torch.from_numpy(rho), 48)
    want = j_diag.rt_interface_distance(jnp.asarray(rho), 48)
    assert got.dim() == 0 and float(got) == pytest.approx(float(want),
                                                          abs=1e-6)
    assert float(t_diag.mean_density(torch.from_numpy(rho))) == \
        pytest.approx(float(j_diag.mean_density(jnp.asarray(rho))),
                      abs=1e-6 * float(np.abs(rho).max()))


def test_cylinder_twin(tmp_path, capsys):
    out = str(tmp_path / "cyl")
    argv = ["--resX", "128", "--resY", "32", "--radius", "4", "--centerX",
            "20", "--statIter", "4", "--outputFolder", out, "--device",
            "cpu"]
    res = run_cylinder.main(argv + ["--maxIter", "4"])
    assert _last_json(capsys)["max_U"] == res["max_U"]
    assert res["finite"] and res["max_U"] >= 1.0
    assert sorted(os.listdir(out)) == ["restart.npz", "snap_000004.png",
                                       "wake_000004.png"]
    again = run_cylinder.main(argv + ["--maxIter", "6", "--restartSim",
                                      "--realTimePlot", "no",
                                      "--simMethod", "multigrid"])
    assert (again["start_it"], again["it"]) == (4, 6)
    assert again["sim_method"] == "multigrid" and again["finite"]


def _jax_train_configs(conf, model=None, polish=None, widths=None,
                       dilation=None, bsz=None, lr=None, p_l2=None):
    """The configs the JAX ``scripts/train.py`` builds (its lines 94-119)."""
    mconf = conf.get("modelParam", {}) or {}
    tc = j_config.train_config_from_yaml(conf)
    if bsz:
        tc = dataclasses.replace(tc, batch_size=bsz)
    if lr:
        tc = dataclasses.replace(tc, lr=lr)
    if p_l2 is not None:
        tc = dataclasses.replace(tc, p_l2_lambda=p_l2)
    if model:
        mconf["model"] = model
    if polish is not None:
        mconf["polishSweeps"] = polish
    if widths:
        mconf["punetWidths"] = [int(x) for x in widths.split(",")]
    if dilation is not None:
        mconf["punetBottleneckDilation"] = dilation
    return (j_config.model_config_from_mconf(mconf), tc,
            j_config.sim_config_from_mconf(mconf))


def _as_dicts(cfgs):
    return [dataclasses.asdict(c) for c in cfgs]


@pytest.mark.parametrize("flags", [
    [], ["--model", "PUNet", "--punetWidths", "96,128,128",
         "--punetDilation", "2", "--polishSweeps", "32", "--bsz", "8",
         "--lr", "0.0001", "--pL2", "0.5"]])
def test_train_config_yaml_equals_jax(flags):
    args = t_main.parse_args(["--trainConfig", "configs/train.yaml", *flags])
    with open("configs/train.yaml") as f:
        conf = yaml.safe_load(f)
    want = _jax_train_configs(
        conf, args.model, args.polishSweeps, args.punetWidths,
        args.punetDilation, args.bsz, args.lr, args.pL2)
    assert _as_dicts(t_main.configs(args)) == _as_dicts(want)


def test_train_configs_without_yaml_are_the_defaults():
    mcfg, tc, scfg = t_main.configs(t_main.parse_args([]))
    assert (mcfg, tc, scfg) == (t_config.ModelConfig(),
                                t_config.TrainConfig(), t_config.SimConfig())
    assert scfg == t_config.sim_config_from_mconf({})


# The three scene twins without --fast against JAX's scripts without it:
# (twin, JAX script, YAML (None: the cylinder's flags), flags, changes).
NO_FAST = {
    "plume": (run_plume, "run_plume", "plume.yaml",
              ["--resX", "32", "--resY", "32"], dict(jacobiIter=8)),
    "rayleigh_taylor": (run_rt, "run_rayleigh_taylor",
                        "rayleighTaylor.yaml", [],
                        dict(resX=32, resY=32, jacobiIter=8,
                             simMethod="jacobi")),
    "cylinder": (run_cylinder, "run_cylinder", None,
                 ["--resX", "64", "--resY", "32", "--radius", "4",
                  "--centerX", "16", "--jacobiIter", "8", "--statIter",
                  "4"], None),
}


@pytest.mark.parametrize("name", list(NO_FAST))
def test_twin_without_fast_matches_jax_script(name, tmp_path, monkeypatch):
    """Four steps of each twin without ``--fast`` (the config's engine and
    the march trace, ``use_pallas`` off) against JAX's script without it:
    the restart files' p, U and density within 1e-5 of each field's
    largest value, the tolerance of the step tests (four steps summed in
    another order). JAX runs at max_disp 1 (its windows compile faster)
    and the port at the config's 4: every displacement of these runs is
    below one cell (asserted), so both windows sample the same cells."""
    from torch_jax_scripts import run_jax_script

    import fluidnet_cxx_tpu.config as jc
    import fluidnet_cxx_tpu.sim as js

    twin, script, yaml_name, flags, changes = NO_FAST[name]
    build = jc.sim_config_from_mconf
    monkeypatch.setattr(jc, "sim_config_from_mconf",
                        lambda conf: build(conf).replace(max_disp=1))
    cyl = js.cylinder_config
    monkeypatch.setattr(js, "cylinder_config",
                        lambda *a, **k: cyl(*a, **k).replace(max_disp=1))
    argv = flags + ["--maxIter", "4"]
    if yaml_name is not None:
        argv += ["--simConf", _conf(tmp_path, yaml_name, statIter=4,
                                    realTimePlot=False, **changes)[0]]
    jout, tout = tmp_path / "jax", tmp_path / "port"
    run_jax_script(script, argv + ["--outputFolder", str(jout)])
    plots = ["--realTimePlot", "false"] if yaml_name is None else []
    res = twin.main(argv + plots + ["--outputFolder", str(tout), "--device",
                                    "cpu"])
    assert res["it"] == 4 and res["finite"]
    dt = 0.5 if name == "rayleigh_taylor" else 0.1
    assert dt * float(res["state"].U.abs().max()) < 1.0
    with np.load(jout / "restart.npz") as j, \
            np.load(tout / "restart.npz") as t:
        assert int(j["it"]) == int(t["it"]) == 4
        for field in ("p", "U", "density"):
            want = j[field]
            np.testing.assert_allclose(
                t[field], want, rtol=0, err_msg=field,
                atol=1e-5 * max(float(np.abs(want).max()), 1e-6))
