"""The port's A.9.4 utilities against their JAX functions on the CPU:

* ``utils/plotting.py``: ``plot_field``, ``save_density_png`` and
  ``plot_loss_history`` on the same numbers write the same PNG bytes as
  JAX's (same matplotlib), each decoding to an RGBA image of the expected
  size;
* ``utils/diagnostics.py``: ``StepTimer`` counts and rates as JAX's
  (``rate(pending)`` waits on a tensor, a SimState or nothing);
  ``profile_trace`` writes a Chrome trace that names an op run inside it;
* ``state.py``: ``from_reference_layout`` / ``to_reference_layout`` equal
  to JAX's on the same 5-D arrays, both ways;
* ``config.py``: ``save_config`` writes JAX's bytes, and each package's
  ``load_config`` reads the other's file;
* ``utils/vtk_export.py::write_vtk(..., extra_fields=...)`` writes the
  bytes JAX's writes for the same state and extra fields (every field is
  a copy or the same float32 arithmetic);
* ``ops/grid.py::get_dx`` and ``ops/window3.py::max_displacement3`` equal
  to JAX's;
* the ``scripts.plot_loss`` and ``scripts.print_output`` twins: the loss
  PNGs byte-equal to JAX's ``scripts/plot_loss.py`` in another folder;
  print_output on a model folder and a test split written by the port
  (FluidNetTower from seed weights, 16^2), its pressure within 1e-5 of
  the JAX model's on the same weights and frames, and its nine PNGs equal
  to JAX's ``plot_field`` of the same arrays.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib import image as mpimg

from fluidnet_cxx_tpu import config as j_config
from fluidnet_cxx_tpu import state as j_state
from fluidnet_cxx_tpu.ops import grid as j_grid
from fluidnet_cxx_tpu.ops import window as j_window
from fluidnet_cxx_tpu.utils import diagnostics as j_diag
from fluidnet_cxx_tpu.utils import plotting as j_plot
from fluidnet_cxx_tpu.utils.vtk_export import write_vtk as j_write_vtk
from fluidnet_cxx_tpu_torch import config as t_config
from fluidnet_cxx_tpu_torch import state as t_state
from fluidnet_cxx_tpu_torch.ops import grid as t_grid
from fluidnet_cxx_tpu_torch.ops import window3 as t_window3
from fluidnet_cxx_tpu_torch.utils import diagnostics as t_diag
from fluidnet_cxx_tpu_torch.utils import plotting as t_plot
from fluidnet_cxx_tpu_torch.utils.vtk_export import write_vtk as t_write_vtk

torch.set_num_threads(1)


def _png(path):
    img = mpimg.imread(str(path))
    assert img.ndim == 3 and img.shape[2] == 4 and np.isfinite(img).all()
    return img


def _state(rng, h=12, w=20):
    flags = np.full((1, h, w), 1, np.int32)
    flags[:, [0, -1]] = 2
    flags[..., [0, -1]] = 2
    flags[:, 4:6, 7:9] = 2
    return dict(p=rng.standard_normal((1, h, w)).astype(np.float32),
                U=rng.standard_normal((1, 2, h, w)).astype(np.float32),
                flags=flags,
                density=rng.random((1, h, w)).astype(np.float32))


def _t_state(d):
    return t_state.SimState(**{k: torch.from_numpy(v) for k, v in d.items()})


def _j_state(d):
    return j_state.SimState(**{k: jnp.asarray(v) for k, v in d.items()})


def test_plots_write_jax_bytes(tmp_path, rng):
    d = _state(rng)
    out, target = d["p"][0], d["density"][0]
    t_plot.plot_field(torch.from_numpy(out), target, d["flags"][0],
                      tmp_path / "t.png", "pressure")
    j_plot.plot_field(out, target, d["flags"][0], tmp_path / "j.png",
                      "pressure")
    t_plot.save_density_png(_t_state(d), tmp_path / "td.png")
    j_plot.save_density_png(_j_state(d), tmp_path / "jd.png")
    hist = np.stack([np.arange(5.0)] + [np.exp(-np.arange(5.0) * k)
                                        for k in range(1, 7)], axis=1)
    hist[:, 6] = 0.0
    np.save(tmp_path / "loss.npy", hist)
    t_plot.plot_loss_history(str(tmp_path / "loss.npy"), tmp_path / "tl.png")
    j_plot.plot_loss_history(str(tmp_path / "loss.npy"), tmp_path / "jl.png")
    for a, b, shape in (("t", "j", (400, 1200)), ("td", "jd", (12, 20)),
                        ("tl", "jl", (500, 800))):
        assert (tmp_path / f"{a}.png").read_bytes() == \
            (tmp_path / f"{b}.png").read_bytes()
        assert _png(tmp_path / f"{a}.png").shape[:2] == shape


def test_step_timer_and_profile_trace(tmp_path, rng):
    for timer in (t_diag.StepTimer(), j_diag.StepTimer()):
        timer.start()
        timer.tick()
        timer.tick(3)
        assert timer.steps == 4
        assert 0 < timer.rate() < float("inf")
    timer = t_diag.StepTimer()
    timer.start()
    timer.tick(2)
    state = _t_state(_state(rng))
    assert timer.rate(state) > 0 and timer.rate(state.U) > 0
    with t_diag.profile_trace(str(tmp_path / "prof")):
        torch.cumsum(torch.ones(64), 0)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])


def test_reference_layout_both_ways(rng):
    d = _state(rng)
    p5, U5 = d["p"][:, None, None], d["U"][:, :, None]
    f5 = d["flags"].astype(np.float32)[:, None, None]
    r5 = d["density"][:, None, None]
    got = t_state.from_reference_layout(p5, U5, f5, torch.from_numpy(r5))
    want = j_state.from_reference_layout(p5, U5, f5, r5)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == {np.float32: torch.float32,
                           np.int32: torch.int32}[np.asarray(w).dtype.type]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(t_state.to_reference_layout(got),
                    j_state.to_reference_layout(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_config_json_crosses_the_packages(tmp_path):
    conf = {"resX": 64, "dt": 0.1, "gravityVec": {"x": 0.0, "y": -1.0},
            "widths": (8, 16), "name": "plume", "path": tmp_path}
    t_config.save_config(conf, str(tmp_path / "a" / "t.json"))
    j_config.save_config(conf, str(tmp_path / "a" / "j.json"))
    assert (tmp_path / "a" / "t.json").read_bytes() == \
        (tmp_path / "a" / "j.json").read_bytes()
    assert t_config.load_config(str(tmp_path / "a" / "j.json")) == \
        j_config.load_config(str(tmp_path / "a" / "t.json"))
    assert t_config.load_config(str(tmp_path / "a" / "t.json"))["path"] == \
        str(tmp_path)


def test_write_vtk_extra_fields_writes_jax_bytes(tmp_path, rng):
    d = _state(rng)
    extra = {"age": rng.random((12, 20)).astype(np.float32),
             "mask": (d["flags"][0] == 2).astype(np.float32)}
    t_write_vtk(str(tmp_path / "t.vtk"), _t_state(d),
                extra_fields={"age": torch.from_numpy(extra["age"]),
                              "mask": extra["mask"]})
    j_write_vtk(str(tmp_path / "j.vtk"), _j_state(d), extra_fields=extra)
    text = (tmp_path / "t.vtk").read_text()
    assert text == (tmp_path / "j.vtk").read_text()
    assert "SCALARS age float 1" in text and "SCALARS mask float 1" in text
    t_write_vtk(str(tmp_path / "n.vtk"), _t_state(d))
    assert text.startswith((tmp_path / "n.vtk").read_text())


@pytest.mark.parametrize("dims", [(64, 64), (32, 128), (16, 24, 8)])
def test_get_dx_is_jax(dims):
    assert t_grid.get_dx(*dims) == j_grid.get_dx(*dims)


def test_max_displacement3_is_jax(rng):
    U = rng.standard_normal((2, 3, 6, 7, 9)).astype(np.float32)
    got = t_window3.max_displacement3(torch.from_numpy(U), 0.25)
    want = j_window.max_displacement3(jnp.asarray(U), 0.25)
    assert got.dim() == 0 and float(got) == float(want)


def test_plot_loss_twin_writes_jax_pngs(tmp_path):
    from torch_jax_scripts import run_jax_script
    from fluidnet_cxx_tpu_torch.scripts import plot_loss

    hist = np.stack([np.arange(4.0)] + [np.linspace(1, 0.1, 4) * k
                                        for k in range(1, 7)], axis=1)
    for who in ("t", "j"):
        (tmp_path / who).mkdir()
        np.save(tmp_path / who / "train_loss.npy", hist)
        np.save(tmp_path / who / "val_loss.npy", hist[:2])
    written = plot_loss.main(["--modelDir", str(tmp_path / "t")])
    run_jax_script("plot_loss", ["--modelDir", str(tmp_path / "j")])
    assert [os.path.basename(p) for p in written] == ["train_loss.png",
                                                      "val_loss.png"]
    for name in ("train_loss.png", "val_loss.png"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
        _png(tmp_path / "t" / name)


def test_print_output_twin(tmp_path):
    import jax

    from fluidnet_cxx_tpu.config import ModelConfig as JModelConfig
    from fluidnet_cxx_tpu.models import fluidnet as j_fn
    from fluidnet_cxx_tpu_torch.config import ModelConfig, TrainConfig
    from fluidnet_cxx_tpu_torch.data.synthetic import write_synthetic_dataset
    from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_cxx_tpu_torch.scripts import print_output
    from fluidnet_cxx_tpu_torch.train.checkpoint import save_train_checkpoint
    from fluidnet_cxx_tpu_torch.train.trainer import init_train_state
    from test_torch_parallel_train import _jax_params

    model_dir, data_dir = tmp_path / "model", tmp_path / "data"
    mcfg = ModelConfig()
    ts = init_train_state(FluidNet(mcfg), TrainConfig(), seed=3)
    save_train_checkpoint(str(model_dir), ts, 2, 0.5, mcfg)
    write_synthetic_dataset(str(data_dir / "te"), 1, 3, 16, 16, seed=1,
                            jacobi_iters=20, device="cpu")
    res = print_output.main(["--modelDir", str(model_dir), "--dataDir",
                             str(data_dir), "--n", "3", "--device", "cpu"])
    assert res["out"] == str(model_dir / "eval_plots")
    assert sorted(os.listdir(res["out"])) == sorted(
        f"{k}_{i:03d}.png" for k in ("p", "u", "div") for i in range(3))

    frames = [np.load(data_dir / "te" / "000000" / f"{t:06d}.npz")
              for t in range(3)]
    batch = {k: jnp.asarray(np.stack([f[k] for f in frames]))
             for k in ("p_div", "U_div", "flags", "density_div")}
    model = j_fn.FluidNet(JModelConfig())
    p_want, U_want = jax.jit(model.apply)(
        _jax_params(ts.model.net), batch["p_div"], batch["U_div"],
        batch["flags"], batch["density_div"])
    p_want = np.asarray(p_want)
    np.testing.assert_allclose(res["p"], p_want, rtol=0,
                               atol=1e-5 * np.abs(p_want).max())
    np.testing.assert_allclose(res["U"], np.asarray(U_want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(U_want)).max())
    for i in range(3):
        f = res["flags"][i]
        for key, got, target, title in (
                ("p", res["p"][i], res["p_target"][i], "pressure"),
                ("u", res["U"][i, 0], res["U_target"][i, 0], "u"),
                ("div", res["div"][i], res["div_target"][i], "divergence")):
            j_plot.plot_field(got, target, f, tmp_path / "j.png", title)
            assert (tmp_path / "j.png").read_bytes() == \
                (model_dir / "eval_plots" / f"{key}_{i:03d}.png").read_bytes()
