"""The dataset twins, port against JAX's scripts on the CPU:
``make_dataset`` at ``--scenesTr 1 --scenesTe 1 --res 32
--framesPerScene 3`` (the same ``--seed`` draws the same scenes; a
multigrid step without the line trace), then ``preprocess_data`` over
the scenes the port wrote, against JAX's ``preprocess_data.py`` over
the same scenes.

JAX runs its step at max_disp 1 (its window engine then compiles in a
fraction of the time), which gives the same fields while no back-trace
reaches a cell away (asserted on the frames).

Tolerances: every frame's flags equal, its p, U and density within 1e-5
of the field's largest value (8 V-cycles sum in another order); the
preprocessed frames equal.
"""
import json

import jax
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu_torch.data.manta_io import load_manta_file
from fluidnet_cxx_tpu_torch.scripts import make_dataset, preprocess_data
from torch_jax_scripts import run_jax_script

torch.set_num_threads(1)

@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs
    without them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def test_make_dataset_and_preprocess_match_jax(tmp_path):
    argv = ["--scenesTr", "1", "--scenesTe", "1", "--res", "32",
            "--framesPerScene", "3", "--seed", "3"]
    run_jax_script("make_dataset", argv + ["--out", str(tmp_path / "jax")],
                   max_disp=1)
    seconds = make_dataset.main(argv + ["--out", str(tmp_path / "port"),
                                        "--device", "cpu"])
    assert len(seconds) == 2
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    frames = [f for f in files if f.suffix == ".bin"]
    assert len(frames) == 2 * 3 * 2
    for f in frames:
        want = load_manta_file(str(tmp_path / "jax" / f))
        got = load_manta_file(str(tmp_path / "port" / f))
        assert np.array_equal(got[2], want[2]), f
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(
                np.abs(w).max(), 1e-6), err_msg=str(f))
        assert 0.1 * np.abs(got[1]).max() < 1.0
    # A rerun skips the scenes that are DONE.
    assert make_dataset.main(argv + ["--out", str(tmp_path / "port"),
                                     "--device", "cpu"]) == []

    data = str(tmp_path / "port")
    pre = ["--dataDir", data, "--dataset", "plume_mg", "--stepsPerScene",
           "3"]
    run_jax_script("preprocess_data", pre + ["--out", str(tmp_path / "jp")])
    assert preprocess_data.main(pre + ["--out", str(tmp_path / "pp")]) == \
        ["tr", "te"]
    npz = sorted(p.relative_to(tmp_path / "jp")
                 for p in (tmp_path / "jp").rglob("*") if p.is_file())
    assert npz == sorted(p.relative_to(tmp_path / "pp")
                         for p in (tmp_path / "pp").rglob("*")
                         if p.is_file())
    assert len([f for f in npz if f.suffix == ".npz"]) == 2 * 3
    for f in npz:
        if f.suffix == ".json":
            assert json.loads((tmp_path / "pp" / f).read_text()) == \
                json.loads((tmp_path / "jp" / f).read_text())
            continue
        with np.load(tmp_path / "pp" / f) as g, \
                np.load(tmp_path / "jp" / f) as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                assert np.array_equal(g[k], w[k]), (f, k)
