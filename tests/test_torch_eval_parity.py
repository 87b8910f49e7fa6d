"""The twin of ``scripts/eval_parity.py`` (the CNN against Jacobi-28, -100
and -200 on the plume), port against JAX's script on the CPU, both at
``--res 32 --iters 4 --statIter 2`` with ``--modelDir
trained_models/PUNetD2_128`` (the port reads its converted
``torch_state_dict.pt``, JAX the orbax checkpoint).

Both run ``plume_config``'s defaults: use_pallas off, so the density
takes the march trace on the window engine. JAX runs them at max_disp 1
(its window engine then compiles in a fraction of the time), which gives
the same fields while no back-trace reaches a cell away: the plume's
inlet moves 0.05 cells a step here.

Tolerances: equal heights (``growth.npy``, the summary's final heights);
1e-4 relative on the summary's divergences and ratio.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu_torch.scripts import eval_parity
from torch_jax_scripts import run_jax_script

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODEL = str(ROOT / "trained_models" / "PUNetD2_128")


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs
    without them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def test_eval_parity_matches_jax_script(tmp_path, capsys):
    argv = ["--res", "32", "--iters", "4", "--statIter", "2",
            "--modelDir", MODEL]
    jax_out = run_jax_script("eval_parity", argv + [
        "--out", str(tmp_path / "jax")], max_disp=1)
    summary, results = eval_parity.main(
        argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    printed = capsys.readouterr().out
    want = json.loads((tmp_path / "jax" / "summary.json").read_text())
    got = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert got == summary and set(got) == set(want)
    assert list(want) == ["jacobi-28", "jacobi-100", "jacobi-200",
                          "convnet", "convnet_vs_jacobi100_div_ratio"]
    for case, rec in want.items():
        if case == "convnet_vs_jacobi100_div_ratio":
            assert abs(got[case] - rec) <= 1e-4 * abs(rec)
            continue
        assert got[case]["final_height"] == rec["final_height"], case
        for k in ("mean_div", "max_div"):
            assert abs(got[case][k] - rec[k]) <= 1e-4 * abs(rec[k]), (case, k)
    assert np.array_equal(np.load(tmp_path / "port" / "growth.npy"),
                          np.load(tmp_path / "jax" / "growth.npy"))
    # JAX's per-case lines, and its plot or its "plot failed" line.
    for line in jax_out.splitlines():
        if "final height" in line:
            assert line.split("mean|div|")[0] in printed
    png = (tmp_path / "port" / "growth.png").exists()
    assert png or "plot failed:" in printed
    assert all(r["ms_per_step"] > 0 for r in results)
    assert all(0.1 * float(r["state"].U.abs().max()) < 1.0 for r in results)
