"""The twin of ``scripts/quality_per_ms.py``, port against JAX's script
on the CPU, both at ``--res 32 --iters 4 --statIter 2 --jacobi 28 --mg ''
--polish 8`` with ``--modelDir trained_models/PUNetD2_128``: a Jacobi
case and a learned one (PUNet on the flax path with 8 "xla" polish
sweeps), each scored against a 30-V-cycle solve of its own end state.

On the CPU both set use_pallas off, as JAX's script does there, so the
density takes the march trace on the window engine. JAX runs at max_disp
1 (its window engine then compiles in a fraction of the time), which
gives the same fields while no back-trace reaches a cell away: the
plume's inlet moves 0.05 cells a step here.

Tolerances: equal heights; 1e-4 relative on the divergences and the
pressure error, plus one unit of the last digit JAX's record keeps.
"""
import json
from pathlib import Path

import jax
import pytest
import torch

from fluidnet_cxx_tpu_torch.scripts import quality_per_ms
from torch_jax_scripts import run_jax_script

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODEL = str(ROOT / "trained_models" / "PUNetD2_128")
# The record's columns and the rounding JAX's script gives each.
COLUMNS = {"mean_div": 0.0, "max_div": 0.0, "p_err_vs_truth": 1e-5,
           "max_div_one_shot": 1e-6, "max_div_truth": 1e-8}


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs
    without them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def test_quality_per_ms_matches_jax_script(tmp_path, monkeypatch):
    monkeypatch.delenv("QPM_LINE_TRACE", raising=False)
    argv = ["--modelDir", MODEL, "--res", "32", "--iters", "4",
            "--statIter", "2", "--jacobi", "28", "--mg", "", "--polish",
            "8"]
    run_jax_script("quality_per_ms", argv + [
        "--out", str(tmp_path / "jax.json")], max_disp=1)
    got = quality_per_ms.main(argv + ["--out", str(tmp_path / "port.json"),
                                      "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert [r["name"] for r in got] == [r["name"] for r in want] == \
        ["jacobi-28", "punet+8"]
    for g, w in zip(got, want):
        assert g["final_height"] == w["final_height"], g["name"]
        for col, unit in COLUMNS.items():
            assert abs(g[col] - w[col]) <= 1e-4 * abs(w[col]) + unit, \
                (g["name"], col, g[col], w[col])
        assert g["ms_per_step"] > 0 and g["steps_per_sec"] > 0
