"""The port's 3-D bench (``fluidnet_cxx_tpu_torch/bench3d.py``) on the CPU:
the rollout quality of the classical row, the multigrid row (``mg2v``) and
of the learned row's float32 variant against the JAX package's
(``scripts/torch_bench_reference.py::plume3d_quality``), its command
line's one JSON line, and its ``--reference`` check.

The rollouts run bench3d's scene for 6n steps with n = 1, at 24^3
(classical) and 16^3 (multigrid; learned, the trained PUNet3p8_64 in
float32). The
port runs the bench's max_disp 2; JAX runs max_disp 1, which compiles in a
fraction of the time and gives the same fields while no back-trace
exceeds one cell (asserted), as in ``tests/test_torch_step3d.py``.
Tolerance: 1e-4 relative on max|div|, mean|div|, the density sum and
max|U| (the 3-D steps' tolerance there).
"""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import pytest
import torch

from fluidnet_cxx_tpu_torch import bench, bench3d
from fluidnet_cxx_tpu_torch.run_plume3d import quality3
from fluidnet_cxx_tpu_torch.sim.step3d import simulate_step3

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RES, N = 24, 1


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """XLA's optimisation passes change no result beyond rounding and
    double the JAX reference's compile time here; this module runs without
    them and restores the setting for the next module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _reference_script():
    path = ROOT / "scripts" / "torch_bench_reference.py"
    spec = importlib.util.spec_from_file_location("torch_bench_ref3", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("row,res,case", [
    ([], RES, "jacobi60"),
    (["--multigrid"], 16, "mg2v"),
    (["--onlyModel", "--modelDir", "trained_models/PUNet3p8_64",
      "--computeDtype", "float32"], 16, "PUNet3p8_64-float32")])
def test_row_quality_matches_jax(row, res, case):
    """The classical row (Jacobi-60, separate advection, no trace), the
    multigrid row (bench3d's "pallas + multigrid": solve_mg3, 2 V-cycles;
    two levels at 16^3) and the learned row's float32 variant (trained
    PUNet3p8_64: the reference's flax forward and XLA polish against the
    port's forward and fused tail) after 6n steps from t = 0: the bench's
    four quality columns against JAX's."""
    ref = _reference_script()
    args = bench3d.parse(["--device", "cpu", "--res", str(res),
                          "--steps", str(N)] + row)
    rows = bench3d.rows_of(args, torch.device("cpu"))
    assert list(rows)[-1] == case
    cfg, state, project = rows[case]
    with torch.no_grad():
        for _ in range(6 * N):
            assert cfg.dt * float(state.U.abs().max()) < 1.0
            state = simulate_step3(cfg, state, project)
    got = quality3(state)
    want = ref.plume3d_quality(case, res, 6 * N, max_disp=1)
    for col in bench3d.LIMITS3:
        assert abs(got[col] - want[col]) <= 1e-4 * abs(want[col]), \
            (col, got[col], want[col])
    assert bench3d.settings3(60, False) == ref.settings3d(60)


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """One run of bench3d's main on the CPU at 16^3: (its stdout's last
    line, the full table it wrote, its out dir)."""
    out_dir = tmp_path_factory.mktemp("bench3d")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench3d.main(["--device", "cpu", "--res", "16", "--steps", "1",
                      "--reps", "1", "--out-dir", str(out_dir)])
    (path,) = out_dir.glob("bench3d_torch_*.json")
    with open(path) as f:
        full = json.load(f)
    return buf.getvalue().strip().splitlines()[-1], full


def test_main_on_cpu_prints_one_compact_json_line(cpu_run):
    """One JSON line of at most 1.5 KB with bench3d's columns (sps,
    ms_per_step, max_div) a row; no graph on the CPU."""
    line, full = cpu_run
    assert len(line.encode()) <= 1500
    out = json.loads(line)
    assert out["metric"] == "plume3d_16_jacobi60_steps_per_sec"
    assert out["graph"] is None and out["value"] is None
    assert out["device"] == "cpu" and "no graph" in out["clock"]
    row = out["rows"]["jacobi60"]
    assert set(row) == {"sps", "ms_per_step", "eager_sps", "max_div",
                        "engine"}
    assert row["eager_sps"] > 0 and row["engine"] == "plain-cpu/adv=split"
    rec = full["table"]["jacobi60"]
    assert rec["settings"] == bench3d.settings3(6, False)


def test_reference_check_holds_3d_rows_to_1_percent(cpu_run):
    """A row within 1% passes; any of the four columns pushed 2% off, or
    no row, fails."""
    _, full = cpu_run
    rec = full["table"]["jacobi60"]
    cols = {k: rec[k] for k in (*bench3d.LIMITS3, "settings")}

    def check(**change):
        ref = {"plume3d": {"16": {"jacobi60": {**cols, **change}}}}
        return bench.check_reference({16: {"jacobi60": rec}}, ref,
                                     "plume3d", bench3d.LIMITS3)

    assert check() == []
    assert check(max_div=rec["max_div"] * 1.005) == []
    for col in bench3d.LIMITS3:
        assert check(**{col: rec[col] * 1.02}) == [
            f"plume3d 16 jacobi60 {col}"]
    assert bench.check_reference({16: {"jacobi60": rec}}, {}, "plume3d",
                                 bench3d.LIMITS3)
