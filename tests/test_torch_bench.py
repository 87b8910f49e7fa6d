"""The port's 2-D bench (``fluidnet_cxx_tpu_torch/bench.py``) on the CPU:
its rollout statistics against the JAX package's
(``scripts/torch_bench_reference.py::plume2d_chunks``, the reference the
card's bench is held to), its command line's one JSON line, and its
``--reference`` check.

The rollouts run 64^2, two chunks of three steps, at max_disp 1 on both
sides (the JAX window engine compiles one roll per offset; at 64^2 the
inlet moves 0.1 cells a step, so the clamp does not bind). Tolerance:
1e-4 relative on mean|div| and max|div| (the steps' tolerance in
``tests/test_torch_step.py``), the height exactly.
"""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu_torch import bench
from fluidnet_cxx_tpu_torch.run_plume import quality

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RES, STEPS, CHUNK, MAX_DISP = 64, 6, 3, 1


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """The JAX reference is compile-bound here; XLA's optimisation passes
    change no result beyond rounding and double its compile time, so this
    module runs without them and restores the setting for the next
    module."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module")
def reference_script():
    """scripts/torch_bench_reference.py as a module."""
    path = ROOT / "scripts" / "torch_bench_reference.py"
    spec = importlib.util.spec_from_file_location("torch_bench_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


@pytest.mark.parametrize("case", ["jacobi28", "cnn", "mg2"])
def test_rollout_stats_match_jax(reference_script, case):
    """Each chunk's mean|div|, max|div| and height, and the reduced
    columns, port (plain versions; trained weights for cnn) against
    JAX's XLA path with the first-hit trace."""
    want = reference_script.plume2d_chunks(case, RES, STEPS, CHUNK,
                                           max_disp=MAX_DISP)
    step, state0, _ = bench.case_setup(case, RES, "cpu", max_disp=MAX_DISP)
    with torch.no_grad():
        _, got = bench.rollout_chunks(step, state0, STEPS, CHUNK, quality)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert _rel(g["mean_div"], w["mean_div"]) < 1e-4, (g, w)
        assert _rel(g["max_div"], w["max_div"]) < 1e-4, (g, w)
        assert g["height"] == w["height"], (g, w)
    rg, rw = bench.reduce_chunks(got), reference_script.reduce_chunks(want)
    for col in ("mean_div", "max_div"):
        assert _rel(rg[col], rw[col]) < 1e-4
    assert rg["height"] == rw["height"]
    assert bench.settings(case, STEPS, CHUNK, MAX_DISP, True) == \
        reference_script.settings2d(case, STEPS, CHUNK, MAX_DISP)


ARGV = ["--device", "cpu", "--res", "32", "--cases", "jacobi28",
        "--small-steps", "4", "--chunk", "2", "--n-eager", "2", "--reps", "1"]


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """One run of the bench's main on the CPU: (its stdout's last line,
    the full table it wrote, its out dir)."""
    out_dir = tmp_path_factory.mktemp("bench")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(ARGV + ["--out-dir", str(out_dir)])
    (path,) = out_dir.glob("bench_torch_*.json")
    with open(path) as f:
        full = json.load(f)
    return buf.getvalue().strip().splitlines()[-1], full, out_dir


def test_main_on_cpu_prints_one_compact_json_line(cpu_run):
    """One JSON line of at most 1.5 KB with bench.py's keys; no graph on
    the CPU (``"graph": null``, the clock says why), times from the host
    clock, the plain versions' engine."""
    line, full, _ = cpu_run
    assert len(line.encode()) <= 1500
    out = json.loads(line)
    for key in ("metric", "value", "unit", "device", "weights", "graph",
                "proj_ms", "proj_mfu", "engine", "sps_32", "eager_32",
                "maxdiv_32", "eager_n", "reference"):
        assert key in out, key
    assert out["metric"] == "plume_32_jacobi28_steps_per_sec"
    assert out["graph"] is None and out["value"] is None
    assert "no graph" in out["clock"] and out["device"] == "cpu"
    assert out["eager_32"]["jacobi28"] > 0 and out["eager_n"] == {"32": 2}
    assert out["engine"] == {"jacobi28": "plain-cpu/adv=merged"}
    rec = full["table"]["32"]["jacobi28"]
    assert len(rec["chunks"]) == 2 and rec["launches_per_step"] == {}
    assert rec["max_div"] == max(c["max_div"] for c in rec["chunks"][1:])


def test_reference_check_holds_rows_to_their_limits(cpu_run):
    """A row within its limits passes; mean|div| or max|div| pushed 2%
    off, the height 2 rows off, a row at other settings or no row at all
    fails; and main exits non-zero on a failing reference."""
    _, full, out_dir = cpu_run
    table = {32: full["table"]["32"]}
    rec = table[32]["jacobi28"]
    cols = {k: rec[k] for k in ("mean_div", "max_div", "height",
                                "settings")}

    def ref_with(**change):
        return {"plume2d": {"32": {"jacobi28": {**cols, **change}}}}

    assert bench.check_reference(table, ref_with()) == []
    assert bench.check_reference(
        table, ref_with(max_div=rec["max_div"] * 1.005)) == []
    assert bench.check_reference(table, ref_with(height=rec["height"] + 1)) \
        == []
    for change in (dict(mean_div=rec["mean_div"] * 1.02),
                   dict(max_div=rec["max_div"] / 1.02),
                   dict(height=rec["height"] - 2),
                   dict(settings={**rec["settings"], "max_disp": 2})):
        assert bench.check_reference(table, ref_with(**change)), change
    assert bench.check_reference(table, {"plume2d": {}})

    bad = out_dir / "bad_reference.json"
    bad.write_text(json.dumps(ref_with(max_div=rec["max_div"] * 1.02)))
    with pytest.raises(SystemExit, match="reference check failed"):
        bench.main(ARGV + ["--out-dir", str(out_dir), "--reference",
                           str(bad)])


def test_committed_reference_holds_the_required_rows():
    """bench_reference.json has the five 2-D cases at 128^2 (400 steps)
    and 512^2 (300 steps), the 3-D classical row at 128^3 and 64^3, the
    multigrid row (mg2v) at 64^3 and the learned rows' float32 variant at
    64^3 and 128^3 (60 steps), each at the benches' default settings, the
    2-D rows with their JAX command and commit."""
    ref = bench.load_reference(bench.REFERENCE)
    for res, steps in (("128", 400), ("512", 300)):
        for case in bench.CASES:
            row = ref["plume2d"][res][case]
            assert row["settings"] == bench.settings(case, steps, 100, 4,
                                                     True), (res, case)
            assert np.isfinite(row["mean_div"]) and row["height"] > 0
            assert "torch_bench_reference.py" in row["command"]
            assert row["jax_package_commit"]
    for res, case in (("128", "jacobi60"), ("128", "PUNet3p8_64-float32"),
                      ("128", "PUNet3_32-float32"), ("64", "mg2v"),
                      ("64", "jacobi60"),
                      ("64", "PUNet3p8_64-float32"),
                      ("64", "PUNet3_32-float32")):
        assert ref["plume3d"][res][case]["settings"] == {
            "steps": 60, "max_disp": 2, "line_trace": False}, (res, case)
