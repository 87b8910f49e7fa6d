#!/usr/bin/env python3
"""Quality reference of the PyTorch port's benches, from the JAX package on
the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_bench_reference.py
    JAX_PLATFORMS=cpu python scripts/torch_bench_reference.py \\
        --rows plume2d:512:jacobi28 plume3d:128:PUNet3p8_64-float32

Each row runs one case of ``fluidnet_cxx_tpu_torch/bench.py`` (2-D) or
``fluidnet_cxx_tpu_torch/bench3d.py`` (3-D) on the JAX package's XLA path
(``use_pallas=False``: the plain versions the port's kernels are held to)
and merges its quality columns, its settings, the command, the JAX
package's commit and the seconds it took into ``--out``
(``fluidnet_cxx_tpu_torch/bench_reference.json``), which the benches'
``--reference`` reads. Rows:

* ``plume2d:<res>:<case>``, case cnn, jacobi28, jacobi100, jacobi200 or
  mg2: ``bench.py``'s scene and rollout (300 steps at 512^2, 400 below, in
  chunks of 100, the first left out) with ``line_trace_impl="firsthit"``,
  the trace the port runs (off the TPU the JAX step would run ``march``);
  cnn with the trained PUNetD2_128 read by the JAX loader. mean|div|,
  max|div| and the plume height, as ``bench.py::run_case``.
* ``plume3d:<res>:jacobi60``: ``scripts/bench3d.py``'s classical row
  (separate advection, no trace, max_disp 2), 60 steps from t = 0 (6n at
  bench3d's n = 10). ``plume3d:<res>:mg2v``: its "pallas + multigrid" row
  (``solve_mg3``, 2 V-cycles, the step's depth cap of 3 levels and 8 post
  sweeps). ``plume3d:<res>:<model>-float32``: its learned row
  with the trained ``trained_models/<model>`` in float32 on both sides:
  in bfloat16 the flax PUNet3 rounds every conv's output, the port's (and
  the fused TPU kernel's) up conv and head keep float32 (ROADMAP C.5), so
  only a float32-compute variant compares the two at the columns' 1%.
  max|div| over interior cells, mean|div| over fluid cells, the density
  sum and max|U|.

The default rows are the five 2-D cases at 128^2 (~2 min each here), cnn
at 512^2 and the 3-D classical row at 128^3. Needs JAX; the port never
imports it. ``tests/test_torch_bench.py`` imports ``plume2d_chunks`` and
``plume3d_quality`` to hold the port's rollouts to them at small sizes.
"""
import argparse
import fcntl
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax
import jax.numpy as jnp
import numpy as np

OUT = os.path.join(ROOT, "fluidnet_cxx_tpu_torch", "bench_reference.json")
CASES2D = {"cnn": dict(sim_method="convnet"),
           "jacobi28": dict(sim_method="jacobi", jacobi_iter=28),
           "jacobi100": dict(sim_method="jacobi", jacobi_iter=100),
           "jacobi200": dict(sim_method="jacobi", jacobi_iter=200),
           "mg2": dict(sim_method="multigrid", mg_vcycles=2)}
DEFAULT_ROWS = [f"plume2d:128:{c}" for c in CASES2D] + [
    "plume2d:512:cnn", "plume3d:128:jacobi60"]


def rollout2d(res):
    """bench.py's rollout: 300 steps at 512^2, 400 below."""
    return 300 if res >= 512 else 400


def settings2d(case, steps, chunk, max_disp=4, line_trace=True):
    """The settings a 2-D row is computed at (``bench.py``'s
    ``settings`` builds the same dict)."""
    return {"steps": steps, "chunk": chunk, "max_disp": max_disp,
            "line_trace": line_trace,
            "weights": "trained" if case == "cnn" else None}


def settings3d(steps, max_disp=2, line_trace=False):
    """The settings a 3-D row is computed at (``bench3d.py``'s
    ``settings``)."""
    return {"steps": steps, "max_disp": max_disp, "line_trace": line_trace}


def plume2d_chunks(case, res, steps, chunk, max_disp=4, line_trace=True,
                   params=None):
    """bench.py's run_case rollout on JAX's XLA path: ``max(steps //
    chunk, 1)`` chunks of ``chunk`` steps from t = 0; after each, mean|div|
    and max|div| over the fluid cells outside the inlet rows and the
    plume height. Returns one dict a chunk. cnn runs the trained
    PUNetD2_128 unless ``params`` (a flax param tree) is given."""
    from fluidnet_cxx_tpu import ops
    from fluidnet_cxx_tpu.sim import (create_plume_scene, plume_config,
                                      simulate_step)

    project = None
    if case == "cnn":
        from fluidnet_cxx_tpu.models import FluidNet, make_project_fn
        from fluidnet_cxx_tpu.train.checkpoint import load_model_config
        from torch_convert_checkpoints import flax_params

        mcfg = load_model_config(os.path.join(ROOT, "trained_models",
                                              "PUNetD2_128"))
        if params is None:
            params = {"params": {"PUNet_0": flax_params("PUNetD2_128")}}
        project = make_project_fn(FluidNet(mcfg), params)
    cfg = plume_config(dt=0.1, line_trace=line_trace,
                       line_trace_impl="firsthit", max_disp=max_disp,
                       use_pallas=False, fuse_advection=True,
                       **CASES2D[case])
    state = create_plume_scene(res, res, density_val=0.1,
                               u_scale=2.0 * res / 128.0, rad=0.145)
    fl = (state.flags == 1) & (state.U_bc_inv_mask[:, 1] > 0.5)

    @jax.jit
    def run_chunk(s):
        s, _ = jax.lax.scan(
            lambda c, _: (simulate_step(cfg, c, project_fn=project), None),
            s, None, length=chunk)
        div = jnp.abs(ops.velocity_divergence(s.U, s.flags)) * fl
        rho = s.density[0]
        present = jnp.max(rho, axis=1) > 0.05 * jnp.max(rho)
        height = jnp.max(jnp.where(present, jnp.arange(rho.shape[0]), 0))
        return s, jnp.sum(div) / jnp.sum(fl), jnp.max(div), height

    out = []
    for _ in range(max(steps // chunk, 1)):
        state, mean_div, max_div, height = run_chunk(state)
        out.append({"mean_div": float(mean_div), "max_div": float(max_div),
                    "height": int(height)})
    return out


def reduce_chunks(chunks):
    """bench.py's columns: the first chunk left out when there are more,
    the mean of the means, the max of the maxes, the last height."""
    kept = chunks[1:] if len(chunks) > 1 else chunks
    return {"mean_div": float(np.mean([c["mean_div"] for c in kept])),
            "max_div": float(np.max([c["max_div"] for c in kept])),
            "height": chunks[-1]["height"]}


def plume3d_quality(case, res, steps, max_disp=2, line_trace=False):
    """bench3d's case (jacobi<N>, mg<N>v for the multigrid row with N
    V-cycles, or <model>-float32 for the learned row)
    after ``steps`` steps from t = 0 on JAX's XLA path: max|div| over
    interior cells, mean|div| over fluid cells, the density sum and
    max|U|."""
    import dataclasses

    from fluidnet_cxx_tpu.ops import ops3d
    from fluidnet_cxx_tpu.sim import plume_config
    from fluidnet_cxx_tpu.sim.scenes3 import create_plume_scene3
    from fluidnet_cxx_tpu.sim.step3d import simulate_step3

    kw = dict(dt=0.25, buoyancy_scale=0.5, gravity_vec=(0.0, -1.0, 0.0),
              line_trace=line_trace, max_disp=max_disp,
              advection_impl="window", use_pallas=False,
              fuse_advection=False)
    project = None
    if case.startswith("jacobi"):
        cfg = plume_config(jacobi_iter=int(case[len("jacobi"):]), **kw)
    elif case.startswith("mg") and case.endswith("v"):
        cfg = plume_config(sim_method="multigrid",
                           mg_vcycles=int(case[2:-1]), **kw)
    else:
        from fluidnet_cxx_tpu.models.punet3d import (FluidNet3,
                                                      make_project_fn3)
        from fluidnet_cxx_tpu.train.checkpoint import load_model_config
        from torch_convert_checkpoints import flax_params

        model, dtype = case.rsplit("-", 1)
        if dtype != "float32":
            raise ValueError(f"{case}: only the float32 variant of a "
                             "learned row compares with the port")
        mcfg = dataclasses.replace(
            load_model_config(os.path.join(ROOT, "trained_models", model)),
            compute_dtype=dtype, polish_impl="xla")
        project = make_project_fn3(
            FluidNet3(mcfg), {"params": {"PUNet3_0": flax_params(model)}})
        cfg = plume_config(sim_method="convnet", **kw)
    state = create_plume_scene3(res, res, res, density_val=0.1,
                                u_scale=0.6 * res / 64.0)

    @jax.jit
    def run(s):
        return jax.lax.scan(
            lambda c, _: (simulate_step3(cfg, c, project_fn=project), None),
            s, None, length=steps)[0]

    state = run(state)
    div = jnp.abs(ops3d.velocity_divergence3(state.U, state.flags))
    fluid = state.flags == 1
    return {"max_div": float(div.max()),
            "mean_div": float(jnp.sum(div * fluid) / jnp.sum(fluid)),
            "density_sum": float(state.density.sum()),
            "max_U": float(jnp.abs(state.U).max())}


def compute_row(row):
    """(kind, res, case, the row's record) of one row id."""
    kind, res, case = row.split(":")
    res = int(res)
    t0 = time.perf_counter()
    if kind == "plume2d":
        steps, chunk = rollout2d(res), 100
        chunks = plume2d_chunks(case, res, steps, chunk)
        rec = {**reduce_chunks(chunks), "chunks": chunks,
               "settings": settings2d(case, steps, chunk)}
    elif kind == "plume3d":
        steps = 60
        rec = {**plume3d_quality(case, res, steps),
               "settings": settings3d(steps)}
    else:
        raise ValueError(f"unknown row kind {kind!r}")
    rec["seconds"] = round(time.perf_counter() - t0, 1)
    return kind, str(res), case, rec


def merge(path, kind, res, case, rec, command):
    """Add one row to the JSON at ``path`` under an exclusive lock (rows
    may be computed by processes running side by side)."""
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    with open(path, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        text = f.read()
        ref = json.loads(text) if text.strip() else {
            "source": "scripts/torch_bench_reference.py",
            "backend": "JAX on the CPU, XLA path (use_pallas=False)"}
        rec = dict(rec, command=command, jax_package_commit=commit,
                   jax=jax.__version__)
        ref.setdefault(kind, {}).setdefault(res, {})[case] = rec
        f.seek(0)
        f.truncate()
        json.dump(ref, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", nargs="+", default=DEFAULT_ROWS)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    for row in args.rows:
        kind, res, case, rec = compute_row(row)
        merge(args.out, kind, res, case, rec, "JAX_PLATFORMS=cpu python "
              f"scripts/torch_bench_reference.py --rows {row}")
        cols = {k: v for k, v in rec.items() if k not in ("chunks",)}
        print(f"{row}: {json.dumps(cols)}", flush=True)


if __name__ == "__main__":
    main()
