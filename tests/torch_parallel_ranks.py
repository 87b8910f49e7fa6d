"""Rank functions of the port's multi-device tests, importable by the ranks
that ``fluidnet_cxx_tpu_torch.parallel.launch.spawn`` starts (gloo on the
CPU, four ranks, one thread each). Each reads its inputs from
``<dir>/inputs.npz`` (numpy, made from a seed by the test) and writes what
it computed to ``<dir>/<name>_r<rank>.npz`` for the test process, which
holds it to the port's single-device results and to JAX. None of this
imports JAX."""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from fluidnet_cxx_tpu_torch.parallel import (
    batch_sharding, gather_state, make_mesh, pad_columns,
    simulate_step3_sharded, simulate_step_sharded, solve_jacobi3_sharded,
    solve_jacobi_sharded, solve_jacobi_tol_sharded, state_sharding)
from fluidnet_cxx_tpu_torch.parallel.mesh import shard
from fluidnet_cxx_tpu_torch.state import SimState
from fluidnet_cxx_tpu_torch.train.trainer import Batch

WORLD = 4
# (dp, sx) meshes of the four ranks.
MESHES = ((1, 4), (2, 2), (4, 1))


def _inputs(d):
    with np.load(os.path.join(d, "inputs.npz")) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def _save(d, name, **arrays):
    np.savez(os.path.join(d, f"{name}_r{dist.get_rank()}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def _raises(exc, fn):
    """The message of ``exc`` raised by ``fn``, else ''."""
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def _mesh(dp, sx):
    return make_mesh(WORLD, dp=dp, sx=sx, backend="gloo", device="cpu")


def mesh_ranks(d):
    """Coordinates and shards on each mesh; the gather round trip; the
    refusals."""
    torch.set_num_threads(1)
    x = _inputs(d)
    out = {}
    default = make_mesh(backend="gloo", device="cpu")
    out["default"] = np.array([default.dp, default.sx, default.dp_index,
                               default.sx_index])
    for dp, sx in MESHES:
        mesh = _mesh(dp, sx)
        key = f"{dp}x{sx}"
        out[f"{key}_coords"] = np.array([mesh.dp_index, mesh.sx_index])
        for name in ("U", "flags", "p"):
            out[f"{key}_{name}"] = shard(mesh, x[name])
        state = SimState(p=x["p"], U=x["U"], flags=x["flags"],
                         density=x["p"] + 1.0)
        back = gather_state(mesh, state_sharding(mesh, state))
        batch = Batch(*(x["U"][:, 0] * k for k in range(7)))
        back_b = gather_state(mesh, batch_sharding(mesh, batch))
        out[f"{key}_roundtrip"] = np.array(
            [torch.equal(a, b) for a, b in zip(back + back_b,
                                               state + batch)
             if b is not None])
        out[f"{key}_uneven"] = np.array(_raises(
            ValueError, lambda: shard(mesh, x["p"][..., :7])) != "" if sx > 1
            else _raises(ValueError, lambda: shard(mesh, x["p"][:3])) != "")
    out["switch"] = np.array(_raises(
        ValueError, lambda: make_mesh(backend="nccl", device="cpu")))
    _save(d, "mesh", **out)


def halo_ranks(d):
    """pad_columns at several reaches; the 2-D and 3-D sharded Jacobi at
    several sweep counts on each mesh with sx > 1; the early exit."""
    torch.set_num_threads(1)
    x = _inputs(d)
    out = {}
    for dp, sx in MESHES[:2]:
        mesh = _mesh(dp, sx)
        key = f"{dp}x{sx}"
        for g in (1, 3, 9, 20):
            (pf, pu), lw, rw = pad_columns(
                mesh, [shard(mesh, x["flags"]), shard(mesh, x["U"])], g)
            out[f"{key}_pad{g}"] = np.array([lw, rw])
            out[f"{key}_pad{g}_flags"] = pf
            out[f"{key}_pad{g}_U"] = pu
        flags, div = shard(mesh, x["flags"]), shard(mesh, x["div"])
        for iters in (0, 5, 8, 17, 34):
            mesh.exchanges = mesh.solver_calls = 0
            p = solve_jacobi_sharded(flags, div, iters, mesh)
            out[f"{key}_jac{iters}"] = gather_state(mesh, p)
            out[f"{key}_jac{iters}_counts"] = np.array(
                [mesh.exchanges, mesh.solver_calls])
        flags3, div3 = shard(mesh, x["flags3"]), shard(mesh, x["div3"])
        for iters in (4, 9, 20):
            p = solve_jacobi3_sharded(flags3, div3, iters, mesh)
            out[f"{key}_jac3_{iters}"] = gather_state(mesh, p)
        p, res = solve_jacobi_tol_sharded(flags, div, 1.078, 300, mesh)
        out[f"{key}_tol"] = gather_state(mesh, p)
        out[f"{key}_tol_res"] = res
    _save(d, "halo", **out)


def _dyadic(state, seed, scale):
    """``state`` with a random U of std ``scale`` in multiples of 1/8 (with
    a dt of 1/4 every back-trace position is exact in any coordinates) and
    a random density in [0, 1)."""
    g = torch.Generator().manual_seed(seed)
    U = torch.round(torch.randn(state.U.shape, generator=g) * scale * 8) / 8
    return state._replace(U=U, density=torch.rand(state.density.shape,
                                                  generator=g))


# The cases whose sharded step must equal the single-device one to the bit.
EXACT = ("dyadic2d", "dyadic2d_fast", "dyadic_d4", "dyadic_cylinder",
         "dyadic_periodic", "dyadic3d")


def step_cases():
    """name -> (mesh (dp, sx), steps, 3-D, cfg, initial global state); the
    test builds the same cases for its references."""
    from fluidnet_cxx_tpu_torch.sim.scenes import (
        create_cylinder_scene, create_plume_scene, cylinder_config,
        plume_config, rayleigh_taylor_config)
    from fluidnet_cxx_tpu_torch.sim.scenes3 import create_plume_scene3

    plume = create_plume_scene(64, 64, batch=2)
    cyl, visc = create_cylinder_scene(res_x=64, res_y=32, center_x=16.0,
                                      radius=4.5)
    one = create_plume_scene(64, 32)
    obst = one.flags.clone()
    g = torch.Generator().manual_seed(3)
    inner = obst[:, 1:-1, 1:-1]
    inner[torch.rand(inner.shape, generator=g) < 0.08] = 2
    one = one._replace(flags=obst)
    cfg3 = plume_config(dt=0.25, jacobi_iter=10, buoyancy_scale=0.5,
                        gravity_vec=(0.0, -1.0, 0.0), line_trace=False,
                        advection_impl="window", max_disp=2)
    p3 = create_plume_scene3(16, 24, 32)
    rough = dict(dt=0.25, jacobi_iter=8, max_disp=2, line_trace=False,
                 vorticity_confinement=0.2)
    return {
        "plume": ((2, 2), 1, False, plume_config(jacobi_iter=20), plume),
        "plume3": ((2, 2), 3, False, plume_config(jacobi_iter=20), plume),
        "fast": ((2, 2), 2, False, plume_config(
            jacobi_iter=20, use_pallas=True), plume),
        "p_tol": ((2, 2), 1, False, plume_config(
            jacobi_iter=100, p_tol=1e-3), plume),
        "cylinder": ((1, 4), 1, False, cylinder_config(visc, jacobi_iter=2),
                     cyl),
        "cylinder3": ((1, 4), 3, False,
                      cylinder_config(visc, jacobi_iter=34), cyl),
        "step3d": ((1, 4), 1, True, cfg3, p3),
        "dyadic2d": ((1, 4), 1, False, plume_config(**rough),
                     _dyadic(one, 4, 12.0)),
        "dyadic2d_fast": ((1, 4), 1, False, plume_config(
            use_pallas=True, **rough), _dyadic(one, 4, 12.0)),
        "dyadic_d4": ((1, 4), 1, False, plume_config(
            **dict(rough, max_disp=4)), _dyadic(one, 5, 20.0)),
        "dyadic_cylinder": ((1, 4), 1, False, cylinder_config(
            visc, dt=0.25, jacobi_iter=8, max_disp=2, line_trace=False),
            _dyadic(cyl, 6, 12.0)),
        "dyadic_periodic": ((1, 4), 1, False, rayleigh_taylor_config(
            dt=0.25, jacobi_iter=8, periodic_x=True, max_disp=2,
            line_trace=False), _dyadic(plume, 7, 4.0)),
        "dyadic3d": ((1, 4), 1, True, dataclasses.replace(
            cfg3, vorticity_confinement=0.2), _dyadic(p3, 8, 6.0)),
    }


def former_refusals():
    """name -> (config changes, project_fn) of the cases the sharded step
    refused before ROADMAP A.8.1, on the plume case."""
    from fluidnet_cxx_tpu_torch.config import ModelConfig
    from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                       random_flax_params)
    from fluidnet_cxx_tpu_torch.models.fluidnet import (make_net,
                                                        make_project_fn)

    net = make_net(ModelConfig())
    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table, 1)))
    return {"multigrid": (dict(sim_method="multigrid"), None),
            "convnet": (dict(sim_method="convnet"),
                        make_project_fn(ModelConfig(), net.eval())),
            "gather": (dict(advection_impl="gather"), None)}


def step_ranks(d):
    """Every case of ``step_cases`` on its mesh; the refusals."""
    torch.set_num_threads(1)
    out = {}
    meshes = {shape: _mesh(*shape) for shape in MESHES}
    with torch.no_grad():
        for name, (shape, steps, three_d, cfg, state) in step_cases().items():
            mesh = meshes[shape]
            step = simulate_step3_sharded if three_d else \
                simulate_step_sharded
            s = state_sharding(mesh, state)
            for _ in range(steps):
                s = step(cfg, s, mesh)
            got = gather_state(mesh, s)
            for field in ("p", "U", "density"):
                out[f"{name}_{field}"] = getattr(got, field)
        cfg = step_cases()["plume"][3]
        state = step_cases()["plume"][4]
        mesh = meshes[(2, 2)]
        s = state_sharding(mesh, state)
        # What the step refused before ROADMAP A.8.1: multigrid, convnet
        # (the tower's projection) and the gather engine under sx > 1.
        for name, (kw, project) in former_refusals().items():
            got = simulate_step_sharded(dataclasses.replace(cfg, **kw), s,
                                        mesh, project)
            out[f"former_{name}_U"] = gather_state(mesh, got.U)
            out[f"former_{name}_p"] = gather_state(mesh, got.p)
        # Under dp alone the multigrid step runs: each rank its batch.
        dp_mesh = meshes[(4, 1)]
        mg = dataclasses.replace(cfg, sim_method="multigrid")
        plume4 = step_cases()["plume"][4]
        plume4 = plume4._replace(**{k: torch.cat([v, v]) for k, v in
                                    plume4._asdict().items()
                                    if v is not None})
        got = simulate_step_sharded(mg, state_sharding(dp_mesh, plume4),
                                    dp_mesh)
        out["dp_multigrid_U"] = gather_state(dp_mesh, got.U)
    _save(d, "step", **out)


def train_ranks(d):
    """``_train_case`` with the long-term loss off, then on."""
    torch.set_num_threads(1)
    for lt in (False, True):
        _train_case(d, lt)


def _train_case(d, lt: bool):
    """A data-parallel train step of FluidNetTower at dp = 4 on the test's
    batch from the test's weights (ranks other than 0 start from other
    weights: the broadcast must replace them), with the test's draw; a
    second step with a per-rank host generator (the draw is shared); the
    refusals."""
    from fluidnet_cxx_tpu_torch.config import (ModelConfig, SimConfig,
                                               TrainConfig)
    from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                       random_flax_params)
    from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_cxx_tpu_torch.sim.step import DynParams
    from fluidnet_cxx_tpu_torch.train import trainer

    x = _inputs(d)
    rank = dist.get_rank()
    mesh = _mesh(4, 1)
    model = FluidNet(ModelConfig())
    tc = TrainConfig(batch_size=4, lt_num_steps=(1, 2), p_l2_lambda=0.3,
                     p_l1_lambda=0.2, div_l1_lambda=0.5,
                     div_lt_lambda=1.0 if lt else 0.0)
    sc = SimConfig(max_disp=2)
    ts = trainer.init_train_state(model, tc, seed=1)
    if rank != 0:
        model.net.load_state_dict(flax_to_state_dict(random_flax_params(
            model.net.table, 10 + rank)))
    train_step, _ = trainer.make_train_step(model, sc, tc, mesh=mesh)
    out = {"init:" + k: p.detach().clone()
           for k, p in model.net.named_parameters()}
    batch = trainer.Batch(*(x["b_" + k] for k in trainer.Batch._fields[:-1]))
    v = x["dyn"].tolist()
    draw = (DynParams(v[0], v[1], v[2], tuple(v[3:6])), int(v[6]))
    ts, terms = train_step(ts, batch_sharding(mesh, batch), draw=draw)
    out["terms"] = torch.stack(list(terms))
    for k, p in model.net.named_parameters():
        out["grad:" + k] = p.grad.clone()
        out["param:" + k] = p.detach().clone()
    host_gen = torch.Generator().manual_seed(100 + rank)
    ts, _ = train_step(ts, batch_sharding(mesh, batch), host_gen)
    if lt:
        dyn, n = train_step.last_draw
        out["draw"] = np.array([dyn.dt, dyn.buoyancy_scale,
                                dyn.gravity_scale, *dyn.gravity_vec, n])
    for k, p in model.net.named_parameters():
        out["param2:" + k] = p.detach().clone()
    masked = batch._replace(div_mask=torch.ones_like(batch.p_div))
    out["refuse_mask"] = np.array(_raises(NotImplementedError, lambda:
                                          train_step(ts, batch_sharding(
                                              mesh, masked), draw=draw)))
    wide = _mesh(2, 2)
    out["refuse_sx"] = np.array(_raises(
        NotImplementedError,
        lambda: trainer.make_train_step(model, sc, tc, mesh=wide)))
    _save(d, f"train_lt{int(lt)}", **out)
