"""Rank functions of ``tests/test_torch_parallel_project.py``: the
width-sharded V-cycles and learned projections (gloo on the CPU, four
ranks at sx = 4, one thread each), importable by the ranks that
``fluidnet_cxx_tpu_torch.parallel.launch.spawn`` starts. ``project_ranks``
writes what it computed to ``<dir>/project_r<rank>.npz``. None of this
imports JAX."""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from fluidnet_cxx_tpu_torch.parallel.project import OUT_HALO, sharding_of
from fluidnet_cxx_tpu_torch.parallel import (gather_state, make_mesh,
                                             simulate_step3_sharded,
                                             simulate_step_sharded,
                                             state_sharding)

WORLD = 4


def _obstacles(state, seed, share=0.08):
    """``state`` with ``share`` random obstacles inside the border."""
    flags = state.flags.clone()
    g = torch.Generator().manual_seed(seed)
    inner = flags[..., 1:-1, 1:-1]
    inner[torch.rand(inner.shape, generator=g) < share] = 2
    return state._replace(flags=flags)


def _dyadic(state, seed, scale):
    """A random U of std ``scale`` in multiples of 1/8 and a random
    density: at dt 1/4 every back-traced position is exact in any
    coordinates."""
    g = torch.Generator().manual_seed(seed)
    U = torch.round(torch.randn(state.U.shape, generator=g) * scale * 8) / 8
    return state._replace(U=U, density=torch.rand(state.density.shape,
                                                  generator=g))


def _seeded(net, seed=1):
    from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                       random_flax_params)

    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table,
                                                              seed)))
    return net.eval()


# The small nets of the learned cases.
PUNET = dict(model="PUNet", punet_patch=2, punet_widths=(8, 8),
             punet_bottleneck_dilation=2, polish_sweeps=4)
PUNET3 = dict(model="PUNet3", punet_patch=2, punet_widths=(8, 8),
              punet_bottleneck_convs=1, polish_sweeps=4)


def projection(name):
    """The project_fn of a learned case (seed weights), or None."""
    from fluidnet_cxx_tpu_torch.config import ModelConfig
    from fluidnet_cxx_tpu_torch.models import fluidnet as fn
    from fluidnet_cxx_tpu_torch.models import punet3d
    from fluidnet_cxx_tpu_torch.models.mg_coarse import (
        MGCoarseNet, init_mg_coarse_params, make_project_fn_mg_learned)

    if name == "mg_learned":
        net = init_mg_coarse_params(MGCoarseNet(), 1).eval()
        return make_project_fn_mg_learned(net, coarse_size=256)
    if name in ("punet_fused", "punet_mg", "punet_mg0"):
        # punet_mg0: the "mg" polish with no polish sweeps, which the fused
        # forward runs all the same.
        cfg = ModelConfig(**dict(PUNET, polish_sweeps=0 if name.endswith(
            "0") else 4), polish_impl=name[6:].rstrip("0"))
        return fn.make_project_fn_fused_forward(cfg, _seeded(fn.make_net(cfg)))
    if name in ("tower", "scalenet"):
        cfg = ModelConfig(model="FluidNet" if name == "tower"
                          else "ScaleNet")
        return fn.make_project_fn(cfg, _seeded(fn.make_net(cfg)))
    if name in ("punet3_fused", "punet3_raw"):
        # punet3_raw: without the input's normalisation.
        cfg = ModelConfig(**PUNET3, polish_impl="fused",
                          normalize_input=name == "punet3_fused")
        net = punet3d.PUNet3.from_config(cfg, "fused")
        return punet3d.make_project_fn3_fused_forward(
            cfg, punet3d.init_params3(net, 1).eval())
    if name == "fluidnet3":
        cfg = ModelConfig(**PUNET3, polish_impl="xla")
        net = punet3d.PUNet3.from_config(cfg, "flax")
        return punet3d.make_project_fn3(cfg,
                                        punet3d.init_params3(net, 1).eval())
    return None


def project_cases():
    """name -> (steps, 3-D, cfg, initial global state); the test builds
    the same cases (and ``projection(name)``) for its references."""
    from fluidnet_cxx_tpu_torch.sim.scenes import (
        create_plume_scene, create_rayleigh_taylor_scene, plume_config,
        rayleigh_taylor_config)
    from fluidnet_cxx_tpu_torch.sim.scenes3 import create_plume_scene3

    wide = _obstacles(create_plume_scene(512, 32), 5)
    plume = create_plume_scene(128, 32)
    rt = create_rayleigh_taylor_scene(512, 32)
    conv = plume_config(sim_method="convnet")
    p3 = create_plume_scene3(16, 16, 16)
    cfg3 = plume_config(dt=0.25, buoyancy_scale=0.5, max_disp=2,
                        gravity_vec=(0.0, -1.0, 0.0), line_trace=False,
                        advection_impl="window")
    rough = dict(dt=0.25, jacobi_iter=8, max_disp=2, line_trace=False,
                 vorticity_confinement=0.2, advection_impl="gather")
    return {
        "mg_H": (2, False, plume_config(sim_method="multigrid"), wide),
        "mg_G": (1, False, rayleigh_taylor_config(
            sim_method="multigrid", periodic_x=True), rt),
        "mg_learned": (1, False, conv, wide),
        "punet_fused": (1, False, conv, plume),
        "punet_mg": (1, False, conv, wide),
        "punet_mg0": (1, False, conv, wide),
        "tower": (1, False, conv, plume),
        "scalenet": (1, False, conv, plume),
        "gather": (1, False, plume_config(**rough),
                   _dyadic(_obstacles(create_plume_scene(64, 32), 3), 4,
                           12.0)),
        "mg3": (1, True, dataclasses.replace(cfg3, sim_method="multigrid"),
                create_plume_scene3(16, 16, 32)),
        "punet3_fused": (1, True, dataclasses.replace(
            cfg3, sim_method="convnet"), p3),
        "punet3_raw": (1, True, dataclasses.replace(
            cfg3, sim_method="convnet"), p3),
        "fluidnet3": (1, True, dataclasses.replace(
            cfg3, sim_method="convnet"), p3),
    }


# The cases whose sharded step must equal the single-device one to the bit.
EXACT = ("gather",)


# The learned cases whose reach ``reach_moved`` holds.
REACH = ("punet_fused", "punet_mg", "punet_mg0", "tower", "scalenet",
         "punet3_fused", "punet3_raw", "fluidnet3")


def reach_moved(name, seed=29, short=0):
    """The projection of case ``name`` on rank 0's slab at sx = 4 with its
    halo and ``align`` more columns each side (taken around the grid), run
    again with every input column beyond the halo perturbed (p, U,
    density, and 10% of the fluid cells made obstacles): the largest
    change of the owned columns' p and of U's owned columns and OUT_HALO
    more (the net's own output before the sharded "mg" polish). The scale
    is fixed at 1; the sharded step hands in the global one. ``short``:
    take the halo that many alignments narrower."""
    state = project_cases()[name][3]
    project = projection(name)
    sh = sharding_of(project)
    W = state.flags.shape[-1]
    wl, e, g = W // WORLD, sh.align, sh.halo - short * sh.align
    cols = torch.remainder(torch.arange(-g - e, wl + g + e), W)
    sl = lambda t: t.index_select(-1, cols).contiguous()  # noqa: E731
    p, U, flags, density = (sl(t) for t in (state.p, state.U, state.flags,
                                            state.density))
    kw = dict(scale=torch.ones(p.shape[0]))
    if sh.kind == "fused3":
        kw["grid"] = tuple(state.flags.shape[1:])
    if sh.polish == "mg":
        kw["net_only"] = True
    gen = torch.Generator().manual_seed(seed)
    far = torch.ones(cols.numel(), dtype=torch.bool)
    far[e:e + 2 * g + wl] = False
    flip = (torch.rand(flags.shape, generator=gen) < 0.1) & (flags == 1) & far
    moved = (p + far * torch.randn(p.shape, generator=gen),
             U + far * torch.randn(U.shape, generator=gen),
             flags.masked_fill(flip, 2),
             density + far * torch.rand(density.shape, generator=gen))
    a, b = e + g, e + g + wl
    with torch.no_grad():
        outs = [project(*args, **kw)
                for args in ((p, U, flags, density), moved)]
    if sh.polish == "mg":
        return float((outs[0] - outs[1])[..., a:b].abs().max())
    (p0, U0), (p1, U1) = outs
    return max(float((p0 - p1)[..., a:b].abs().max()),
               float((U0 - U1)[..., a - OUT_HALO:b + OUT_HALO].abs().max()))


def dp_mg_inputs():
    """Four 32x512 flags and RHS of the mg_H scene (a batch for dp = 4)."""
    flags = project_cases()["mg_H"][3].flags.expand(WORLD, -1, -1)
    div = torch.randn(flags.shape, generator=torch.Generator().manual_seed(9))
    return flags.contiguous(), div


def dp_coarse_fn(flags_c, rhs_c):
    """A stand-in learned coarse solve: damped Jacobi from zero."""
    from fluidnet_cxx_tpu_torch.ops.jacobi import solve_jacobi_fixed

    return solve_jacobi_fixed(flags_c, rhs_c, 6, damping=0.8)


def _raises(exc, fn):
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def project_ranks(d):
    """Every case of ``project_cases`` at sx = 4; each rank's gathered
    coarse solves (the tail's output); the refusals."""
    from fluidnet_cxx_tpu_torch.ops.kernels import mg as mgk
    from fluidnet_cxx_tpu_torch.parallel import multigrid as pm

    torch.set_num_threads(1)
    mesh = make_mesh(WORLD, dp=1, sx=WORLD, backend="gloo", device="cpu")
    out = {}
    tails = []
    tail_solve = mgk.tail_solve

    def recorded(*args, **kw):
        e = tail_solve(*args, **kw)
        tails.append(e.clone())
        return e

    with torch.no_grad():
        for name, (steps, three_d, cfg, state) in project_cases().items():
            step = simulate_step3_sharded if three_d else \
                simulate_step_sharded
            project = projection(name)
            s = state_sharding(mesh, state)
            pm.mgk.tail_solve = recorded
            try:
                for _ in range(steps):
                    s = step(cfg, s, mesh, project)
            finally:
                pm.mgk.tail_solve = tail_solve
            got = gather_state(mesh, s)
            for field in ("p", "U", "density"):
                out[f"{name}_{field}"] = getattr(got, field)
        out["tails"] = torch.cat([t.reshape(-1) for t in tails])
        out["halo_punet"] = np.array(sharding_of(projection(
            "punet_fused")).halo)
        # The refusals.
        cfg, state = project_cases()["tower"][2:]
        s = state_sharding(mesh, state)
        out["refuse_attr"] = np.array(_raises(ValueError, lambda: (
            simulate_step_sharded(cfg, s, mesh, lambda *a, **k: a[:2]))))
        odd = state_sharding(mesh, state._replace(
            **{k: v[..., :120] for k, v in state._asdict().items()
               if v is not None}))
        out["refuse_align"] = np.array(_raises(ValueError, lambda: (
            simulate_step_sharded(cfg, odd, mesh, projection("punet_fused")))))
        flags = state_sharding(mesh, project_cases()["mg_H"][3].flags[
            ..., :484])
        out["refuse_mg"] = np.array(_raises(ValueError, lambda: (
            pm.solve_mg_sharded(mesh, flags, torch.zeros(flags.shape)))))
        # Under dp alone (sx = 1): the single-device solves of each
        # rank's batch entry.
        dp = make_mesh(WORLD, dp=WORLD, sx=1, backend="gloo", device="cpu")
        flags, div = dp_mg_inputs()
        i = dist.get_rank()
        out["dp_mg"] = pm.solve_mg_sharded(dp, flags[i:i + 1],
                                           div[i:i + 1])
        out["dp_mg_learned"] = pm.solve_mg_learned_sharded(
            dp, flags[i:i + 1], div[i:i + 1], dp_coarse_fn,
            coarse_size=256)
    np.savez(os.path.join(d, f"project_r{dist.get_rank()}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
