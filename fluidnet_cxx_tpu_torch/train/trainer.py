"""Training (the port of the JAX package's ``train/trainer.py``): the
5-term loss with the long-term divergence rollout, Adam with the
reduce-on-plateau scale on its learning rate, the dataset, on-device and
mixed train steps and the rollout-frame collector.

Semantics as in JAX (the reference's ``fluid_net_train.py``): the
short-term losses on the model's projection of a divergent frame; the
long-term loss rolls the simulator forward ``n`` steps (``lt_num_steps[0]``
with probability ``lt_probability``, else ``lt_num_steps[1]``) without
gradient, under randomised physics (dt scaled by 0.2028 + |N(0,1)| sigma,
a random buoyancy scale and cardinal direction, no gravity) on a zero
density with ``advect_density`` off, projecting with the current weights,
then takes one differentiable projection of the rolled state and its
MSE(div, 0). The rollout runs exactly ``n`` steps: JAX's masked scan over
``max(lt_num_steps)`` gives the same state. The draw (``_sample_dyn``)
comes from a CPU generator on the host, so the rollout's trip count needs
no device sync.

On a CUDA tensor every conv of the loss runs on kernel B, its backward on
``fn_conv2d_dgrad`` (input gradient, stride 1 or 2, split at PUNet's skip
concat) and ``fn_conv2d_wgrad`` (weights), or for a bfloat16 net
(``computeDtype: bfloat16``) on ``fn_conv2d_bf16_dgrad``,
``fn_conv2d_bf16_wgrad`` and ``fn_bias_grad_bf16``
(``ops/kernels/punet.py::ConvNHWC``); the damped polish is kernel F
forward and ``fn_jacobi_adjoint`` backward (``ops/kernels/jacobi.py::
JacobiPolish``); the LT rollout's velocity advection is kernel E at the
drawn dt, the synthetic labels kernel F, the plume frames' steps kernels
A and F. ``check_trainable`` refuses on the card what has no backward
there: the "fused" and "mg" polish tails (JAX does not differentiate them
either) and a float32 PUNet3; on the CPU the plain versions run.

Data-parallel training (the twin of the JAX package's train step over a
dp mesh, ``tests/test_parallel.py:62-93``): ``make_train_step(...,
mesh=mesh)`` broadcasts the parameters from the dp group's first rank;
each rank passes its shard of the batch (``parallel/mesh.py::
batch_sharding``); after the backward the gradients are all-reduced over
dp (one call on the flattened gradients) and divided by dp, so each
rank's Adam takes the same step and the parameters stay equal to the bit
across ranks; the loss terms are all-reduced to the global means, and the
total is what the plateau sees on every rank; the long-term rollout's draw
is the first rank's, broadcast. The mean of the ranks' means is the
single-device mean over the whole batch: the shards are equal, and a
``div_mask`` (whose masked means do not average so) raises. Width-sharded
training (sx > 1) raises ``NotImplementedError``; it and the on-device
and mixed steps under a mesh are ROADMAP A.8.2.

3-D training (``scripts/train3d.py``'s, ``make_train_step3``):
``loss3``, the mean squared divergence of FluidNet3's projection (the
masked mean on rollout frames), plain Adam, batches of
``data/synthetic3.py``, optionally mixed with ``collect_rollout_frames3``'s
plume frames. On a CUDA tensor every conv runs on kernel N's flax route,
its backward on ``fn_conv3d_dgrad`` and ``fn_conv3d_wgrad``
(``ops/kernels/punet3.py::ConvNDHWC``), the damped polish on kernel I
forward and ``fn_jacobi3_adjoint`` backward (``ops/kernels/jacobi3.py::
JacobiPolish3``), the labels on kernel I and the frames' steps on kernels
L and I.
"""
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig, SimConfig, TrainConfig
from ..data.synthetic import generate_batch
from ..data.synthetic3 import generate_batch3
from ..models.convert import flax_to_state_dict, random_flax_params
from ..models.fluidnet import FluidNet
from ..ops.kernels.jacobi import solve_jacobi
from ..ops.kernels.jacobi3 import solve_jacobi3
from ..ops.kernels.punet import pack_weights
from ..ops.kernels.punet3 import pack_weights3
from ..ops.ops3d import (set_wall_bcs3, velocity_divergence3,
                         velocity_update3)
from ..ops.stencils import (set_wall_bcs, set_wall_bcs_stick,
                            velocity_divergence, velocity_update)
from ..sim.step import DynParams, simulate_step
from ..sim.step3d import simulate_step3
from ..state import SimState
from .losses import LossTerms, long_term_loss, short_term_losses


class Batch(NamedTuple):
    """One training batch: divergent inputs and projected targets.
    ``div_mask`` (optional, (b, h, w)) excludes cells from the divergence
    losses (train/losses.py)."""
    p_div: torch.Tensor      # (b, h, w)
    U_div: torch.Tensor      # (b, 2, h, w)
    flags: torch.Tensor      # (b, h, w) int32
    density_div: torch.Tensor
    p_target: torch.Tensor
    U_target: torch.Tensor
    density_target: torch.Tensor
    div_mask: Optional[torch.Tensor] = None


class Plateau:
    """optax's ``contrib.reduce_on_plateau`` (optax 0.2.6; atol 0, no
    cooldown, min_scale 0), float32 like its state: the mean of the last
    ``accumulation_size`` losses, once that many have come, either improves
    on the best by more than ``rtol`` of it, or adds one to the plateau
    count; at ``patience`` the scale is multiplied by ``factor`` and the
    count restarts. ``update(value)`` returns the scale after this value,
    the one that multiplies this step's update. The running mean stays a
    tensor on the loss's device: the host reads it only when the count
    completes."""

    def __init__(self, factor: float, patience: int, rtol: float,
                 accumulation_size: int = 1):
        self.factor, self.patience = factor, patience
        self.rtol, self.accumulation_size = rtol, accumulation_size
        self.scale = np.float32(1.0)
        self.best_value = np.float32(np.inf)
        self.plateau_count = 0
        self.count = 0
        self.avg_value = None

    def update(self, value) -> float:
        value = value.detach().to(torch.float32)
        count, self.count = self.count, self.count + 1
        prev = self.avg_value if self.avg_value is not None else \
            torch.zeros_like(value)
        self.avg_value = (count * prev + value) / self.count
        if self.count == self.accumulation_size:
            avg = np.float32(self.avg_value.item())
            improved = avg < (np.float32(1 - self.rtol) * self.best_value
                              - np.float32(0.0))
            if improved:
                self.best_value, self.plateau_count = avg, 0
            else:
                self.plateau_count += 1
            if self.plateau_count == self.patience:
                self.scale = np.float32(self.scale * np.float32(self.factor))
                self.plateau_count = 0
            self.count, self.avg_value = 0, None
        return float(self.scale)

    def state_dict(self):
        return {"scale": float(self.scale),
                "best_value": float(self.best_value),
                "plateau_count": self.plateau_count, "count": self.count,
                "avg_value": self.avg_value}

    def load_state_dict(self, d):
        self.scale = np.float32(d["scale"])
        self.best_value = np.float32(d["best_value"])
        self.plateau_count, self.count = d["plateau_count"], d["count"]
        self.avg_value = d["avg_value"]


class Optimizer:
    """Adam (``torch.optim.Adam``, optax's defaults: betas 0.9, 0.999,
    eps 1e-8) whose learning rate is ``lr`` times the plateau's scale, as
    ``optax.chain(adam(lr), reduce_on_plateau(...))`` scales Adam's
    update."""

    def __init__(self, params, cfg: TrainConfig, steps_per_epoch: int = 1):
        self.lr = cfg.lr
        self.adam = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                     eps=1e-8)
        self.plateau = Plateau(cfg.plateau_factor, cfg.plateau_patience,
                               cfg.plateau_threshold,
                               max(steps_per_epoch, 1))

    def step(self, value):
        """One update with the gradients in the parameters; ``value`` is
        this step's loss (the plateau's input)."""
        scale = self.plateau.update(value)
        for group in self.adam.param_groups:
            group["lr"] = self.lr * scale
        self.adam.step()

    def state_dict(self):
        return {"adam": self.adam.state_dict(),
                "plateau": self.plateau.state_dict()}

    def load_state_dict(self, d):
        self.adam.load_state_dict(d["adam"])
        self.plateau.load_state_dict(d["plateau"])


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), their optimizer and the step count."""
    model: FluidNet
    optimizer: Optimizer
    step: int = 0


def make_optimizer(cfg: TrainConfig, model, steps_per_epoch: int = 1):
    """Adam + reduce-on-plateau over ``model``'s parameters. The reference
    steps its plateau scheduler once per epoch on the epoch-mean train
    loss: ``steps_per_epoch`` is the plateau's accumulation size."""
    return Optimizer(model.parameters(), cfg, steps_per_epoch)


def init_params(model: FluidNet, seed: int = 0):
    """flax's initialisation of ``model``'s network from a numpy seed:
    lecun-normal kernels, zero biases (``models/convert.py``)."""
    dev = next(model.parameters()).device
    sd = flax_to_state_dict(random_flax_params(model.net.table, seed))
    model.net.load_state_dict({k: v.to(dev) for k, v in sd.items()})


def init_train_state(model: FluidNet, cfg: TrainConfig, seed: int = 0,
                     steps_per_epoch: int = 1):
    init_params(model, seed)
    return TrainState(model, make_optimizer(cfg, model, steps_per_epoch))


def check_trainable(mcfg: ModelConfig, device):
    """Raise NotImplementedError for a model whose backward has no kernel
    on the card: the "fused" or "mg" polish tail (``jax.grad`` does not
    run through their Pallas kernels either) and a float32 PUNet3 (N's
    gradient kernels run the flax route's bfloat16, ROADMAP A.5.5). Every
    2-D net in float32 or bfloat16 (kernel B's two routes, each with its
    backward kernels) with no polish or the "xla"/"pallas" one, and PUNet3
    in bfloat16 with those, train there."""
    if torch.device(device).type != "cuda":
        return
    if mcfg.polish_sweeps > 0 and mcfg.polish_impl in ("fused", "mg"):
        raise NotImplementedError(
            f"no gradient of the {mcfg.polish_impl!r} polish tail on the "
            "card: JAX does not differentiate it either; train with "
            "polish_impl 'xla'")
    if mcfg.model == "PUNet3" and mcfg.compute_dtype != "bfloat16":
        raise NotImplementedError(
            f"training PUNet3 in {mcfg.compute_dtype} on the card: its "
            "conv gradients run kernel N's flax route in bfloat16, as "
            "scripts/train3d.py trains (ROADMAP A.5.5)")


def _sample_dyn(gen: torch.Generator, sim_cfg: SimConfig, cfg: TrainConfig):
    """(DynParams, n_steps) of one long-term rollout, drawn from the CPU
    generator ``gen`` and computed in float32 as JAX's ``_sample_dyn``."""
    u = torch.rand((6,), generator=gen).numpy()
    z = torch.randn((2,), generator=gen).numpy()
    card, updown = torch.randint(0, 2, (2,), generator=gen).tolist()
    f32 = np.float32
    b_scale = (f32(cfg.train_buoyancy_scale) + z[0]
               if u[0] < cfg.train_buoyancy_prob else f32(0.0))
    sign = float(updown * 2 - 1)
    gvec = (sign, 0.0, 0.0) if card == 0 else (0.0, sign, 0.0)
    dt = f32(sim_cfg.dt)
    if cfg.time_scale_sigma > 0:
        # mean(|N(0,1)|) ~= 0.7972, hence the 0.2028 offset.
        dt = dt * (f32(0.2028) + np.abs(z[1]) * f32(cfg.time_scale_sigma))
    n_steps = (cfg.lt_num_steps[0] if u[1] < cfg.lt_probability
               else cfg.lt_num_steps[1])
    return DynParams(float(dt), float(b_scale), 0.0, gvec), int(n_steps)


def make_loss_fn(model: FluidNet, sim_cfg: SimConfig, cfg: TrainConfig):
    """``loss_fn(batch, host_gen=None, draw=None) -> (total, LossTerms)``;
    ``draw`` (a ``(DynParams, n_steps)``) replaces ``_sample_dyn``'s draw
    from ``host_gen``. The weights are packed from the live parameters on
    every call, so the rollout projects with the current weights and the
    gradient reaches the parameters."""
    rollout_cfg = dataclasses.replace(sim_cfg, sim_method="convnet",
                                      advect_density=False)

    def loss_fn(batch: Batch, host_gen=None, draw=None):
        packed = pack_weights(model.net)
        p_out, U_out = model(batch.p_div, batch.U_div, batch.flags,
                             batch.density_div, packed)
        mask = batch.div_mask
        p_l2, div_l2, p_l1, div_l1 = short_term_losses(
            cfg, p_out, U_out, batch.flags, batch.p_target, mask=mask)
        total = p_l2 + div_l2 + p_l1 + div_l1
        div_lt = torch.zeros((), device=total.device)
        if cfg.div_lt_lambda > 0:
            dyn, n_steps = (draw if draw is not None
                            else _sample_dyn(host_gen, sim_cfg, cfg))
            zeros = torch.zeros_like(p_out)
            with torch.no_grad():
                def project(p, U, flags, density):
                    return model(p, U, flags, density, packed)

                state = SimState(p=p_out.detach(), U=U_out.detach(),
                                 flags=batch.flags, density=zeros)
                for _ in range(n_steps):
                    state = simulate_step(rollout_cfg, state, project,
                                          dyn=dyn)
            _, U_lt = model(state.p, state.U, batch.flags, zeros, packed)
            div_lt = long_term_loss(cfg, U_lt, batch.flags, mask=mask)
            total = total + div_lt
        return total, LossTerms(total, p_l2, div_l2, p_l1, div_l1, div_lt)

    return loss_fn


def _detached(terms: LossTerms) -> LossTerms:
    return LossTerms(*(t.detach() for t in terms))


def _dp_sum(t, mesh):
    """``t`` summed over the mesh's dp group, divided by dp."""
    dist.all_reduce(t, group=mesh.col)
    return t / mesh.dp


def _dp_first(mesh) -> int:
    """The global rank of this rank's dp group's first member."""
    return mesh.rank_of(0, mesh.sx_index)


def broadcast_params(model, mesh):
    """The dp group's first rank's parameters on every rank of it."""
    with torch.no_grad():
        for p in model.parameters():
            dist.broadcast(p.data, src=_dp_first(mesh), group=mesh.col)


def _shared_draw(draw, mesh):
    """The dp group's first rank's ``(DynParams, n_steps)`` on every rank
    (float32 values, carried exactly in float64)."""
    dyn, n = draw
    t = torch.tensor([dyn.dt, dyn.buoyancy_scale, dyn.gravity_scale,
                      *dyn.gravity_vec, n], dtype=torch.float64,
                     device=mesh.device)
    dist.broadcast(t, src=_dp_first(mesh), group=mesh.col)
    v = t.tolist()
    return DynParams(v[0], v[1], v[2], tuple(v[3:6])), int(v[6])


def make_train_step(model: FluidNet, sim_cfg: SimConfig, cfg: TrainConfig,
                    mesh=None):
    """``(train_step, eval_step)``: ``train_step(ts, batch, host_gen=None,
    draw=None) -> (ts, LossTerms)`` updates ``ts`` (whose model is
    ``model``) in place; ``eval_step`` returns the terms without
    gradient. Under a dp ``mesh`` (sx = 1) ``batch`` is this rank's shard,
    the returned terms are the global means and ``train_step.last_draw``
    the rollout's shared draw (see the module's note)."""
    loss_fn = make_loss_fn(model, sim_cfg, cfg)
    if mesh is not None:
        if mesh.sx > 1:
            raise NotImplementedError(
                f"make_train_step under a {mesh.dp}x{mesh.sx} mesh: "
                "width-sharded training (conv halos per layer, the s2d patch "
                "alignment) is ROADMAP A.8.2; it runs data-parallel (sx = 1)")
        broadcast_params(model, mesh)

    def run(batch, host_gen, draw):
        if mesh is not None:
            if batch.div_mask is not None:
                raise NotImplementedError(
                    "a div_mask under data parallelism: the ranks' masked "
                    "means do not average to the whole batch's")
            if cfg.div_lt_lambda > 0:
                draw = _shared_draw(draw if draw is not None else
                                    _sample_dyn(host_gen, sim_cfg, cfg), mesh)
        train_step.last_draw = draw
        return loss_fn(batch, host_gen, draw)

    def global_terms(terms):
        if mesh is None:
            return _detached(terms)
        t = _dp_sum(torch.stack([x.detach() for x in terms]), mesh)
        return LossTerms(*t.unbind())

    def train_step(ts: TrainState, batch: Batch, host_gen=None, draw=None):
        ts.optimizer.adam.zero_grad(set_to_none=True)
        total, terms = run(batch, host_gen, draw)
        total.backward()
        if mesh is not None:
            params = list(model.parameters())
            flat = _dp_sum(torch.cat([p.grad.reshape(-1) for p in params]),
                           mesh)
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
        terms = global_terms(terms)
        ts.optimizer.step(terms.total)
        ts.step += 1
        return ts, terms

    def eval_step(ts: TrainState, batch: Batch, host_gen=None, draw=None):
        with torch.no_grad():
            return global_terms(run(batch, host_gen, draw)[1])

    train_step.last_draw = None
    return train_step, eval_step


def make_on_device_train_step(model: FluidNet, sim_cfg: SimConfig,
                              cfg: TrainConfig, h: int, w: int,
                              batch_size: int = None,
                              jacobi_iters: int = 400, device="cuda"):
    """``step(ts, gen, host_gen, draw=None) -> (ts, LossTerms)``: a fresh
    synthetic batch drawn on ``device`` from ``gen`` (labels from
    ``jacobi_iters`` sweeps of kernel F), then one train step; no data
    crosses from the host."""
    train_step, _ = make_train_step(model, sim_cfg, cfg)
    bsz = batch_size or cfg.batch_size

    def step(ts: TrainState, gen, host_gen, draw=None):
        with torch.no_grad():
            sample = generate_batch(gen, bsz, h, w, jacobi_iters, device)
        return train_step(ts, Batch(*sample), host_gen, draw)

    return step


def _project_frame(sim_cfg: SimConfig, s_div: SimState, iters: int):
    """Finish a step classically from its divergent state. Returns
    (next state, U_in, p_in): U_in is the divergent velocity as the convnet
    step hands it to the learned projection (stick walls and const BCs,
    no free-slip walls) and p_in the Jacobi pressure of that field (the
    anchoring target); the trajectory continues with the Jacobi step's
    tail."""
    flags = s_div.flags
    U_in = s_div.U
    if s_div.flags_stick is not None:
        U_in = set_wall_bcs_stick(U_in, flags, s_div.flags_stick)
    if s_div.U_bc is not None:
        U_in = U_in * s_div.U_bc_inv_mask + s_div.U_bc
    p_in = solve_jacobi(flags, velocity_divergence(U_in, flags), iters)
    U = set_wall_bcs(s_div.U, flags)
    if s_div.U_bc is not None:
        U = U * s_div.U_bc_inv_mask + s_div.U_bc
    p = solve_jacobi(flags, velocity_divergence(U, flags), iters)
    U = set_wall_bcs(velocity_update(p, U, flags), flags)
    if s_div.U_bc is not None:
        U = U * s_div.U_bc_inv_mask + s_div.U_bc
    return s_div._replace(p=p, U=U), U_in, p_in


@torch.no_grad()
def collect_rollout_frames(sim_cfg: SimConfig, state0: SimState,
                           n_frames: int, stride: int = 4, warmup: int = 50):
    """Roll the scene with the classical (Jacobi) projection and collect
    the pre-projection divergent states, the distribution the learned
    projection sees in closed loop: ``warmup`` full steps, then per frame
    one step to its divergent state, its classical finish and ``stride -
    1`` full steps. Returns (frames (n, 2, h, w), the Jacobi pressures of
    the frames (n, h, w), the scene's flags)."""
    state = state0
    for _ in range(warmup):
        state = simulate_step(sim_cfg, state)
    frames, p_frames = [], []
    for _ in range(n_frames):
        s_div = simulate_step(sim_cfg, state, output_div=True)
        state, U_in, p_in = _project_frame(sim_cfg, s_div,
                                           sim_cfg.jacobi_iter)
        for _ in range(stride - 1):
            state = simulate_step(sim_cfg, state)
        frames.append(U_in[0])
        p_frames.append(p_in[0])
    return torch.stack(frames), torch.stack(p_frames), state0.flags


def make_mixed_train_step(model: FluidNet, sim_cfg: SimConfig,
                          cfg: TrainConfig, frame_shape, batch_size: int,
                          synth_frac: float = 0.5, jacobi_iters: int = 400,
                          device="cuda"):
    """``step(ts, gen, host_gen, frames, frame_p, frame_flags,
    frame_div_mask=None) -> (ts, LossTerms)``: per sample, with probability
    ``synth_frac`` a fresh synthetic field, else a buffered rollout frame
    (``collect_rollout_frames``) at a random amplitude in [0.5, 1.5), its
    pressure target scaled alike (the projection is linear)."""
    train_step, _ = make_train_step(model, sim_cfg, cfg)
    n, _, h, w = frame_shape

    def step(ts: TrainState, gen, host_gen, frames, frame_p, frame_flags,
             frame_div_mask=None):
        with torch.no_grad():
            syn = generate_batch(gen, batch_size, h, w, jacobi_iters, device)
            idx = torch.randint(0, n, (batch_size,), generator=gen,
                                device=device)
            amp = torch.rand((batch_size, 1, 1, 1), generator=gen,
                             device=device) + 0.5
            use_syn = torch.rand((batch_size, 1, 1, 1), generator=gen,
                                 device=device) < synth_frac
            U_div = torch.where(use_syn, syn.U_div, frames[idx] * amp)
            flags = torch.where(use_syn[..., 0], syn.flags, frame_flags)
            p_target = torch.where(use_syn[..., 0], syn.p_target,
                                   frame_p[idx] * amp[..., 0])
            zero = torch.zeros((batch_size, h, w), device=device)
            div_mask = (None if frame_div_mask is None else torch.where(
                use_syn[..., 0], 1.0, frame_div_mask.to(torch.float32)))
        batch = Batch(p_div=zero, U_div=U_div, flags=flags,
                      density_div=zero, p_target=p_target, U_target=U_div,
                      density_target=zero, div_mask=div_mask)
        return train_step(ts, batch, host_gen)

    return step


def loss3(model, packed, U_div, flags, mask=None):
    """``scripts/train3d.py``'s loss: FluidNet3's projection of ``U_div``
    (p and density zero), then the mean of div^2 over every cell, or with
    ``mask`` (1, d, h, w) sum(div^2 mask) / sum(mask) / batch (the rollout
    frames' loss outside the inlet). ``packed`` is
    ``pack_weights3(model.net)``."""
    zero = torch.zeros_like(U_div[:, 0])
    _, U_out = model(zero, U_div, flags, zero, packed)
    div = velocity_divergence3(U_out, flags)
    if mask is not None:
        return torch.sum(div * div * mask) / torch.sum(mask) / div.shape[0]
    return torch.mean(div * div)


def make_train_step3(model, lr: float, batch_size: int, res: int,
                     label_iters: int = 400, frames=None, frame_flags=None,
                     frame_mask=None, synth_frac: float = 0.5,
                     device="cuda"):
    """``(step, optimizer)`` of ``scripts/train3d.py``: ``step(gen) ->
    loss`` draws a synthetic batch (``generate_batch3``, ``label_iters``
    sweeps) at ``res``^3 from ``gen`` (a generator on ``device``), takes
    ``loss3`` (with ``frames``, (n, 3, d, h, w) of
    ``collect_rollout_frames3``: ``synth_frac`` times the synthetic loss
    plus the rest times the masked loss of ``batch_size`` frames drawn
    from ``gen``) and one plain Adam update (optax's defaults) of
    ``model``'s parameters, packed anew each call. Returns the loss,
    detached."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    if frames is not None:
        maskf = frame_mask.float()[None]
        f_flags = frame_flags.expand(batch_size,
                                     *frame_flags.shape[1:]).contiguous()

    def step(gen):
        with torch.no_grad():
            U_div, flags, _, _ = generate_batch3(gen, batch_size, res, res,
                                                 res, label_iters, device)
            if frames is not None:
                idx = torch.randint(0, frames.shape[0], (batch_size,),
                                    generator=gen, device=device)
                U_f = frames[idx]
        packed = pack_weights3(model.net)
        loss = loss3(model, packed, U_div, flags)
        if frames is not None:
            loss = (synth_frac * loss + (1.0 - synth_frac)
                    * loss3(model, packed, U_f, f_flags, maskf))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, opt


def _project_frame3(sim_cfg: SimConfig, s_div: SimState):
    """JAX's ``collect_rollout_frames3.project``: (the state continued by
    the Jacobi step's tail, U_in), U_in the divergent velocity as the
    convnet step hands it to the learned projection (const BCs, no walls).
    """
    bc = s_div.U_bc
    U_in = s_div.U if bc is None else s_div.U * s_div.U_bc_inv_mask + bc
    flags = s_div.flags
    U = set_wall_bcs3(s_div.U, flags)
    if bc is not None:
        U = U * s_div.U_bc_inv_mask + bc
    p = solve_jacobi3(flags, velocity_divergence3(U, flags),
                      sim_cfg.jacobi_iter)
    U = set_wall_bcs3(velocity_update3(p, U, flags), flags)
    if bc is not None:
        U = U * s_div.U_bc_inv_mask + bc
    return s_div._replace(p=p, U=U), U_in


@torch.no_grad()
def collect_rollout_frames3(sim_cfg: SimConfig, state0: SimState,
                            n_frames: int, stride: int = 4,
                            warmup: int = 40):
    """The 3-D twin of ``collect_rollout_frames`` (JAX ``train/trainer.py::
    collect_rollout_frames3``): ``warmup`` full steps of the classical
    (Jacobi) step, then per frame one step to its divergent state, its
    classical finish and ``stride - 1`` full steps; JAX's ``fori_loop`` and
    ``scan`` are Python loops. Returns (frames (n, 3, d, h, w), the
    scene's flags, the inlet mask (d, h, w): True where the divergence
    loss counts, outside the BC-clamped inlet)."""
    state = state0
    for _ in range(warmup):
        state = simulate_step3(sim_cfg, state)
    frames = []
    for _ in range(n_frames):
        s_div = simulate_step3(sim_cfg, state, output_div=True)
        state, U_in = _project_frame3(sim_cfg, s_div)
        for _ in range(stride - 1):
            state = simulate_step3(sim_cfg, state)
        frames.append(U_in[0])
    if state0.U_bc_inv_mask is not None:
        mask = torch.amin(state0.U_bc_inv_mask[0], dim=0) > 0.5
    else:
        mask = torch.ones(state0.flags.shape[1:], dtype=torch.bool,
                          device=state0.flags.device)
    return torch.stack(frames), state0.flags, mask
