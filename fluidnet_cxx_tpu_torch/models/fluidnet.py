"""The learned pressure projection (the port of the JAX package's
``models/fluidnet.py``): input assembly and ``scale_std``, the 3-bank
FluidNet conv tower, the flax-path ``FluidNet`` wrapper with its
``make_project_fn``, and the fused inference path of
``make_project_fn_fused_forward``.

Flax path (``FluidNet``, every architecture): assemble (divergence,
occupancy, the std scale s) -> network (PUNet, MultiScaleNet or
FluidNetTower; kernel B for each conv on a CUDA tensor) -> the optional
polish (``polish_impl``: "fused" kernel C, "mg" kernel H, "pallas"/"xla"
kernel F's damped Jacobi on the normalised fields) -> velocity update on
the normalised fields -> un-scale -> wall BCs.

Training (train/trainer.py) calls ``FluidNet`` with weights packed from
the live parameters on every call (``pack_weights`` while autograd
records): each conv then runs ``ops/kernels/punet.py::ConvNHWC``, whose
backward is ``fn_conv2d_dgrad`` (any stride: one pass per output-parity
class), split at a skip concat, and ``fn_conv2d_wgrad``; the damped
polish runs ``JacobiPolish`` (kernel F, then its transposed sweeps). The
pooling, repeats, space-to-depth and resizes between the convs are torch
glue that autograd differentiates, as in the forward.

Fused path (refine-free PUNet): the forward takes the normalisation 1/s
on its input's physical channel, then the projection tail
(ops/kernels/proj_tail.py, or one warm V-cycle of ops/kernels/mg.py::
project_mg with ``polish_impl="mg"``) runs on un-normalised fields with
the inlet BCs folded in on its input and output.
"""
import torch

from ..ops.kernels.jacobi import solve_jacobi
from ..ops.kernels.mg import project_mg
from ..ops.kernels.proj_tail import project_tail
from ..ops.kernels.punet import net_forward, pack_weights, widen
from ..ops.stencils import (flags_to_occupancy, set_wall_bcs,
                            velocity_divergence, velocity_update)
from .multi_scale import MultiScaleNet
from .punet import ConvNet, PUNet


def scale_std(x, threshold: float):
    """Per-sample input scale: std over all elements (Bessel-corrected),
    clamped below at ``threshold``."""
    y = x.reshape(x.shape[0], -1)
    return torch.clamp(torch.std(y, dim=1, correction=1), min=threshold)


def input_scale(cfg, p, U, div, scale=None):
    """(b,) scale s of the configured channel (``normalize_input_chan``),
    or ones without ``normalize_input``; ``scale`` if given (the
    width-sharded step's std over the whole grid, parallel/project.py)."""
    if scale is not None and cfg.normalize_input:
        return scale
    if not cfg.normalize_input:
        return torch.ones((p.shape[0],), dtype=torch.float32,
                          device=p.device)
    chan = {"pDiv": p, "UDiv": U, "div": div}[cfg.normalize_input_chan]
    return scale_std(chan, cfg.normalize_input_threshold)


def assemble_inputs(cfg, p, U, flags, density, scale=None):
    """(NHWC input, scale s (b,), div) of the network: the reference's
    priority chain pDiv, else UDiv (2 channels), else div, each divided by
    s, then occupancy. ``scale``: see ``input_scale``."""
    div = velocity_divergence(U, flags)
    s3 = input_scale(cfg, p, U, div, scale)[:, None, None]
    if cfg.input_p_div:
        feats = [p / s3]
    elif cfg.input_u_div:
        feats = [U[:, 0] / s3, U[:, 1] / s3]
    elif cfg.input_div:
        feats = [div / s3]
    else:
        feats = []
    feats.append(flags_to_occupancy(flags))
    return torch.stack(feats, dim=-1), s3[:, 0, 0], div


def tower_table(in_ch: int):
    """FluidNetTower's layers, [(name, c_in, c_out, kernel, stride,
    dilation)]."""
    return [("conv1", in_ch, 16, 3, 1, 1), ("bank_conv1", 16, 16, 3, 1, 1),
            ("bank_conv2", 16, 16, 3, 1, 1), ("conv2", 16, 16, 1, 1, 1),
            ("conv3", 16, 8, 1, 1, 1), ("convOut", 8, 1, 1, 1, 1)]


def avg_pool(x, k: int):
    """k x k average pool of NHWC ``x``, stride k (flax ``avg_pool``,
    VALID; the sides are multiples of k): the window's sum, then a divide
    by k*k. In bfloat16 the sum is XLA's reduce_window on the CPU, a chain
    over the window in row-major order with each add rounded."""
    b, h, w, c = x.shape
    t = x.reshape(b, h // k, k, w // k, k, c)
    if x.dtype != torch.bfloat16:
        return t.mean(dim=(2, 4))
    acc = torch.zeros_like(t[:, :, 0, :, 0])
    for i in range(k):
        for j in range(k):
            acc = acc + t[:, :, i, :, j]
    return acc / (k * k)


def upsample(x, k: int):
    """Nearest-neighbour k-fold upsample of NHWC ``x`` (a repeat)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, k, w, k, c).reshape(
        b, h * k, w * k, c)


class FluidNetTower(ConvNet):
    """The 3-bank FluidNet conv tower (JAX ``FluidNetTower``): conv1 3x3
    and ReLU; one shared bank (two 3x3 convs, each with ReLU) at scales 1,
    1/2 and 1/4 (average pools), nearest upsample and sum; 1x1 conv2 and
    conv3 with ReLU, 1x1 convOut to one channel. Like JAX, conv2 runs once
    (the reference applies it twice). h and w must be multiples of 4.
    ``dtype`` is flax's: in bfloat16 the pools, the repeats and the
    three-bank sum (each add rounded, left to right) stay bfloat16, as
    between flax's bfloat16 convs."""
    outputs = ("convOut",)

    def __init__(self, in_ch: int = 2, dtype: str = "float32"):
        super().__init__(tower_table(in_ch), dtype)
        self.in_ch = in_ch

    def forward(self, x, conv=None, width=None):
        """NHWC (b, h, w, in_ch) -> (b, h, w, 1); ``conv`` and ``width``:
        see ``ConvNet``."""
        if x.shape[1] % 4 or x.shape[2] % 4:
            raise ValueError(f"FluidNetTower needs h and w divisible by 4, "
                             f"got {tuple(x.shape[1:3])}")
        conv = conv or self._plain_conv

        def bank(a):
            return conv("bank_conv2", conv("bank_conv1", a))

        x = conv("conv1", widen(x, width))
        x = (bank(x) + upsample(bank(avg_pool(x, 2)), 2)
             + upsample(bank(avg_pool(x, 4)), 4))
        x = conv("conv3", conv("conv2", x))
        return conv("convOut", x, relu=False)[..., :1].float()


def make_net(cfg) -> ConvNet:
    """The network of a ``ModelConfig``: PUNet (with or without its
    refinement stack), MultiScaleNet for "ScaleNet", else FluidNetTower,
    as the JAX ``FluidNet`` picks it, each in ``cfg.compute_dtype``
    (float32 or bfloat16)."""
    if cfg.model == "PUNet":
        return PUNet.from_config(cfg)
    if cfg.model == "ScaleNet":
        return MultiScaleNet(cfg.in_dims, cfg.compute_dtype)
    return FluidNetTower(cfg.in_dims, cfg.compute_dtype)


class FluidNet(torch.nn.Module):
    """The flax-path learned projection (JAX ``FluidNet.__call__``):
    ``forward(p, U, flags, density) -> (p, U)`` on the divergent state.
    ``net`` defaults to ``make_net(cfg)``."""

    def __init__(self, cfg, net=None):
        super().__init__()
        self.cfg = cfg
        self.net = make_net(cfg) if net is None else net

    def forward(self, p, U, flags, density, packed=None, scale=None,
                net_only=False):
        """``packed`` (``pack_weights(self.net)``) runs the network's
        convolutions through kernel B's wrapper; without it the network's
        plain forward. The polish and the tail follow the tensors'
        device. While autograd records, the "xla"/"pallas" polish is
        ``ops/kernels/jacobi.py::JacobiPolish`` (kernel F forward, its
        transposed sweeps backward); the "fused" and "mg" tails raise on
        the card, as ``jax.grad`` does not run through their Pallas
        kernels either. ``scale``: see ``input_scale``; ``net_only``
        returns the network's un-normalised pressure before any polish
        (the width-sharded "mg" polish runs its V-cycle after it)."""
        cfg = self.cfg
        x, s, div = assemble_inputs(cfg, p, U, flags, density, scale)
        out = self.net(x) if packed is None else net_forward(self.net,
                                                             packed, x)
        p_hat = out[..., 0].contiguous()
        if net_only:
            return p_hat * s[:, None, None]
        if (cfg.polish_sweeps > 0 and cfg.polish_impl in ("fused", "mg")
                and p_hat.requires_grad and p_hat.is_cuda):
            raise NotImplementedError(
                f"no gradient of the {cfg.polish_impl!r} polish tail on the "
                "card: JAX does not differentiate it either (jax.grad stops "
                "at its Pallas kernel); train with polish_impl 'xla'")
        s3 = s[:, None, None]
        if cfg.polish_sweeps > 0 and cfg.polish_impl == "fused":
            # The tail on un-normalised fields (linear in p and the RHS).
            return project_tail(flags, U, p_hat * s3, cfg.polish_sweeps,
                                damping=cfg.polish_damping)
        if cfg.polish_sweeps > 0 and cfg.polish_impl == "mg":
            return project_mg(flags, U, p0=p_hat * s3, n_vcycles=1)
        if cfg.polish_sweeps > 0:
            # "pallas" and "xla": the same fixed-count damped Jacobi.
            p_hat = solve_jacobi(flags, div / s3, cfg.polish_sweeps,
                                 p0=p_hat, damping=cfg.polish_damping)
        U_new = velocity_update(p_hat, U / s3[:, None], flags) * s3[:, None]
        return p_hat * s3, set_wall_bcs(U_new, flags)


def make_project_fn(cfg, net):
    """Inference projection ``project(p, U, flags, density) -> (p, U)`` for
    ``simulate_step`` on the flax path (``FluidNet``), with ``net``'s
    weights packed once for kernel B. It has no ``handles_const_vals``:
    the step runs it in its unfused branch, as the JAX step runs the flax
    ``make_project_fn``."""
    model = FluidNet(cfg, net)
    with torch.no_grad():
        packed = pack_weights(net)

    @torch.no_grad()
    def project(p, U, flags, density, scale=None, net_only=False):
        return model(p, U, flags, density, packed, scale, net_only)

    # What the width-sharded step reads (parallel/project.py::sharding_of).
    project.kind, project.cfg, project.net = "flax", cfg, net
    return project


def make_project_fn_fused_forward(cfg, net):
    """Inference projection ``project(p, U, flags, density, U_bc=None,
    U_bc_inv_mask=None) -> (p, U)`` for ``simulate_step``.

    ``cfg`` is the ``ModelConfig``, ``net`` the PUNet (its device decides
    kernel or plain path). Semantics of the JAX package's fused path: the
    normalisation 1/s is applied to the input's physical channel inside
    the forward, the tail works on un-normalised fields with
    ``p0 = p_hat * s``, and given ``U_bc``/``U_bc_inv_mask`` the inlet BCs
    are applied on the tail's input and output (``handles_const_vals``)."""
    if (cfg.model != "PUNet" or cfg.punet_refine_convs != 0
            or cfg.compute_dtype != "float32"):
        raise ValueError("the fused forward runs a refine-free PUNet in "
                         "float32; the other nets take make_project_fn")
    if cfg.input_u_div:
        raise ValueError("the projection assembles a 2-channel input; "
                         "input_u_div needs 3 channels")
    with torch.no_grad():
        packed = pack_weights(net)

    @torch.no_grad()
    def project(p, U, flags, density, U_bc=None, U_bc_inv_mask=None,
                scale=None, net_only=False):
        U_in = U * U_bc_inv_mask + U_bc if U_bc is not None else U
        div = velocity_divergence(U_in, flags)
        s = input_scale(cfg, p, U_in, div, scale)
        feat0 = p if cfg.input_p_div else div
        x = torch.stack([feat0, flags_to_occupancy(flags)], dim=-1)
        p_hat = net_forward(net, packed, x, inv_scale=1.0 / s)[..., 0]
        if net_only:
            return p_hat * s[:, None, None]
        if cfg.polish_impl == "mg":
            p, U = project_mg(flags, U_in, p0=p_hat * s[:, None, None],
                              n_vcycles=1)
            if U_bc is not None:
                U = U * U_bc_inv_mask + U_bc
            return p, U
        return project_tail(flags, U, p_hat.contiguous(), cfg.polish_sweeps,
                            damping=cfg.polish_damping, scale=s, U_bc=U_bc,
                            U_bc_inv_mask=U_bc_inv_mask)

    project.handles_const_vals = True
    project.kind, project.cfg, project.net = "fused", cfg, net
    return project


def summary(net, title: str = "FluidNet"):
    """Parameter-count table of ``net`` (JAX ``summary``; the reference
    prints a torchsummary table)."""
    lines = [f"{title} parameters:"]
    total = 0
    for name, t in net.state_dict().items():
        total += t.numel()
        lines.append(f"  {name:60s} {str(tuple(t.shape)):18s} "
                     f"{t.numel():>10,d}")
    lines.append(f"  {'total':60s} {'':18s} {total:>10,d}")
    return "\n".join(lines)
