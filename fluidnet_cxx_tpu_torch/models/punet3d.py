"""PUNet3, the learned 3-D pressure projection (the port of the JAX
package's ``models/punet3d.py``: ``space_to_depth3``/``depth_to_space3``,
the ``PUNet3`` network, the flax-path ``FluidNet3`` with its
``make_project_fn3`` and ``init_params3``, and the inference projection of
``make_project_fn3_fused_forward``).

space-to-depth(patch) -> 1x1x1 embed -> encoder (stride-2 3x3x3 downs,
3x3x3 convs) -> bottleneck 3x3x3 convs -> decoder (1x1x1 expand +
depth-to-space(2), skip concat [up | skip], 3x3x3 convs) -> 1x1x1 head ->
depth-to-space(patch). JAX's PUNet3 has no refinement stack:
``punet_refine_convs`` is ignored, as the JAX ``FluidNet3`` ignores it;
only the fused forward refuses it, as JAX's does.

Layouts follow flax so the converted weights drop in: the network takes and
returns NDHWC; ``space_to_depth3`` orders channels (pz, py, px, c) like
flax (not torch's pixel-shuffle order); padding is flax 'SAME', which on
an even input pads a stride-2 conv (0, 1) per axis. Parameters are
``nn.Conv3d``s (OIDHW) named as the flax modules are. This module's forward
is the plain version of kernel N (ops/kernels/punet3.py) on the net's
``rounding`` route: "flax" (the flax path, flax's bfloat16 rounding
points) or "fused" (the fused forward, the TPU kernel's); see that module.
"""
import torch
from torch import nn

from ..ops.kernels.jacobi3 import solve_jacobi3
from ..ops.kernels.proj_tail3 import project_tail3
from ..ops.kernels.punet3 import (conv3d_ndhwc_autograd,
                                  conv3d_ndhwc_plain, pack_layer3,
                                  pack_weights3, punet3_forward)
from ..ops.ops3d import set_wall_bcs3, velocity_divergence3, velocity_update3
from ..ops.stencils import flags_to_occupancy
from .convert import flax_to_state_dict3, random_flax_params3
from .fluidnet import scale_std

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ROUNDINGS = ("flax", "fused")


def space_to_depth3(x, p: int):
    """(b, d, h, w, c) -> (b, d/p, h/p, w/p, p^3 c), channels ordered
    (pz, py, px, c)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // p, p, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, d // p, h // p, w // p, p * p * p * c)


def depth_to_space3(x, p: int):
    """(b, d, h, w, p^3 c) -> (b, d p, h p, w p, c). Inverse of
    space_to_depth3."""
    b, d, h, w, cp = x.shape
    c = cp // (p * p * p)
    x = x.reshape(b, d, h, w, p, p, p, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d * p, h * p, w * p, c)


def layer_table3(in_ch, patch, widths, level_convs, bottleneck_convs):
    """[(name, c_in, c_out, kernel, stride)] in forward order."""
    widths = tuple(widths)
    t = [("embed", patch ** 3 * in_ch, widths[0], 1, 1)]
    for i, wd in enumerate(widths):
        if i > 0:
            t.append((f"down{i}", widths[i - 1], wd, 3, 2))
        for j in range(level_convs):
            t.append((f"enc{i}_{j}", wd, wd, 3, 1))
    for j in range(bottleneck_convs):
        t.append((f"mid{j}", widths[-1], widths[-1], 3, 1))
    for i in range(len(widths) - 2, -1, -1):
        wd = widths[i]
        t.append((f"up{i}", widths[i + 1], 8 * wd, 1, 1))
        for j in range(level_convs):
            t.append((f"dec{i}_{j}", 2 * wd if j == 0 else wd, wd, 3, 1))
    t.append(("head", widths[0], patch ** 3, 1, 1))
    return t


class PUNet3(nn.Module):
    """Learned 3-D Poisson solve: NDHWC (b, d, h, w, in_ch) float32 ->
    (b, d, h, w, 1) float32.

    d, h and w must be divisible by patch * 2**(len(widths)-1).
    ``rounding``: "flax" (every layer's output in the compute dtype, the
    bfloat16 sum rounded before the bias add) or "fused" (the up conv's
    and the head's outputs float32, the bias in the float32 sum)."""

    def __init__(self, in_ch: int = 2, patch: int = 4, widths=(96, 128),
                 level_convs: int = 1, bottleneck_convs: int = 2,
                 compute_dtype: str = "bfloat16", rounding: str = "fused"):
        super().__init__()
        if compute_dtype not in _COMPUTE_DTYPES:
            raise NotImplementedError(
                f"compute_dtype {compute_dtype!r}: the port's PUNet3 runs "
                "float32 or bfloat16")
        if rounding not in ROUNDINGS:
            raise ValueError(f"rounding {rounding!r}: one of {ROUNDINGS}")
        self.in_ch = in_ch
        self.patch = patch
        self.widths = tuple(widths)
        self.level_convs = level_convs
        self.bottleneck_convs = bottleneck_convs
        self.act_dtype = _COMPUTE_DTYPES[compute_dtype]
        self.rounding = rounding
        # flax's two roundings of a bfloat16 conv (no-ops in float32).
        self.round_sum = (rounding == "flax"
                          and self.act_dtype == torch.bfloat16)
        # The routes with a backward (ops/kernels/punet3.py::ConvNDHWC):
        # the flax route and float32.
        self.trainable = (self.round_sum
                          or self.act_dtype == torch.float32)
        self.table = layer_table3(in_ch, patch, widths, level_convs,
                                  bottleneck_convs)
        self.strides = {name: s for name, _, _, _, s in self.table}
        self.convs = nn.ModuleDict({
            name: nn.Conv3d(ci, co, k, stride=s)
            for name, ci, co, k, s in self.table})

    @classmethod
    def from_config(cls, cfg, rounding: str = "fused"):
        """Build from a ``ModelConfig`` (PUNet3, float32 or bfloat16;
        ``punet_refine_convs`` is ignored, as the JAX PUNet3 has no
        refinement stack)."""
        if cfg.model != "PUNet3":
            raise NotImplementedError(
                f"model {cfg.model!r}: this module builds PUNet3; the 2-D "
                "nets are models/fluidnet.py's (ROADMAP A.4)")
        return cls(in_ch=cfg.in_dims, patch=cfg.punet_patch,
                   widths=cfg.punet_widths,
                   level_convs=cfg.punet_level_convs,
                   bottleneck_convs=cfg.punet_bottleneck_convs,
                   compute_dtype=cfg.compute_dtype, rounding=rounding)

    def out_dtype(self, relu: bool):
        """A layer's output dtype: the compute dtype, except on the fused
        route, where the layers without a ReLU (the up conv, the head) stay
        float32."""
        return (self.act_dtype if relu or self.rounding == "flax"
                else torch.float32)

    def _plain_conv(self, name, x, x2=None, relu=True):
        """The plain version of one layer; while autograd records, on a
        trainable route, ``ConvNDHWC`` with the plain backward (flax's
        rounding points, not torch's own bfloat16 conv backward)."""
        c = self.convs[name]
        args = (self.strides[name], relu, x2, self.out_dtype(relu),
                self.round_sum)
        if self.trainable and torch.is_grad_enabled():
            w_dhwio, b = pack_layer3(self, c)
            return conv3d_ndhwc_autograd(x, w_dhwio, b, *args, plain=True)
        return conv3d_ndhwc_plain(x, c.weight.to(self.act_dtype), c.bias,
                                  *args)

    def forward(self, x, conv=None):
        """``conv`` replaces the per-layer convolution (the kernel path
        passes its own)."""
        conv = conv or self._plain_conv
        x = space_to_depth3(x.float(), self.patch).to(self.act_dtype)
        x = conv("embed", x)
        skips = []
        for i in range(len(self.widths)):
            if i > 0:
                x = conv(f"down{i}", x)
            for j in range(self.level_convs):
                x = conv(f"enc{i}_{j}", x)
            skips.append(x)
        for j in range(self.bottleneck_convs):
            x = conv(f"mid{j}", x)
        for i in range(len(self.widths) - 2, -1, -1):
            x = depth_to_space3(conv(f"up{i}", x, relu=False), 2)
            x = conv(f"dec{i}_0", x, x2=skips[i])
            for j in range(1, self.level_convs):
                x = conv(f"dec{i}_{j}", x)
        x = conv("head", x, relu=False)
        return depth_to_space3(x, self.patch).float()


def _scale4(cfg, p, U, div, scale=None):
    """(b, 1, 1, 1) std scale of the configured channel, or ones;
    ``scale`` (b,) if given (the width-sharded step's std over the whole
    grid, parallel/project.py)."""
    if scale is not None and cfg.normalize_input:
        return scale[:, None, None, None]
    if cfg.normalize_input:
        chan = {"pDiv": p, "UDiv": U, "div": div}[cfg.normalize_input_chan]
        s = scale_std(chan, cfg.normalize_input_threshold)
    else:
        s = torch.ones((p.shape[0],), dtype=torch.float32, device=p.device)
    return s[:, None, None, None]


class FluidNet3(nn.Module):
    """The flax-path learned 3-D projection (JAX ``FluidNet3.__call__``):
    ``forward(p, U, flags, density) -> (p, U)`` on the divergent state.
    divergence and the std scale s -> PUNet3 of [div / s, occupancy] with
    flax's rounding points -> the polish of ``polish_impl`` ("fused":
    kernel J on un-normalised fields; "pallas" and "xla": kernel I's
    damped Jacobi from p_hat on the normalised fields; none with
    ``polish_sweeps`` 0) -> velocity update -> un-scale -> free-slip
    walls. ``net`` defaults to ``PUNet3.from_config(cfg, "flax")``.

    Under autograd (training, ``train/trainer.py``) every conv is
    ``ConvNDHWC`` (N's forward and its gradient kernels on the card) and
    the "xla"/"pallas" polish ``JacobiPolish3`` (I forward, its adjoint
    backward); the "fused" tail raises on the card, as ``jax.grad`` does
    not run through its Pallas kernel either."""

    def __init__(self, cfg, net=None):
        super().__init__()
        net = PUNet3.from_config(cfg, "flax") if net is None else net
        if net.rounding != "flax":
            raise ValueError("FluidNet3 runs a PUNet3 built with "
                             "rounding='flax'")
        self.cfg = cfg
        self.net = net

    def forward(self, p, U, flags, density, packed=None, scale=None):
        """``packed`` (``pack_weights3(self.net)``) runs the convolutions
        through kernel N's wrapper; without it the network's plain
        forward. The polish and the tail follow the tensors' device.
        ``scale``: see ``_scale4``."""
        cfg = self.cfg
        div = velocity_divergence3(U, flags)
        s4 = _scale4(cfg, p, U, div, scale)
        x = torch.stack([div / s4, flags_to_occupancy(flags)], dim=-1)
        out = (self.net(x) if packed is None
               else punet3_forward(self.net, packed, x))
        p_hat = out[..., 0].contiguous()
        if (cfg.polish_sweeps > 0 and cfg.polish_impl == "fused"
                and p_hat.requires_grad and p_hat.is_cuda):
            raise NotImplementedError(
                "no gradient of the 'fused' polish tail on the card: JAX "
                "does not differentiate it either (jax.grad stops at its "
                "Pallas kernel); train with polish_impl 'xla'")
        if cfg.polish_sweeps > 0 and cfg.polish_impl == "fused":
            # The tail on un-normalised fields (linear in p and the RHS).
            return project_tail3(flags, U, p_hat * s4, cfg.polish_sweeps,
                                 damping=cfg.polish_damping)
        if cfg.polish_sweeps > 0:
            # "pallas" and "xla": the same fixed-count damped Jacobi.
            p_hat = solve_jacobi3(flags, div / s4, cfg.polish_sweeps,
                                  p0=p_hat, damping=cfg.polish_damping)
        U_new = velocity_update3(p_hat, U / s4[:, None], flags)
        return p_hat * s4, set_wall_bcs3(U_new * s4[:, None], flags)


def init_params3(model, seed: int):
    """Flax-initialised weights from numpy ``seed`` (lecun-normal kernels,
    zero biases: ``models/convert.py::random_flax_params3``) loaded into
    ``model`` (a FluidNet3 or a PUNet3); returns the model."""
    net = model.net if isinstance(model, FluidNet3) else model
    net.load_state_dict(flax_to_state_dict3(
        random_flax_params3(net.table, seed)))
    return model


def make_project_fn3(cfg, net=None):
    """Inference projection ``project(p, U, flags, density) -> (p, U)`` for
    ``simulate_step3`` on the flax path (``FluidNet3``), with the net's
    weights packed once for kernel N's flax route. ``cfg`` is the
    ``ModelConfig``, ``net`` a PUNet3 with rounding "flax" (default: built
    from ``cfg``; its device decides kernel or plain path)."""
    model = FluidNet3(cfg, net)
    if model.net.in_ch != 2:
        raise ValueError("the 3-D projection assembles a 2-channel input")
    with torch.no_grad():
        packed = pack_weights3(model.net)

    @torch.no_grad()
    def project(p, U, flags, density, scale=None):
        return model(p, U, flags, density, packed, scale)

    # What the width-sharded step reads (parallel/project.py::sharding_of).
    project.kind, project.cfg, project.net = "flax3", cfg, model.net
    return project


def make_project_fn3_fused_forward(cfg, net):
    """Inference 3-D projection ``project(p, U, flags, density) -> (p,
    U)`` for ``simulate_step3``, with the semantics of the JAX package's
    ``make_project_fn3_fused_forward``: divergence, the std scale s of the
    configured channel, the PUNet3 forward of [div / s, occupancy]
    (kernel N, the fused route's rounding points), then the projection
    tail (kernel J: RHS, ``polish_sweeps`` warm damped Jacobi sweeps from
    p_hat * s, velocity update, wall BCs) on the un-normalised fields.

    ``cfg`` is the ``ModelConfig``, ``net`` the PUNet3 with rounding
    "fused" (its device decides kernel or plain path). Raises ValueError
    where JAX's raises: another model, a refinement stack, another
    ``polish_impl`` than "fused", or (at the call) a grid that is not a
    cube."""
    if (cfg.model != "PUNet3" or cfg.punet_refine_convs != 0
            or cfg.polish_impl != "fused"):
        raise ValueError("fused 3-D forward needs a refine-free PUNet3 on "
                         "a cubic grid with the fused-tail polish_impl")
    if net.rounding != "fused":
        raise ValueError("the fused 3-D forward runs a PUNet3 built with "
                         "rounding='fused'")
    if net.in_ch != 2:
        raise ValueError("the 3-D projection assembles a 2-channel input")
    with torch.no_grad():
        packed = pack_weights3(net)

    @torch.no_grad()
    def project(p, U, flags, density, scale=None, grid=None):
        """``scale`` and ``grid``, the whole grid's (d, h, w) for the cube
        check: the width-sharded step's, which runs the projection on a
        slab (parallel/project.py)."""
        grid = tuple(flags.shape[1:]) if grid is None else tuple(grid)
        if len(set(grid)) != 1:
            raise ValueError(f"fused 3-D forward needs a cubic grid, got "
                             f"{grid}")
        div = velocity_divergence3(U, flags)
        s4 = _scale4(cfg, p, U, div, scale)
        x = torch.stack([div / s4, flags_to_occupancy(flags)], dim=-1)
        p_hat = punet3_forward(net, packed, x)[..., 0]
        return project_tail3(flags, U, p_hat * s4,
                             cfg.polish_sweeps, damping=cfg.polish_damping)

    project.kind, project.cfg, project.net = "fused3", cfg, net
    return project
