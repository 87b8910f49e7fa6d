"""The learned pressure projection (the port of the JAX package's
``models/fluidnet.py``: ``scale_std`` and the fused inference path of
``make_project_fn_fused_forward``).

assemble (divergence, occupancy, std normalisation) -> PUNet forward
(ops/kernels/punet.py) -> projection tail, with the inlet BCs folded in on
the tail's input and output. The tail is ops/kernels/proj_tail.py (RHS,
warm damped-Jacobi polish, velocity update, wall BCs) or, with
``polish_impl="mg"``, one warm V-cycle of ops/kernels/mg.py::project_mg.
"""
import torch

from ..ops.kernels.mg import project_mg
from ..ops.kernels.proj_tail import project_tail
from ..ops.kernels.punet import pack_weights, punet_forward
from ..ops.stencils import flags_to_occupancy, velocity_divergence


def scale_std(x, threshold: float):
    """Per-sample input scale: std over all elements (Bessel-corrected),
    clamped below at ``threshold``."""
    y = x.reshape(x.shape[0], -1)
    return torch.clamp(torch.std(y, dim=1, correction=1), min=threshold)


def make_project_fn(cfg, net):
    """Inference projection ``project(p, U, flags, density, U_bc=None,
    U_bc_inv_mask=None) -> (p, U)`` for ``simulate_step``.

    ``cfg`` is the ``ModelConfig``, ``net`` the PUNet (its device decides
    kernel or plain path). Semantics of the JAX package's fused path: the
    normalisation 1/s is applied to the input's physical channel inside
    the forward, the tail works on un-normalised fields with
    ``p0 = p_hat * s``, and given ``U_bc``/``U_bc_inv_mask`` the inlet BCs
    are applied on the tail's input and output (``handles_const_vals``)."""
    if cfg.model != "PUNet" or cfg.punet_refine_convs != 0:
        raise NotImplementedError(
            "the port's projection runs the refine-free PUNet only "
            "(ROADMAP A.4)")
    if cfg.input_u_div:
        raise ValueError("the projection assembles a 2-channel input; "
                         "input_u_div needs 3 channels")
    packed = pack_weights(net)

    @torch.no_grad()
    def project(p, U, flags, density, U_bc=None, U_bc_inv_mask=None):
        U_in = U * U_bc_inv_mask + U_bc if U_bc is not None else U
        div = velocity_divergence(U_in, flags)
        if cfg.normalize_input:
            chan = {"pDiv": p, "UDiv": U_in, "div": div}[
                cfg.normalize_input_chan]
            s = scale_std(chan, cfg.normalize_input_threshold)
        else:
            s = torch.ones((p.shape[0],), dtype=torch.float32,
                           device=p.device)
        feat0 = p if cfg.input_p_div else div
        x = torch.stack([feat0, flags_to_occupancy(flags)], dim=-1)
        p_hat = punet_forward(net, packed, x, inv_scale=1.0 / s)[..., 0]
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
    return project
