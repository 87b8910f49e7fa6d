"""Training losses (the port of the JAX package's ``train/losses.py``): the
reference's 5-term objective

total = pL2*MSE(p, p_t) + divL2*MSE(div(U), 0) + pL1*L1(p, p_t)
      + divL1*L1(div(U), 0) + divLT*MSE(div(U_longterm), 0)

``mask`` (optional, (b, h, w)) excludes cells from the divergence terms:
the inlet cells of a plume rollout frame, which the step clamps again after
the projection, so their divergence is not the projection's to remove.
"""
from typing import NamedTuple

import torch

from ..ops.stencils import velocity_divergence


class LossTerms(NamedTuple):
    total: torch.Tensor
    p_l2: torch.Tensor
    div_l2: torch.Tensor
    p_l1: torch.Tensor
    div_l1: torch.Tensor
    div_lt: torch.Tensor


def _masked_mean(x, mask):
    if mask is None:
        return torch.mean(x)
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def short_term_losses(cfg, p_out, U_out, flags, p_target, mask=None):
    """(p_l2, div_l2, p_l1, div_l1), each times its weight in ``cfg``."""
    out_div = velocity_divergence(U_out, flags)
    p_l2 = cfg.p_l2_lambda * torch.mean((p_out - p_target) ** 2)
    div_l2 = cfg.div_l2_lambda * _masked_mean(out_div ** 2, mask)
    p_l1 = cfg.p_l1_lambda * torch.mean(torch.abs(p_out - p_target))
    div_l1 = cfg.div_l1_lambda * _masked_mean(torch.abs(out_div), mask)
    return p_l2, div_l2, p_l1, div_l1


def long_term_loss(cfg, U_lt, flags, mask=None):
    div_lt = velocity_divergence(U_lt, flags)
    return cfg.div_lt_lambda * _masked_mean(div_lt ** 2, mask)
