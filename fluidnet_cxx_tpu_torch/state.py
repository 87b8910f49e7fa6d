"""Simulation state: a NamedTuple of tensors.

Layout: scalars ``(b, h, w)``, MAC velocity ``(b, 2, h, w)``, flags int32.
The optional fields are the constant-value BC masks
(``x = x * inv_mask + bc``) and the stick flags, as in the JAX package.
"""
from typing import NamedTuple, Optional

import torch

from .ops.stencils import empty_domain


class SimState(NamedTuple):
    p: torch.Tensor
    U: torch.Tensor
    flags: torch.Tensor
    density: torch.Tensor
    U_bc: Optional[torch.Tensor] = None
    U_bc_inv_mask: Optional[torch.Tensor] = None
    density_bc: Optional[torch.Tensor] = None
    density_bc_inv_mask: Optional[torch.Tensor] = None
    flags_stick: Optional[torch.Tensor] = None


def create_state(b: int, h: int, w: int, bnd: int = 1,
                 device="cpu") -> SimState:
    """Zeroed fields over an empty domain (fluid interior, obstacle wall)."""
    z = dict(dtype=torch.float32, device=device)
    return SimState(
        p=torch.zeros((b, h, w), **z),
        U=torch.zeros((b, 2, h, w), **z),
        flags=empty_domain(b, h, w, bnd, device=device),
        density=torch.zeros((b, h, w), **z),
    )
