"""Simulation state: a NamedTuple of tensors.

Layout: scalars ``(b, h, w)``, MAC velocity ``(b, 2, h, w)``, flags int32.
The optional fields are the constant-value BC masks
(``x = x * inv_mask + bc``) and the stick flags, as in the JAX package.
``from_reference_layout`` and ``to_reference_layout`` convert from and to
the reference's 5-D ``(b, c, 1, h, w)`` arrays.
"""
from typing import NamedTuple, Optional

import numpy as np
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


def from_reference_layout(p5, U5, flags5, density5, device="cpu"):
    """A SimState on ``device`` from the reference's 5-D ``(b, c, 1, h,
    w)`` arrays (numpy arrays or tensors; e.g. a Manta ``.bin`` frame)."""
    def t(a, dtype):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return SimState(p=t(p5, torch.float32)[:, 0, 0],
                    U=t(U5, torch.float32)[:, :, 0],
                    flags=t(flags5, torch.int32)[:, 0, 0],
                    density=t(density5, torch.float32)[:, 0, 0])


def to_reference_layout(state: SimState):
    """(p, U, flags, density) as the reference's 5-D numpy arrays, the
    flags as float32."""
    def host(a):
        return a.detach().cpu().numpy()

    return (host(state.p)[:, None, None], host(state.U)[:, :, None],
            host(state.flags).astype(np.float32)[:, None, None],
            host(state.density)[:, None, None])
