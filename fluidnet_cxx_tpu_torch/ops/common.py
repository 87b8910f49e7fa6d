"""Shared tensor helpers for the 2-D MAC-grid ops.

Layout: scalar fields ``(b, h, w)``; MAC velocity and positions
``(b, 2, h, w)`` with channel 0 = x; cell centres at ``idx + 0.5``.
"""
import torch

F32 = torch.float32
I32 = torch.int32


def nb(a, dy: int, dx: int):
    """Neighbour view: result[..., y, x] = a[..., y+dy, x+dx] (circular).

    Every caller masks the wrapped border ring, as in the JAX package."""
    if dy == 0 and dx == 0:
        return a
    return torch.roll(a, shifts=(-dy, -dx), dims=(-2, -1))


def border_mask(h: int, w: int, bnd: int = 1, device="cpu"):
    """Boolean (h, w) mask, True on the ``bnd``-wide border ring."""
    yy = torch.arange(h, dtype=I32, device=device)[:, None]
    xx = torch.arange(w, dtype=I32, device=device)[None, :]
    return (xx < bnd) | (xx > w - 1 - bnd) | (yy < bnd) | (yy > h - 1 - bnd)


def interior_mask(h: int, w: int, bnd: int = 1, device="cpu"):
    """Boolean (h, w) mask, True inside the ``bnd``-wide border ring."""
    return ~border_mask(h, w, bnd, device)


def gather2d(src, yi, xi):
    """Batched gather: out[b, y, x] = src[b, yi[b, y, x], xi[b, y, x]] for
    in-range integer index grids (b, h, w)."""
    b, h, w = src.shape
    idx = (yi.long() * w + xi.long()).reshape(b, h * w)
    return torch.gather(src.reshape(b, h * w), 1, idx).reshape(b, h, w)


def cell_index_grid(b: int, h: int, w: int, device="cpu"):
    """Integer (x, y) index grids, each (b, h, w)."""
    xx = torch.arange(w, dtype=I32, device=device)[None, None, :].expand(
        b, h, w)
    yy = torch.arange(h, dtype=I32, device=device)[None, :, None].expand(
        b, h, w)
    return xx, yy


def where0(mask, a):
    """``a`` where ``mask``, else 0 (``jnp.where(mask, a, 0.0)``)."""
    return torch.where(mask, a, torch.zeros((), dtype=a.dtype,
                                            device=a.device))
