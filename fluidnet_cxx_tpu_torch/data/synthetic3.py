"""Synthetic 3-D training data (the port of the JAX package's
``data/synthetic3.py``): band-limited random velocity of random amplitude
plus an inlet-like jet entering from the bottom wall, on an empty box,
labelled by a long 6-neighbour Jacobi solve.

The random numbers come from a ``torch.Generator`` on the batch's device
(they are not JAX's bits); each random draw feeds a deterministic function
(``band_limited3``, ``inlet_jet3``, ``label_batch3``) that the tests hold
to the JAX package's on the numbers JAX draws. The noise is an inverse FFT
over (d, h, w), ``torch.fft`` (cuFFT on the card), as JAX computes it with
XLA's FFT outside any Pallas kernel; the labels' sweeps are kernel I on a
CUDA tensor (``ops/kernels/jacobi3.py``).
"""
import torch

from ..ops.kernels.jacobi3 import solve_jacobi3
from ..ops.ops3d import (empty_domain3, set_wall_bcs3, velocity_divergence3,
                         velocity_update3)


def band_limited3(re, im, cutoff: int = 6):
    """Real part of the inverse FFT over (d, h, w) of the spectrum ``re + i
    im`` (b, d, h, w) kept below ``cutoff`` cycles on each axis, scaled to
    unit std (population std, + 1e-8)."""
    _, d, h, w = re.shape
    dev = re.device
    fz = torch.fft.fftfreq(d, device=dev)[None, :, None, None]
    fy = torch.fft.fftfreq(h, device=dev)[None, None, :, None]
    fx = torch.fft.fftfreq(w, device=dev)[None, None, None, :]
    mask = ((fz.abs() < cutoff / d) & (fy.abs() < cutoff / h)
            & (fx.abs() < cutoff / w))
    field = torch.fft.ifftn(torch.complex(re, im) * mask,
                            dim=(1, 2, 3)).real
    std = torch.std(field, dim=(1, 2, 3), correction=0, keepdim=True)
    return (field / (std + 1e-8)).to(torch.float32)


def inlet_jet3(cz, cx, rad, jamp, d: int, h: int, w: int):
    """The upward jet jamp * exp(-((z - cz)^2 + (x - cx)^2) / rad^2) *
    exp(-y / (0.15 h)); each argument (b, 1, 1, 1)."""
    dev = cz.device
    zz = torch.arange(d, dtype=torch.float32, device=dev)[None, :, None,
                                                           None]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :,
                                                           None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None,
                                                           :]
    r2 = ((zz - cz) ** 2 + (xx - cx) ** 2) / (rad ** 2)
    return jamp * torch.exp(-r2) * torch.exp(-yy / (0.15 * h))


def label_batch3(U_div, jacobi_iters: int):
    """(U_div, flags, p_target, U_target) of a divergent batch on an empty
    box: wall BCs on the input, ``jacobi_iters`` Jacobi sweeps on its
    divergence, the velocity update and the wall BCs again."""
    b, _, d, h, w = U_div.shape
    flags = empty_domain3(b, d, h, w, device=U_div.device)
    U_div = set_wall_bcs3(U_div, flags)
    rhs = velocity_divergence3(U_div, flags)
    p = solve_jacobi3(flags, rhs, jacobi_iters)
    U_proj = set_wall_bcs3(velocity_update3(p, U_div, flags), flags)
    return U_div, flags, p, U_proj


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def generate_batch3(gen, b: int, d: int, h: int, w: int,
                    jacobi_iters: int = 400, device="cuda"):
    """(U_div, flags, p_target, U_target) of ``b`` samples on ``device``,
    drawn from ``gen`` (a generator on that device): band-limited noise of
    a random amplitude in [0.5, 3) for each velocity component, an upward
    jet of random centre, radius and strength added to v, labelled by
    ``jacobi_iters`` sweeps."""
    shape = (b, 1, 1, 1)
    amp = _uniform(gen, shape, 0.5, 3.0, device)
    comps = []
    for _ in range(3):
        re = torch.randn((b, d, h, w), generator=gen, device=device)
        im = torch.randn((b, d, h, w), generator=gen, device=device)
        comps.append(band_limited3(re, im) * amp)
    U_div = torch.stack(comps, dim=1)
    cz = _uniform(gen, shape, 0.25 * d, 0.75 * d, device)
    cx = _uniform(gen, shape, 0.25 * w, 0.75 * w, device)
    rad = _uniform(gen, shape, 0.06 * w, 0.2 * w, device)
    jamp = _uniform(gen, shape, 0.0, 2.5, device)
    U_div[:, 1] += inlet_jet3(cz, cx, rad, jamp, d, h, w)
    return label_batch3(U_div, jacobi_iters)
