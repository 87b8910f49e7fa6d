"""Synthetic training data, 2-D (the port of the JAX package's
``data/synthetic.py``): smooth random velocity fields with Gaussian jets,
random disc obstacles and density blobs, labelled by a long Jacobi solve
(the classical solver is the label source, the role Mantaflow plays for
the reference).

The random numbers come from a ``torch.Generator`` on the batch's device
(they are not JAX's bits); each random draw feeds a deterministic function
(``band_limited``, ``disc_flags``, ``gaussian_bumps``, ``label_batch``)
that the tests hold to the JAX package's on the numbers JAX draws. The
band-limited noise is an inverse FFT, ``torch.fft`` (cuFFT on the card),
as JAX computes it with XLA's FFT outside any Pallas kernel; the labels'
600 sweeps are kernel F on a CUDA tensor (``ops/kernels/jacobi.py``).
"""
import os

import numpy as np
import torch

from ..celltype import FLUID, OBSTACLE
from ..ops.kernels.jacobi import solve_jacobi
from ..ops.stencils import (empty_domain, set_wall_bcs, velocity_divergence,
                            velocity_update)
from .dataset import Sample


def band_limited(re, im, cutoff: int = 8):
    """Real part of the inverse FFT of the spectrum ``re + i im`` (b, h, w)
    kept below ``cutoff`` cycles on each axis, scaled to unit std."""
    _, h, w = re.shape
    fy = torch.fft.fftfreq(h, device=re.device)[None, :, None]
    fx = torch.fft.fftfreq(w, device=re.device)[None, None, :]
    mask = (fy.abs() < cutoff / h) & (fx.abs() < cutoff / w)
    field = torch.fft.ifft2(torch.complex(re, im) * mask).real
    std = torch.std(field, dim=(1, 2), correction=0, keepdim=True)
    return (field / (std + 1e-8)).to(torch.float32)


def disc_flags(n, cx, cy, r, h: int, w: int):
    """Empty-domain flags with the first ``n[i]`` of each sample's discs
    (centres ``cx``, ``cy`` and radii ``r``, (b, max_discs)) made
    obstacle."""
    b = n.shape[0]
    dev = cx.device
    X = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    Y = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    inside = ((X - cx[..., None, None]) ** 2 + (Y - cy[..., None, None]) ** 2
              <= (r ** 2)[..., None, None])
    active = (torch.arange(cx.shape[1], device=dev)[None, :]
              < n[:, None])[..., None, None]
    hit = torch.any(inside & active, dim=1)
    return torch.where(hit, OBSTACLE,
                       empty_domain(b, h, w, device=dev)).to(torch.int32)


def gaussian_bumps(cx, cy, sg, amp, h: int, w: int):
    """Sum over the bumps of amp * exp(-|x - c|^2 / (2 sg^2)); each
    argument (b, n, 1, 1)."""
    dev = cx.device
    X = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    Y = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    g = amp * torch.exp(-((X - cx) ** 2 + (Y - cy) ** 2) / (2 * sg ** 2))
    return torch.sum(g, dim=1)


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def _smooth_noise(gen, b, h, w, device):
    re = torch.randn((b, h, w), generator=gen, device=device)
    im = torch.randn((b, h, w), generator=gen, device=device)
    return band_limited(re, im)


def _random_obstacles(gen, b, h, w, device, max_discs=3):
    n = torch.randint(0, max_discs + 1, (b,), generator=gen, device=device)
    cx = _uniform(gen, (b, max_discs), 0.2 * w, 0.8 * w, device)
    cy = _uniform(gen, (b, max_discs), 0.2 * h, 0.8 * h, device)
    r = _uniform(gen, (b, max_discs), 0.03 * min(h, w), 0.12 * min(h, w),
                 device)
    return disc_flags(n, cx, cy, r, h, w)


def _bumps(gen, b, h, w, device, n=3, sigma_frac=(0.02, 0.12)):
    shape = (b, n, 1, 1)
    cx = _uniform(gen, shape, 0.1 * w, 0.9 * w, device)
    cy = _uniform(gen, shape, 0.1 * h, 0.9 * h, device)
    sg = _uniform(gen, shape, sigma_frac[0] * w, sigma_frac[1] * w, device)
    amp = _uniform(gen, shape, -1.0, 1.0, device)
    return gaussian_bumps(cx, cy, sg, amp, h, w)


def label_batch(U_div, flags, density, jacobi_iters: int):
    """The labelled Sample of a divergent batch: wall BCs on the input,
    ``jacobi_iters`` Jacobi sweeps on its divergence, the velocity update
    and the wall BCs again."""
    U_div = set_wall_bcs(U_div, flags)
    p = solve_jacobi(flags, velocity_divergence(U_div, flags), jacobi_iters)
    U_proj = set_wall_bcs(velocity_update(p, U_div, flags), flags)
    return Sample(p_div=torch.zeros_like(p), U_div=U_div, flags=flags,
                  density_div=density, p_target=p, U_target=U_proj,
                  density_target=density)


def generate_batch(gen, b: int, h: int, w: int, jacobi_iters: int = 600,
                   device="cuda"):
    """A Sample of ``b`` (divergent input, projected target) pairs on
    ``device``, drawn from ``gen`` (a generator on that device): smooth
    noise of random amplitude plus Gaussian jets for each velocity
    component, up to 3 discs, a density of noise and blobs in [0, 1] on
    the fluid cells."""
    amp = _uniform(gen, (b, 1, 1), 0.5, 4.0, device)
    jet_amp = _uniform(gen, (b, 1, 1), 0.0, 4.0, device)
    u = (_smooth_noise(gen, b, h, w, device) * amp
         + _bumps(gen, b, h, w, device) * jet_amp)
    v = (_smooth_noise(gen, b, h, w, device) * amp
         + _bumps(gen, b, h, w, device) * jet_amp)
    flags = _random_obstacles(gen, b, h, w, device)
    density = torch.clamp(_smooth_noise(gen, b, h, w, device) * 0.5 + 0.5
                          + _bumps(gen, b, h, w, device), 0.0, 1.0)
    density = torch.where(flags == FLUID, density, 0.0)
    return label_batch(torch.stack([u, v], dim=1), flags, density,
                       jacobi_iters)


def write_synthetic_dataset(out_dir: str, n_scenes: int,
                            steps_per_scene: int = 4, h: int = 128,
                            w: int = 128, seed: int = 0,
                            jacobi_iters: int = 600, device="cuda"):
    """Write ``n_scenes`` scenes of ``steps_per_scene`` synthetic frames in
    the ``.npz`` scene layout (data/dataset.py), drawn on ``device`` from a
    generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for s in range(n_scenes):
        batch = generate_batch(gen, steps_per_scene, h, w, jacobi_iters,
                               device)
        host = {k: getattr(batch, k).cpu().numpy() for k in Sample._fields}
        scene_dir = os.path.join(out_dir, f"{s:06d}")
        os.makedirs(scene_dir, exist_ok=True)
        for t in range(steps_per_scene):
            np.savez(os.path.join(scene_dir, f"{t:06d}.npz"),
                     **{k: v[t] for k, v in host.items()})
