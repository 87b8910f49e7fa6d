"""Mantaflow .bin snapshot I/O (the port of the JAX package's
``data/manta_io.py``, its numpy reader and writer; the C++ fast path of
``native/`` is ROADMAP A.9).

File format: 5 int32 header (transpose, nx, ny, nz, is3D), then float32
Ux, Uy, p [, Uz] blobs, an int32 flags blob and a float32 density blob,
each nx*ny*nz elements. A 2-D file reads into the framework's layout:
scalars (h, w), velocity (2, h, w).
"""
import struct

import numpy as np


def load_manta_file(path: str):
    """(p, U, flags, density, is3d) as numpy arrays without the batch dim:
    p, flags, density (nz, ny, nx), squeezed to (ny, nx) in 2-D; U (2|3,
    ny, nx) (3-D: (3, nz, ny, nx))."""
    with open(path, "rb") as f:
        _, nx, ny, nz, is3d_i = struct.unpack("i" * 5, f.read(20))
        is3d = is3d_i == 1
        numel = nx * ny * nz
        main = np.frombuffer(f.read(4 * 3 * numel), dtype=np.float32)
        ux = main[:numel].reshape(nz, ny, nx)
        uy = main[numel: 2 * numel].reshape(nz, ny, nx)
        p = main[2 * numel:].reshape(nz, ny, nx)
        if is3d:
            uz = np.frombuffer(f.read(4 * numel),
                               dtype=np.float32).reshape(nz, ny, nx)
        flags = np.frombuffer(f.read(4 * numel),
                              dtype=np.int32).reshape(nz, ny, nx)
        density = np.frombuffer(f.read(4 * numel),
                                dtype=np.float32).reshape(nz, ny, nx)
    if is3d:
        return p, np.stack([ux, uy, uz]), flags, density, True
    return p[0], np.stack([ux[0], uy[0]]), flags[0], density[0], False


def save_manta_file(path: str, p, U, flags, density):
    """Write a 2-D snapshot in the Manta .bin layout."""
    h, w = p.shape
    with open(path, "wb") as f:
        f.write(struct.pack("i" * 5, 0, w, h, 1, 0))
        for a, dt in ((U[0], np.float32), (U[1], np.float32),
                      (p, np.float32), (flags, np.int32),
                      (density, np.float32)):
            f.write(np.asarray(a, dt).tobytes())


def save_manta_file3d(path: str, p, U, flags, density):
    """Write a 3-D snapshot: header, then Ux, Uy, p, Uz, flags, density
    (Uz comes after p in an is3D file)."""
    d, h, w = p.shape
    with open(path, "wb") as f:
        f.write(struct.pack("i" * 5, 0, w, h, d, 1))
        for a, dt in ((U[0], np.float32), (U[1], np.float32),
                      (p, np.float32), (U[2], np.float32),
                      (flags, np.int32), (density, np.float32)):
            f.write(np.asarray(a, dt).tobytes())
