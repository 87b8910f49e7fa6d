"""VTK structured-points export for ParaView (the port of the JAX
package's ``utils/vtk_export.py``): density, pressure, divergence, flags,
cell-centred velocity and the gradients of p and density, and any extra
scalar fields, as legacy ASCII VTK.
"""
import os

import numpy as np
import torch

from ..ops.grid import get_centered
from ..ops.stencils import velocity_divergence


def _grad_centered(f):
    """Central-difference gradient of a (h, w) field (one-sided at the
    edges), in float64."""
    gy, gx = np.gradient(f.astype(np.float64))
    return gx, gy


def write_vtk(path: str, state, extra_fields=None):
    """Write batch 0 of ``state`` (a SimState) as legacy VTK
    STRUCTURED_POINTS; the fields are computed on the state's device and
    copied to the host in one transfer. ``extra_fields`` ({name: (h, w)
    tensor or array}) are written after them as scalars."""
    with torch.no_grad():
        cc = get_centered(state.U)[0]
        div = velocity_divergence(state.U, state.flags)[0]
        fields = torch.stack([state.p[0], state.density[0],
                              state.flags[0].to(torch.float32), cc[0],
                              cc[1], div]).cpu().numpy()
    p, rho, flags, u, v, div = fields
    h, w = p.shape
    gpx, gpy = _grad_centered(p)
    grx, gry = _grad_centered(rho)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("fluidnet_cxx_tpu snapshot\nASCII\n")
        f.write("DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {w} {h} 1\n")
        f.write("ORIGIN 0 0 0\nSPACING 1 1 1\n")
        f.write(f"POINT_DATA {h * w}\n")

        def scal(name, a):
            f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
            np.savetxt(f, a.reshape(-1, 1), fmt="%.6g")

        def vec(name, ax, ay):
            f.write(f"VECTORS {name} float\n")
            np.savetxt(f, np.stack([ax.ravel(), ay.ravel(),
                                    np.zeros(ax.size)], axis=1), fmt="%.6g")

        scal("density", rho)
        scal("pressure", p)
        scal("divergence", div)
        scal("flags", flags)
        vec("velocity", u, v)
        vec("grad_p", gpx, gpy)
        vec("grad_rho", grx, gry)
        for name, a in (extra_fields or {}).items():
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            scal(name, np.asarray(a))
