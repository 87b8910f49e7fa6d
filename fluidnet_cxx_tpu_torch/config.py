"""Simulation and model configuration.

``SimConfig`` and ``ModelConfig`` keep the field names and defaults of the
JAX package's ``config.py`` so a configuration reads the same in both.
Only the JSON ``model_config.json`` reader is ported here; the YAML loader
is still to come (ROADMAP A.3).
"""
import dataclasses
import json
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics/step parameters."""
    dt: float = 0.1
    maccormack_strength: float = 0.6
    sample_outside_fluid: bool = False
    buoyancy_scale: float = 0.0
    gravity_scale: float = 0.0
    gravity_vec: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    operating_density: float = 0.0
    viscosity: float = 0.0
    vorticity_confinement: float = 0.0
    correct_scalar: bool = False
    p_tol: float = 0.0
    jacobi_iter: int = 34
    periodic_x: bool = False
    periodic_y: bool = False
    periodic_z: bool = False
    advection_method: str = "maccormackFluidNet"
    sim_method: str = "jacobi"
    mg_vcycles: int = 2
    mg_pre: int = 4
    mg_post: int = 4
    mg_coarse_iters: int = 32
    mg_warm_start: bool = True
    mg_max_levels3: int = 3
    mg_post3: int = 8
    advection_impl: str = "window"
    max_disp: int = 4
    advect_density: bool = True
    line_trace: bool = True
    line_trace_impl: str = "march"
    use_pallas: bool = False
    fuse_advection: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network architecture parameters."""
    model: str = "FluidNet"
    input_div: bool = True
    input_p_div: bool = False
    input_u_div: bool = False
    normalize_input: bool = True
    normalize_input_chan: str = "UDiv"
    normalize_input_threshold: float = 1e-5
    dropout: bool = False
    compute_dtype: str = "float32"
    punet_patch: int = 8
    punet_widths: Tuple[int, ...] = (128, 128)
    punet_level_convs: int = 1
    punet_bottleneck_convs: int = 3
    punet_bottleneck_dilation: int = 1
    punet_refine_ch: int = 8
    punet_refine_convs: int = 0
    polish_sweeps: int = 0
    polish_impl: str = "xla"
    polish_damping: float = 2.0 / 3.0

    @property
    def in_dims(self) -> int:
        n = 1
        if self.input_p_div:
            n += 1
        elif self.input_u_div:
            n += 2
        elif self.input_div:
            n += 1
        return n


def load_model_config(model_dir: str) -> ModelConfig:
    """Read ``<model_dir>/model_config.json`` (the file the JAX trainer
    writes beside its checkpoints). JSON lists come back as tuples."""
    with open(os.path.join(model_dir, "model_config.json")) as f:
        d = json.load(f)
    d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return ModelConfig(**d)
