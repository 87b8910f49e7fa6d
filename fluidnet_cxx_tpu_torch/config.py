"""Simulation, model and training configuration.

``SimConfig``, ``ModelConfig`` and ``TrainConfig`` keep the field names and
defaults of the JAX package's ``config.py`` so a configuration reads the
same in both; ``TrainConfig``'s defaults are ``configs/train.yaml``'s
values. Only the JSON ``model_config.json`` reader and writer are ported
here; the YAML loader is still to come (ROADMAP A.3).
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop parameters: the 5-term loss's weights, the long-term
    rollout's randomised physics and the plateau scheduler."""
    batch_size: int = 64
    max_epochs: int = 400
    lr: float = 5e-5
    p_l2_lambda: float = 0.0
    div_l2_lambda: float = 1.0
    p_l1_lambda: float = 0.0
    div_l1_lambda: float = 0.0
    div_lt_lambda: float = 1.0
    lt_num_steps: Tuple[int, int] = (4, 16)
    lt_probability: float = 0.9
    train_buoyancy_scale: float = 2.0
    train_buoyancy_prob: float = 0.3
    train_gravity_scale: float = 0.0
    train_gravity_prob: float = 0.0
    time_scale_sigma: float = 1.0
    plateau_factor: float = 0.6
    plateau_patience: int = 10
    plateau_threshold: float = 3e-4


def save_model_config(model_dir: str, cfg: ModelConfig):
    """Write ``<model_dir>/model_config.json`` in the JAX trainer's layout
    (the dataclass's fields, indent 2)."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "model_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_model_config(model_dir: str) -> ModelConfig:
    """Read ``<model_dir>/model_config.json`` (the file the JAX trainer
    writes beside its checkpoints). JSON lists come back as tuples."""
    with open(os.path.join(model_dir, "model_config.json")) as f:
        d = json.load(f)
    d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    return ModelConfig(**d)
