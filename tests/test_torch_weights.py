"""The committed torch copies of the trained checkpoints
(``trained_models/<name>/torch_state_dict.pt``, written by
``scripts/torch_convert_checkpoints.py``) against the orbax checkpoints
read by the JAX package's loader, on the CPU.

Each file must hold exactly ``flax_to_state_dict`` (2-D: PUNet,
FluidNetTower, MultiScaleNet) or
``flax_to_state_dict3`` (3-D) of its checkpoint, tensor for tensor
(``torch.equal``). The port's 2-D forward with the loaded file equals
flax's forward with the checkpoint to 1e-4 of the output's largest
magnitude (``tests/test_torch_punet.py``'s tolerance: the two frameworks
sum each convolution in a different order). The entry points load the
file by default and never fall back to seed weights.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.models.punet import PUNet as FlaxPUNet
from fluidnet_cxx_tpu_torch.config import load_model_config
from fluidnet_cxx_tpu_torch.models.convert import (
    STATE_DICT_FILE, flax_mg_coarse_to_state_dict, flax_to_state_dict,
    flax_to_state_dict3, load_state_dict_file)
from fluidnet_cxx_tpu_torch.models.mg_coarse import CONFIG_FILE, MGCoarseNet
from fluidnet_cxx_tpu_torch.run_plume import (build_mg_coarse, build_net,
                                              weights_label)
from fluidnet_cxx_tpu_torch.run_plume3d import build_punet3

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODELS = ROOT / "trained_models"


def _script():
    """scripts/torch_convert_checkpoints.py as a module."""
    path = ROOT / "scripts" / "torch_convert_checkpoints.py"
    spec = importlib.util.spec_from_file_location("torch_convert_ckpt", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def convert():
    return _script()


MODELS_2D = ["PUNetD2_128", "DataTrain_128", "ScaleNet_jets_128",
             "ScaleNet_onDevice_128", "ScaleNet_rollout_128"]


@pytest.mark.parametrize("name", MODELS_2D + ["PUNet3p8_64", "PUNet3p8j_64",
                                              "PUNet3p8r_64", "PUNet3_32",
                                              "MGCoarse_128"])
def test_committed_file_equals_the_checkpoints_conversion(convert, name):
    """The file's tensors are the conversion of ``best`` read by the JAX
    loader, bit for bit, float32, on the CPU, and nothing else
    (DataTrain_128 and the ScaleNet_* checkpoints: their FluidNetTower_0
    and MultiScaleNet_0 subtrees, ScaleNet's names joined with "/";
    MGCoarse_128: the JAX ``load_mg_coarse`` and
    ``flax_mg_coarse_to_state_dict``, keys under ``punet.``)."""
    params = convert.flax_params(name)
    want = (flax_to_state_dict if name in MODELS_2D else
            flax_mg_coarse_to_state_dict if name == "MGCoarse_128" else
            flax_to_state_dict3)(params)
    got = load_state_dict_file(MODELS / name)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == torch.float32 and g.device.type == "cpu", key
        assert torch.equal(g, w), key


def test_trained_forward_with_the_file_matches_flax(convert, rng):
    """The port's PUNetD2_128 built from the file (``build_net``'s
    default) against flax's forward with the checkpoint at 64^2."""
    mcfg = load_model_config(str(MODELS / "PUNetD2_128"))
    params = convert.flax_params("PUNetD2_128")
    flax_net = FlaxPUNet(patch=mcfg.punet_patch, widths=mcfg.punet_widths,
                         level_convs=mcfg.punet_level_convs,
                         bottleneck_convs=mcfg.punet_bottleneck_convs,
                         bottleneck_dilation=mcfg.punet_bottleneck_dilation,
                         dtype="float32")
    x = rng.standard_normal((1, 64, 64, 2)).astype(np.float32)
    want = np.asarray(jax.jit(flax_net.apply)({"params": params},
                                              jnp.asarray(x)))
    with torch.no_grad():
        got = build_net(mcfg)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_missing_file_raises_and_names_the_script(tmp_path):
    """No file, no weights: FileNotFoundError naming the converter, from
    the loader and from both builders; a weight seed asks for seed
    weights explicitly."""
    with pytest.raises(FileNotFoundError, match="torch_convert_checkpoints"):
        load_state_dict_file(tmp_path)
    mcfg = load_model_config(str(MODELS / "PUNetD2_128"))
    with pytest.raises(FileNotFoundError, match=STATE_DICT_FILE):
        build_net(mcfg, model_dir=tmp_path)
    mcfg3 = load_model_config(str(MODELS / "PUNet3_32"))
    with pytest.raises(FileNotFoundError, match=STATE_DICT_FILE):
        build_punet3(mcfg3, model_dir=tmp_path)
    (tmp_path / CONFIG_FILE).write_text(
        (MODELS / "MGCoarse_128" / CONFIG_FILE).read_text())
    with pytest.raises(FileNotFoundError, match=STATE_DICT_FILE):
        build_mg_coarse(model_dir=tmp_path)
    assert isinstance(build_mg_coarse(0, model_dir=tmp_path), MGCoarseNet)
    seeded = build_net(mcfg, 0, model_dir=tmp_path)
    trained = build_net(mcfg)
    assert not torch.equal(seeded.convs["embed"].weight,
                           trained.convs["embed"].weight)
    assert (weights_label(None), weights_label(3)) == ("trained", "seed:3")


def test_3d_builder_loads_each_models_own_file():
    """build_punet3 loads the file of the model_dir it is given: p8's and
    p4's shapes differ, so a mix-up raises rather than loading."""
    for name in ("PUNet3p8_64", "PUNet3p8j_64", "PUNet3p8r_64",
                 "PUNet3_32"):
        mcfg = load_model_config(str(MODELS / name))
        net = build_punet3(mcfg, model_dir=MODELS / name)
        want = load_state_dict_file(MODELS / name)
        for key, w in net.state_dict().items():
            assert torch.equal(w, want[key]), (name, key)
    with pytest.raises(RuntimeError, match="size mismatch"):
        build_punet3(load_model_config(str(MODELS / "PUNet3_32")),
                     model_dir=MODELS / "PUNet3p8_64")
