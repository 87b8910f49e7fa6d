"""The port stands alone: importing every module of fluidnet_cxx_tpu_torch
loads neither JAX nor the JAX package, and each of its entry points refuses
to run without a card unless the CPU is asked for. Each check runs in a fresh
interpreter, since the test process itself has both packages loaded."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import importlib, pkgutil, sys
import fluidnet_cxx_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'fluidnet_cxx_tpu'))
print(len(names), bad)
assert len(names) >= 43 and not bad, bad
assert 'fluidnet_cxx_tpu_torch.models.mg_coarse' in names, names
for mod in ('train.trainer', 'train.losses', 'train.checkpoint',
            'train.__main__', 'data.dataset', 'data.manta_io',
            'data.synthetic', 'utils.diagnostics', 'ops.kernels.conv_grad',
            'utils.vtk_export', 'utils.plotting', 'scripts',
            'scripts.run_plume', 'scripts.run_rayleigh_taylor',
            'scripts.run_cylinder', 'scripts.train_mg_coarse',
            'ops.kernels.conv_grad3', 'scripts.run_blob3d',
            'scripts.eval_parity', 'scripts.quality_per_ms',
            'scripts.make_dataset', 'scripts.preprocess_data',
            'ops.advection', 'ops.grid', 'ops.line_trace',
            'ops.line_trace3', 'ops.window', 'ops.window3'):
    assert 'fluidnet_cxx_tpu_torch.' + mod in names, (mod, names)
# PyYAML and matplotlib are not imported with the port, and the YAML
# reader runs with PyYAML made unimportable.
assert 'yaml' not in sys.modules and 'matplotlib' not in sys.modules
sys.modules['yaml'] = None
from fluidnet_cxx_tpu_torch.config import load_yaml
assert load_yaml('configs/train.yaml')['modelParam']['lr'] == 5e-5
del sys.modules['yaml']
print('IMPORT_OK')
"""

# Each entry point at a small size; without a card each must refuse. The
# key names the case, its module is the key's part before the first '.'
# (or MODULES' entry for it), and the call's function is imported from
# that module.
ENTRY_POINTS = {
    "run_plume": "run_plume(res=64, steps=1)",
    "run_plume.mg_learned": "run_plume(res=256, steps=1, "
                            "sim_method='mg_learned')",
    "run_cylinder.multigrid": "run_cylinder(res_x=256, res_y=64, steps=1, "
                              "radius=8.0, center_x=40.0, "
                              "sim_method='multigrid')",
    "run_cylinder.convnet": "run_cylinder(res_x=256, res_y=64, steps=1, "
                            "radius=8.0, center_x=40.0, "
                            "sim_method='convnet')",
    "run_rayleigh_taylor": "run_rayleigh_taylor(res_x=32, res_y=64, steps=1)",
    "run_cylinder": "run_cylinder(res_x=256, res_y=64, steps=1, radius=8.0, "
                    "center_x=40.0)",
    "run_plume3d": "run_plume3d(res=16, steps=1)",
    "run_plume3d.convnet": "run_plume3d(res=16, steps=1, "
                           "sim_method='convnet')",
    "bench": "main(['--res', '32', '--cases', 'jacobi28', '--small-steps', "
             "'2', '--chunk', '1', '--n-eager', '1', '--reps', '1'])",
    "bench3d": "main(['--res', '16', '--steps', '1', '--reps', '1'])",
    "train": "main(['--onDevice', '1', '--res', '16', '--bsz', '2', "
             "'--modelDir', 'unused'])",
    "train.dataset": "main(['--synthetic', '1', '--res', '16', "
                     "'--modelDir', 'unused'])",
    "train.trainConfig": "main(['--trainConfig', 'configs/train.yaml', "
                         "'--onDevice', '1', '--res', '16', '--bsz', '2', "
                         "'--modelDir', 'unused'])",
    "twin_plume": "main(['--simConf', 'configs/plume.yaml', '--resX', "
                  "'32', '--resY', '32', '--maxIter', '1', "
                  "'--outputFolder', 'unused'])",
    "twin_rayleigh_taylor": "main(['--simConf', "
                            "'configs/rayleighTaylor.yaml', '--maxIter', "
                            "'1', '--outputFolder', 'unused'])",
    "twin_cylinder": "main(['--resX', '256', '--resY', '64', '--radius', "
                     "'8', '--centerX', '40', '--maxIter', '1', "
                     "'--outputFolder', 'unused'])",
    "twin_train_mg_coarse": "main(['--res', '64', '--coarseSize', '32', "
                            "'--frames', '2', '--steps', '1', "
                            "'--modelDir', 'unused'])",
    "twin_run_blob3d": "main(['--res', '16', '--maxIter', '1', "
                       "'--statIter', '1', '--outputFolder', 'unused'])",
    "twin_eval_parity": "main(['--res', '32', '--iters', '2', "
                        "'--statIter', '1', '--out', 'unused'])",
    "twin_quality_per_ms": "main(['--modelDir', "
                           "'trained_models/PUNetD2_128', '--res', '32', "
                           "'--iters', '2', '--statIter', '1', "
                           "'--out', 'unused/qpm.json'])",
    "twin_make_dataset": "main(['--res', '32', '--scenesTr', '1', "
                         "'--scenesTe', '0', '--out', 'unused'])",
    "bench3d.xla": "main(['--res', '16', '--steps', '1', '--reps', '1', "
                   "'--xla'])",
}
# The training entry point is run as ``python -m fluidnet_cxx_tpu_torch.
# train``: its main() lives in train/__main__.py; the scene drivers' twins
# as ``python -m fluidnet_cxx_tpu_torch.scripts.<name>``.
MODULES = {"train": "train.__main__", "twin_plume": "scripts.run_plume",
           "twin_rayleigh_taylor": "scripts.run_rayleigh_taylor",
           "twin_cylinder": "scripts.run_cylinder",
           "twin_train_mg_coarse": "scripts.train_mg_coarse",
           "twin_run_blob3d": "scripts.run_blob3d",
           "twin_eval_parity": "scripts.eval_parity",
           "twin_quality_per_ms": "scripts.quality_per_ms",
           "twin_make_dataset": "scripts.make_dataset"}

RUN_WITHOUT_CARD = """
import torch
assert not torch.cuda.is_available()
""" + "".join(f"""
from fluidnet_cxx_tpu_torch.{MODULES.get(name.split('.')[0], name.split('.')[0])} import {call.split('(')[0]}
try:
    {call}
except RuntimeError as e:
    assert 'CUDA' in str(e), e
    print('CARD_OK {name}')
else:
    raise SystemExit('{name} ran without a card')
""" for name, call in ENTRY_POINTS.items())


@pytest.fixture(scope="module")
def fresh_python():
    """Both checks in one fresh interpreter (torch's import dominates its
    time); returns its output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL + RUN_WITHOUT_CARD],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    return res.stdout + res.stderr


def test_port_imports_no_jax(fresh_python):
    assert "IMPORT_OK" in fresh_python, fresh_python


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_run_plume_needs_a_card_by_default(fresh_python, entry):
    """Each entry point (run_plume and its siblings) raises without a card
    unless the CPU is asked for."""
    assert f"CARD_OK {entry}\n" in fresh_python, fresh_python
