"""The port stands alone: importing every module of fluidnet_cxx_tpu_torch
loads neither JAX nor the JAX package, and its entry point refuses to run
without a card unless the CPU is asked for. Each check runs in a fresh
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
assert len(names) >= 19 and not bad, bad
print('IMPORT_OK')
"""

RUN_WITHOUT_CARD = """
import torch
from fluidnet_cxx_tpu_torch.run_plume import run_plume
assert not torch.cuda.is_available()
try:
    run_plume(res=64, steps=1)
except RuntimeError as e:
    assert 'CUDA' in str(e), e
else:
    raise SystemExit('run_plume ran without a card')
print('CARD_OK')
"""


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


def test_run_plume_needs_a_card_by_default(fresh_python):
    assert "CARD_OK" in fresh_python, fresh_python
