"""Run one of the JAX package's ``scripts/*.py`` in the test process, for
the tests that hold the port's script twins to it."""
import contextlib
import io
import runpy
import sys
from pathlib import Path

from fluidnet_cxx_tpu import sim as j_sim

ROOT = Path(__file__).resolve().parent.parent


def run_jax_script(name, argv, **config):
    """JAX's ``scripts/<name>.py`` run as ``__main__`` with ``argv``, every
    ``plume_config`` call it makes given ``config`` too; returns its
    stdout."""
    plume_config = j_sim.plume_config
    old_argv = sys.argv
    out = io.StringIO()
    j_sim.plume_config = lambda **kw: plume_config(**{**kw, **config})
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(ROOT / "scripts" / f"{name}.py"),
                           run_name="__main__")
    finally:
        sys.argv = old_argv
        j_sim.plume_config = plume_config
    return out.getvalue()
