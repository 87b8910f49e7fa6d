"""Multi-device runs over ``torch.distributed`` (the twin of the JAX
package's ``parallel``): the (dp, sx) mesh and its shards
(``mesh.py``), the halo exchange and the width-sharded Jacobi solves
(``halo.py``), the width-sharded V-cycles (``multigrid.py``), the learned
projections on one receptive-field halo (``project.py``), the
width-sharded 2-D and 3-D steps (``step.py``) and the
``dryrun_multichip`` twin (``dryrun.py``). Data-parallel training is
``train/trainer.py::make_train_step(..., mesh=mesh)``."""
from .halo import (pad_columns, solve_jacobi3_sharded, solve_jacobi_sharded,
                   solve_jacobi_tol_sharded)
from .mesh import (Mesh, batch_sharding, gather_state, make_mesh,
                   replicated, state_sharding)
from .multigrid import (solve_mg3_sharded, solve_mg_learned_sharded,
                        solve_mg_sharded)
from .project import Sharding, receptive_halo
from .step import (simulate_step3_sharded, simulate_step_sharded,
                   step_halo)

__all__ = [
    "solve_jacobi_sharded", "batch_sharding", "make_mesh", "replicated",
    "state_sharding", "Mesh", "gather_state", "pad_columns",
    "solve_jacobi3_sharded", "solve_jacobi_tol_sharded",
    "simulate_step_sharded", "simulate_step3_sharded", "step_halo",
    "solve_mg_sharded", "solve_mg_learned_sharded",
    "solve_mg3_sharded", "Sharding", "receptive_halo",
]
