"""The (dp, sx) device mesh over ``torch.distributed`` (the twin of the JAX
package's ``parallel/mesh.py``).

Two axes, as in JAX:

* ``dp``: data parallelism over the training batch;
* ``sx``: the grid's width (the last axis of every field) split into
  contiguous equal slabs, the spatial decomposition that the 8000x800
  cylinder asks for.

The world is dp x sx ranks, one device a rank; rank r sits at
``(r // sx, r % sx)``. ``Mesh.row`` is the group of the sx ranks of one dp
index (they exchange halos, ``parallel/halo.py``), ``Mesh.col`` the group
of the dp ranks of one sx index (they average gradients,
``train/trainer.py``).

Where JAX places a global array with a ``NamedSharding``, the port hands
each rank its shard: ``batch_sharding`` and ``state_sharding`` cut this
rank's slab of a tensor, a ``Batch`` or a ``SimState`` (batch over dp,
width over sx), ``replicated`` moves the whole of it to the rank's device,
and ``gather_state`` puts the shards together again (for tests and
outputs). A batch or a width that the mesh does not divide raises
``ValueError``: JAX's mesh cannot split it either.

The backend is an explicit argument and is never switched. "nccl" (the
default) runs one rank a card, ``cuda:{LOCAL_RANK}``. "gloo" runs the CPU
tests, and several ranks on one card (NCCL refuses two ranks on one
device). Gloo's ``send``/``recv`` take CPU tensors only: under gloo with
CUDA tensors the halo exchange copies its edge columns through pinned host
buffers, explicitly; the collectives gloo runs on CUDA tensors
(``all_reduce``, ``broadcast``) stay on the card.
"""
import datetime
import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _tree_map(fn, tree):
    """``fn`` of a tensor, or of each tensor field of a NamedTuple (None
    fields stay None)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(None if t is None else fn(t) for t in tree))


def mesh_device(backend: str, device="cuda") -> torch.device:
    """This rank's device: "cuda" is ``cuda:{LOCAL_RANK}`` (modulo the
    cards there are, so ranks under gloo may share one), "cpu" the CPU,
    which NCCL cannot run."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs CUDA tensors: pass backend='gloo' "
                             "for ranks on the CPU")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' and "
                           "backend='gloo' to run the ranks on the CPU")
    if dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


class Mesh:
    """A (dp, sx) mesh over the initialised process group. Counts the halo
    exchanges (``exchanges``) and the pressure solves' kernel calls
    (``solver_calls``) made through it."""

    def __init__(self, dp: int, sx: int, backend: str, device):
        self.dp, self.sx = dp, sx
        self.backend, self.device = backend, device
        self.rank = dist.get_rank()
        self.dp_index, self.sx_index = divmod(self.rank, sx)
        # Every rank creates every group, in the same order.
        rows = [dist.new_group([d * sx + s for s in range(sx)])
                for d in range(dp)]
        cols = [dist.new_group([d * sx + s for d in range(dp)])
                for s in range(sx)]
        self.row, self.col = rows[self.dp_index], cols[self.sx_index]
        self.exchanges = 0
        self.solver_calls = 0

    def rank_of(self, dp_index: int, sx_index: int) -> int:
        return dp_index * self.sx + sx_index

    @property
    def staged(self) -> bool:
        """Whether point-to-point messages go through host buffers (gloo
        with CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def __repr__(self):
        return (f"Mesh(dp={self.dp}, sx={self.sx}, rank={self.rank} at "
                f"({self.dp_index}, {self.sx_index}), {self.backend}, "
                f"{self.device})")


def make_mesh(n_devices: int = None, dp: int = None, sx: int = None,
              backend: str = "nccl", device="cuda",
              init_method: str = "env://", timeout_s: float = 600.0) -> Mesh:
    """Build a (dp, sx) mesh of ``n_devices`` ranks (default: the world).
    JAX's defaults: everything on dp, with sx given a factor of 2 when
    there is one. Initialises the process group with ``backend`` from
    ``init_method`` (torchrun's environment by default) unless it is
    initialised already, and then it must run ``backend``."""
    if dist.is_initialized() and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not "
                         f"{backend}: the mesh never switches backends")
    dev = mesh_device(backend, device)
    if dev.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method,
            timeout=datetime.timedelta(seconds=timeout_s))
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    return Mesh(*mesh_shape(n, dp, sx), backend, dev)


def mesh_shape(n: int, dp: int = None, sx: int = None):
    """(dp, sx) of a mesh of ``n`` ranks, JAX's ``make_mesh`` rule:
    everything on dp, sx a factor of 2 when there is one."""
    if dp is None and sx is None:
        sx = 2 if n % 2 == 0 and n > 1 else 1
        dp = n // sx
    elif dp is None:
        dp = n // sx
    elif sx is None:
        sx = n // dp
    assert dp * sx == n, f"mesh {dp}x{sx} != {n} devices"
    return dp, sx


def shard(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``x`` (b, ..., w): its dp index's contiguous
    b / dp batch entries and its sx index's w / sx columns, on the rank's
    device."""
    b, w = x.shape[0], x.shape[-1]
    if b % mesh.dp or w % mesh.sx:
        raise ValueError(f"a shape {tuple(x.shape)} does not split over a "
                         f"{mesh.dp}x{mesh.sx} mesh (batch over dp, width "
                         "over sx, in equal parts)")
    bl, wl = b // mesh.dp, w // mesh.sx
    i, j = mesh.dp_index * bl, mesh.sx_index * wl
    return x[i:i + bl, ..., j:j + wl].contiguous().to(mesh.device)


def batch_sharding(mesh: Mesh, batch):
    """This rank's shard of a trainer ``Batch`` (or a tensor): batch over
    dp, width over sx."""
    return _tree_map(lambda t: shard(mesh, t), batch)


def state_sharding(mesh: Mesh, state):
    """This rank's shard of a ``SimState`` or ``SimState3`` (or a tensor):
    width over sx, batch over dp."""
    return _tree_map(lambda t: shard(mesh, t), state)


def replicated(mesh: Mesh, tree):
    """The whole of a tensor or NamedTuple of tensors on the rank's
    device."""
    return _tree_map(lambda t: t.to(mesh.device), tree)


def _all_gather(x, group, dim, staged):
    """``x`` of every rank of ``group``, concatenated along ``dim`` in rank
    order (through the host under ``staged``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def gather_state(mesh: Mesh, tree):
    """The global tensor (or NamedTuple) from every rank's shard, on every
    rank: the sx slabs side by side, then the dp batches."""
    return _tree_map(
        lambda t: _all_gather(_all_gather(t, mesh.row, -1, mesh.staged),
                              mesh.col, 0, mesh.staged), tree)
