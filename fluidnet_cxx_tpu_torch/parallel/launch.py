"""Start ranks without a launcher: ``spawn(fn, world, args)`` runs
``fn(*args)`` in ``world`` fresh processes (the spawn start method), each
with its process group initialised from a ``FileStore`` (no port), and
fails if a rank fails or outlives its deadline. ``torchrun`` needs none of
this: there ``make_mesh`` initialises from the environment."""
import datetime
import os
import tempfile
import time

import torch.distributed as dist
import torch.multiprocessing as mp


def init_rank(rank: int, world: int, store_path: str, backend: str,
              timeout_s: float):
    """Join the process group of ``world`` ranks as ``rank`` through the
    file ``store_path``; collectives time out after ``timeout_s``."""
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def _entry(fn, rank, world, store_path, backend, timeout_s, args):
    # One card a rank where there are enough; ranks share one otherwise.
    os.environ["LOCAL_RANK"] = str(rank)
    init_rank(rank, world, store_path, backend, timeout_s)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args=(), backend: str = "gloo",
          timeout_s: float = 60.0, join_s: float = None, store_dir=None):
    """Run ``fn(*args)`` on ``world`` ranks. Each rank's collectives time
    out after ``timeout_s``; the whole run must end within ``join_s``
    (default ``timeout_s`` + 60) or its ranks are killed. Raises
    ``RuntimeError`` naming the ranks that failed or hung."""
    join_s = timeout_s + 60.0 if join_s is None else join_s
    tmp = None
    if store_dir is None:
        tmp = tempfile.TemporaryDirectory()
        store_dir = tmp.name
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, backend,
                                              timeout_s, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        failed = [r for r, p in enumerate(procs)
                  if not p.is_alive() and p.exitcode != 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            tmp.cleanup()
    if hung or failed:
        raise RuntimeError(f"ranks {failed} failed and ranks {hung} did not "
                           f"end within {join_s:.0f} s")
