"""The port's (dp, sx) mesh against the JAX package's: the factorisation of
``make_mesh`` for 1-8 devices; on four gloo ranks on the CPU (one spawn for
the module, ``tests/torch_parallel_ranks.py::mesh_ranks``) each rank's
coordinates and its shards of a (4, 2, 8, 16) velocity, (4, 8, 16) flags
and pressure, each equal (torch.equal) to the slice that JAX's
``batch_sharding`` / ``state_sharding`` gives the device at the same mesh
position (``NamedSharding.devices_indices_map``), on the 1x4, 2x2 and
4x1 meshes; the gather of a ``SimState`` and a ``Batch`` equal to the
whole; uneven splits raising ``ValueError``; and the backend never
switched (a gloo world refuses a NCCL mesh; NCCL refuses the CPU). Gloo
with CUDA tensors cannot run here: chip_smoke.py's multi-device phase runs
it on the card."""
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from fluidnet_cxx_tpu.parallel import (batch_sharding as j_batch_sharding,
                                       make_mesh as j_make_mesh,
                                       state_sharding as j_state_sharding)
from fluidnet_cxx_tpu_torch.parallel.launch import spawn
from fluidnet_cxx_tpu_torch.parallel.mesh import mesh_device, mesh_shape


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    x = dict(U=rng.standard_normal((4, 2, 8, 16)).astype(np.float32),
             flags=rng.integers(1, 3, (4, 8, 16)).astype(np.int32),
             p=rng.standard_normal((4, 8, 16)).astype(np.float32))
    np.savez(d / "inputs.npz", **x)
    spawn(ranks.mesh_ranks, ranks.WORLD, (str(d),), timeout_s=45, join_s=60)
    return x, [dict(np.load(d / f"mesh_r{r}.npz"))
               for r in range(ranks.WORLD)]


SHAPES = [(n, dp, sx) for n in range(1, 9)
          for dp, sx in ((None, None), (None, 1), (1, None), (None, 2))
          if sx is None or n % sx == 0]


@pytest.mark.parametrize("n,dp,sx", SHAPES)
def test_mesh_shape_is_jax_make_mesh(n, dp, sx):
    want = j_make_mesh(n, dp=dp, sx=sx).devices.shape
    assert mesh_shape(n, dp, sx) == want


def test_mesh_shape_refuses_what_jax_refuses():
    with pytest.raises(AssertionError, match="mesh 2x2 != 3"):
        j_make_mesh(3, dp=2, sx=2)
    with pytest.raises(AssertionError, match="mesh 2x2 != 3"):
        mesh_shape(3, 2, 2)


@pytest.mark.parametrize("dp,sx", ranks.MESHES)
def test_shards_are_jax_named_sharding_slices(run, dp, sx):
    x, outs = run
    jmesh = j_make_mesh(ranks.WORLD, dp=dp, sx=sx)
    pos = {dev: idx for idx, dev in np.ndenumerate(jmesh.devices)}
    for name, fn in (("U", j_state_sharding), ("flags", j_batch_sharding),
                     ("p", j_state_sharding)):
        sharding = fn(jmesh, x[name])
        for dev, index in sharding.devices_indices_map(
                x[name].shape).items():
            i, j = pos[dev]
            out = outs[i * sx + j]
            assert tuple(out[f"{dp}x{sx}_coords"]) == (i, j)
            np.testing.assert_array_equal(out[f"{dp}x{sx}_{name}"],
                                          x[name][index])


@pytest.mark.parametrize("dp,sx", ranks.MESHES)
def test_gather_is_the_whole_and_uneven_splits_raise(run, dp, sx):
    _, outs = run
    for out in outs:
        assert out[f"{dp}x{sx}_roundtrip"].all()
        assert len(out[f"{dp}x{sx}_roundtrip"]) == 4 + 7
        assert bool(out[f"{dp}x{sx}_uneven"])


def test_default_mesh_and_the_backend_is_never_switched(run):
    _, outs = run
    for r, out in enumerate(outs):
        assert tuple(out["default"]) == (2, 2, r // 2, r % 2)
        assert "never switches backends" in str(out["switch"])
    with pytest.raises(ValueError, match="NCCL runs CUDA tensors"):
        mesh_device("nccl", "cpu")
    with pytest.raises(ValueError, match="backend 'mpi'"):
        mesh_device("mpi", "cpu")
    assert mesh_device("gloo", "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_device("gloo", "cuda")
