"""Data-parallel training (``train/trainer.py::make_train_step(...,
mesh=mesh)``) on four gloo ranks on the CPU (one spawn for the module,
``tests/torch_parallel_ranks.py::train_ranks``), the twin of JAX's train
step over a dp mesh (``tests/test_parallel.py:62-93``):

* one step of FluidNetTower at dp = 4 on a 16^2 batch of 4 (one a rank),
  every loss weight non-zero, with the long-term loss off and on (the
  rollout's draw from JAX's ``_sample_dyn``, ``lt_num_steps`` (1, 2),
  max_disp 2): the all-reduced loss terms within 1e-5 of each term and the
  all-reduced gradients within 1e-4 of each tensor's largest value of
  ``jax.value_and_grad`` of JAX's ``make_loss_fn`` on the whole batch (the
  tolerances of ``tests/test_torch_train_grad.py``: the ranks' means are
  summed in another order), the weights carried across by
  ``models/convert.py``;
* the parameters equal to the bit on every rank: at the start (ranks 1-3
  begin from other weights, which the broadcast replaces), after the
  first step and after a second step in which each rank draws the rollout
  from its own host generator (the first rank's draw is used, and every
  rank reports the same one);
* the refusals: a ``div_mask`` under dp, and sx > 1 (ROADMAP A.8.2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from conftest import random_flags
from fluidnet_cxx_tpu.config import ModelConfig as JModelConfig
from fluidnet_cxx_tpu.config import SimConfig as JSimConfig
from fluidnet_cxx_tpu.config import TrainConfig as JTrainConfig
from fluidnet_cxx_tpu.models import fluidnet as j_fn
from fluidnet_cxx_tpu.train import trainer as j_trainer
from fluidnet_cxx_tpu_torch.config import ModelConfig
from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                   random_flax_params)
from fluidnet_cxx_tpu_torch.models.fluidnet import make_net
from fluidnet_cxx_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)
KEY = 3  # JAX's draw: buoyancy on, one rollout step


def _batch(rng, b=4, h=16, w=16):
    flags = random_flags(rng, b, h, w, p_obstacle=0.08)
    U = (0.5 * rng.standard_normal((b, 2, h, w))).astype(np.float32)
    p = rng.standard_normal((b, h, w)).astype(np.float32)
    zero = np.zeros((b, h, w), np.float32)
    return dict(p_div=zero, U_div=U, flags=flags, density_div=zero,
                p_target=p, U_target=U, density_target=zero)


def _kw(lt):
    return dict(batch_size=4, lt_num_steps=(1, 2), p_l2_lambda=0.3,
                p_l1_lambda=0.2, div_l1_lambda=0.5,
                div_lt_lambda=1.0 if lt else 0.0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    data = _batch(np.random.default_rng(0))
    dyn, n = j_trainer._sample_dyn(jax.random.PRNGKey(KEY),
                                   JSimConfig(max_disp=2),
                                   JTrainConfig(**_kw(True)))
    np.savez(d / "inputs.npz", dyn=np.array(
        [float(dyn.dt), float(dyn.buoyancy_scale), float(dyn.gravity_scale),
         *(float(g) for g in dyn.gravity_vec), int(n)]),
        **{"b_" + k: v for k, v in data.items()})
    spawn(ranks.train_ranks, ranks.WORLD, (str(d),), timeout_s=45,
          join_s=60)
    outs = {lt: [dict(np.load(d / f"train_lt{lt}_r{r}.npz"))
                 for r in range(ranks.WORLD)] for lt in (0, 1)}
    return data, outs, int(n)


def _jax_params(net):
    tree = {}
    for key, t in net.state_dict().items():
        _, name, kind = key.rsplit(".", 2)
        *outer, last = name.split("/")
        node = tree
        for part in outer:
            node = node.setdefault(part, {})
        node.setdefault(last, {})["kernel" if kind == "weight" else "bias"] = (
            t.permute(2, 3, 1, 0).numpy() if kind == "weight" else t.numpy())
    return {"params": {"FluidNetTower_0": tree}}


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("lt", [0, 1], ids=["lt_off", "lt_on"])
def test_dp_train_step_matches_jax_on_the_whole_batch(run, lt):
    data, outs, n = run
    assert n == 1
    net = make_net(ModelConfig())
    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table, 1)))
    jloss = j_trainer.make_loss_fn(j_fn.FluidNet(JModelConfig()),
                                   JSimConfig(max_disp=2),
                                   JTrainConfig(**_kw(lt)))
    jbatch = j_trainer.Batch(**{k: jnp.asarray(v) for k, v in data.items()})
    (_, jterms), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _jax_params(net), jbatch, jax.random.PRNGKey(KEY))
    want_grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jgrads["params"]["FluidNetTower_0"]))
    for out in outs[lt]:
        for got, want in zip(out["terms"], jterms):
            _close(got, want, 1e-5)
        assert (float(out["terms"][-1]) > 0) == bool(lt)
        for k, w in want_grads.items():
            assert float(np.abs(out["grad:" + k]).max()) > 0, k
            _close(out["grad:" + k], w, 1e-4)
        for k, t in net.state_dict().items():
            np.testing.assert_array_equal(out["init:" + k], t.numpy())


@pytest.mark.parametrize("lt", [0, 1], ids=["lt_off", "lt_on"])
def test_dp_parameters_and_draws_are_equal_on_every_rank(run, lt):
    _, outs, _ = run
    first = outs[lt][0]
    keys = [k for k in first if k.startswith(("param:", "param2:"))]
    assert len(keys) == 2 * len(list(make_net(ModelConfig()).parameters()))
    for out in outs[lt][1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], first[k])
        if lt:
            np.testing.assert_array_equal(out["draw"], first["draw"])
    for k in keys:
        if k.startswith("param2:"):
            assert not np.array_equal(first[k], first["param:" + k[7:]]), k


def test_dp_train_step_refuses_what_it_does_not_run(run):
    _, outs, _ = run
    for out in outs[0] + outs[1]:
        assert "div_mask" in str(out["refuse_mask"])
        msg = str(out["refuse_sx"])
        assert "make_train_step" in msg and "A.8.2" in msg, msg
