"""3-D training (the port of ``scripts/train3d.py``) against the JAX
package on the CPU: the synthetic 3-D batches on the numbers JAX draws,
kernel I's polish adjoint against ``jax.vjp``, the gradients of each kind
of PUNet3 layer on kernel N's flax route against ``jax.vjp`` of flax
``nn.Conv(dtype="bfloat16")``, one train step of FluidNet3 against
``jax.value_and_grad`` of train3d.py's loss (float32, and bfloat16 with its
gap printed), the 3-D rollout-frame collector, the twin CLI, the
gradient kernels' class tables and ``check_trainable``.

Tolerances:
- the noise 1e-5 (two FFT libraries), the jet 1e-6, the label tail and
  the frames 1e-4 of each field's largest value (sums in another order,
  carried through a rollout);
- the adjoint 1e-6 of its largest value: JAX differentiates its XLA
  solver, whose sum order differs from the port's (kernel I's);
- a layer's bfloat16 gradients within one bfloat16 ulp of flax's, at most
  1 value in 1000 off (a float32 sum taken in another order lands on the
  other side of a rounding point);
- the float32 step: the loss 1e-5 of its value, each parameter gradient
  1e-4 of its tensor's largest value.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidnet_cxx_tpu.config import ModelConfig as JModelConfig
from fluidnet_cxx_tpu.data import synthetic3 as j_syn3
from fluidnet_cxx_tpu.models.punet3d import FluidNet3 as JFluidNet3
from fluidnet_cxx_tpu.ops import ops3d as j_ops3d
from fluidnet_cxx_tpu.sim import plume_config as j_plume_config
from fluidnet_cxx_tpu.sim.scenes3 import create_plume_scene3 as j_scene3
from fluidnet_cxx_tpu.train.trainer import \
    collect_rollout_frames3 as j_collect3
from fluidnet_cxx_tpu_torch.config import ModelConfig, load_model_config
from fluidnet_cxx_tpu_torch.data import synthetic3
from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict3,
                                                   load_state_dict_file,
                                                   random_flax_params3)
from fluidnet_cxx_tpu_torch.models.punet3d import FluidNet3, init_params3
from fluidnet_cxx_tpu_torch.ops import ops3d
from fluidnet_cxx_tpu_torch.ops.kernels import conv_grad3, jacobi3, punet3
from fluidnet_cxx_tpu_torch.ops.kernels.punet3 import pack_weights3
from fluidnet_cxx_tpu_torch.run_plume3d import run_plume3d
from fluidnet_cxx_tpu_torch.scripts import train3d
from fluidnet_cxx_tpu_torch.sim.scenes import plume_config
from fluidnet_cxx_tpu_torch.sim.scenes3 import create_plume_scene3
from fluidnet_cxx_tpu_torch.train.trainer import (check_trainable,
                                                  collect_rollout_frames3,
                                                  loss3)
from test_torch_ops3d import random_flags3

torch.set_num_threads(1)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compile():
    """The JAX reference is compile-bound here; XLA's optimisation passes
    change no result beyond rounding, so this module runs without them
    (as tests/test_torch_train.py) and restores the setting after."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _ulps(got, want):
    """|got - want| in bfloat16 ulps of want (equal values: 0)."""
    a = np.abs(want)
    ulp = np.where(a > 0, np.exp2(np.floor(np.log2(np.maximum(a, 1e-30)))
                                  - 7), 2.0 ** -133)
    return np.where(got == want, 0.0, np.abs(got - want) / ulp)


def test_synthetic3_matches_jax_on_its_draws():
    """band_limited3 and inlet_jet3 on the numbers JAX's _smooth_noise3 and
    generate_batch3 draw, and label_batch3 against generate_batch3's tail;
    a port batch is divergent and its targets projected."""
    b, d, h, w = 2, 16, 12, 8
    key = jax.random.PRNGKey(3)
    kr, ki = jax.random.split(key)
    re, im = (np.asarray(jax.random.normal(k, (b, d, h, w)))
              for k in (kr, ki))
    _close(synthetic3.band_limited3(T(re), T(im)),
           j_syn3._smooth_noise3(key, b, d, h, w), 1e-5)
    want = j_syn3.generate_batch3(key, b, d, h, w, 30)
    ks = jax.random.split(key, 8)
    draws = [jax.random.uniform(ks[i], (b, 1, 1, 1), minval=lo, maxval=hi)
             for i, lo, hi in ((4, 0.25 * d, 0.75 * d),
                               (5, 0.25 * w, 0.75 * w),
                               (6, 0.06 * w, 0.2 * w), (7, 0.0, 2.5))]
    jet = synthetic3.inlet_jet3(*(T(np.asarray(a)) for a in draws), d, h, w)
    amp = np.asarray(jax.random.uniform(ks[3], (b, 1, 1, 1), minval=0.5,
                                        maxval=3.0))
    U = np.stack([np.asarray(j_syn3._smooth_noise3(ks[c], b, d, h, w)) * amp
                  for c in range(3)], axis=1)
    U[:, 1] += jet.numpy()
    got = synthetic3.label_batch3(T(U), 30)
    for g, wnt in zip(got, want):
        if g.dtype == torch.int32:
            assert np.array_equal(g.numpy(), np.asarray(wnt))
        else:
            _close(g, wnt, 1e-4)
    U_div, flags, _, U_t = synthetic3.generate_batch3(
        torch.Generator().manual_seed(1), 2, 16, 16, 16, 200, device="cpu")
    div_in = float(ops3d.velocity_divergence3(U_div, flags).abs().mean())
    div_out = float(ops3d.velocity_divergence3(U_t, flags).abs().mean())
    assert div_in > 0.1 and div_out < 0.2 * div_in


@pytest.mark.parametrize("iters,damping", [(8, 2.0 / 3.0), (5, 1.0)])
def test_jacobi_adjoint3_matches_jax_vjp(rng, iters, damping):
    """jacobi_adjoint_fixed3 (kernel I's adjoint's plain version, and the
    wrapper on a CPU tensor) against jax.vjp of solve_jacobi_fixed3 with
    respect to p0, on flags with obstacles and a random RHS."""
    flags = random_flags3(rng, (2, 12, 10, 8), p_obstacle=0.15)
    div = rng.standard_normal(flags.shape).astype(np.float32)
    p0 = rng.standard_normal(flags.shape).astype(np.float32)
    g = rng.standard_normal(flags.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p: j_ops3d.solve_jacobi_fixed3(
        flags, div, iters, p0=p, damping=damping), p0)
    (want,) = vjp(g)
    got = jacobi3.jacobi3_adjoint(T(flags), T(g), iters, damping)
    _close(got, want, 1e-6)
    assert torch.equal(got, ops3d.jacobi_adjoint_fixed3(T(flags), T(g),
                                                        iters, damping))
    assert float(got[T(flags) == 2].abs().max()) == 0.0
    # Through JacobiPolish3: the p0 gradient of solve_jacobi3.
    p = T(p0).requires_grad_()
    out = jacobi3.solve_jacobi3(T(flags), T(div), iters, p0=p,
                                damping=damping)
    out.backward(T(g))
    assert torch.equal(p.grad, got)


# (kernel, stride, relu, c1, c2, co): PUNet3's kinds of layer, narrow.
GRAD_LAYERS = [(1, 1, True, 64, 0, 32), (3, 1, True, 32, 0, 32),
               (3, 2, True, 32, 0, 64), (1, 1, False, 64, 0, 256),
               (3, 1, True, 32, 32, 32)]


@pytest.mark.parametrize("k,stride,relu,c1,c2,co", GRAD_LAYERS,
                         ids=[f"k{c[0]}-s{c[1]}-{'relu' if c[2] else 'lin'}"
                              f"-{c[3]}+{c[4]}to{c[5]}"
                              for c in GRAD_LAYERS])
def test_layer_gradients_match_flax_vjp(rng, k, stride, relu, c1, c2, co):
    """The input, weight and bias gradients of one layer on N's flax route
    (ConvNDHWC on the plain versions, weights and bias packed from float32
    parameters by pack_layer3's casts) against jax.vjp of flax's bfloat16
    conv (and ReLU) with the same bfloat16 upstream gradient: within one
    bfloat16 ulp, at most 1 value in 1000 off; the concat's input gradient
    split into its two halves."""
    side = 8
    x = rng.standard_normal((2, side, side, side, c1 + c2)).astype(
        np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    kernel = (rng.standard_normal((k, k, k, c1 + c2, co)) /
              np.sqrt(k ** 3 * (c1 + c2))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(co)).astype(np.float32)
    so = -(-side // stride)
    g = np.asarray(jnp.asarray(rng.standard_normal(
        (2, so, so, so, co)).astype(np.float32)).astype(jnp.bfloat16))

    conv = nn.Conv(co, (k, k, k), strides=(stride,) * 3, padding="SAME",
                   dtype="bfloat16")

    def f(xx, kk, bb):
        y = conv.apply({"params": {"kernel": kk, "bias": bb}}, xx)
        return nn.relu(y) if relu else y

    y, vjp = jax.vjp(f, jnp.asarray(x, jnp.bfloat16), kernel, bias)
    dx_w, dk_w, db_w = (np.asarray(a.astype(jnp.float32))
                        for a in vjp(jnp.asarray(g, y.dtype)))

    xt = T(x).to(BF16)
    x1 = xt[..., :c1].contiguous().requires_grad_()
    x2 = xt[..., c1:].contiguous().requires_grad_() if c2 else None
    w = T(kernel).permute(4, 3, 0, 1, 2).contiguous().requires_grad_()
    b = T(bias).requires_grad_()
    w_dhwio = w.to(BF16).permute(2, 3, 4, 1, 0).contiguous()
    out = punet3.conv3d_ndhwc_autograd(x1, w_dhwio, b.to(BF16).float(),
                                       stride, relu, x2, BF16, True,
                                       plain=True)
    out.backward(T(g.astype(np.float32)).to(BF16))
    dx = x1.grad if x2 is None else torch.cat([x1.grad, x2.grad], dim=-1)
    assert dx.dtype == BF16 and w.grad.dtype == torch.float32
    report = []
    for name, got, want in (
            ("dx", dx.float().numpy(), dx_w),
            ("dW", w.grad.permute(2, 3, 4, 1, 0).numpy(), dk_w),
            ("db", b.grad.numpy(), db_w)):
        assert np.array_equal(got, np.asarray(jnp.asarray(got).astype(
            jnp.bfloat16).astype(jnp.float32))), name   # bf16 values
        u = _ulps(got, want)
        report.append((name, int((u > 0).sum()), float(u.max()), u.size))
    print(f"values off flax (count, largest in ulps, of): {report}")
    for name, n_off, worst, size in report:
        assert worst <= 1.0, (name, worst)
        assert n_off <= size // 1000, (name, n_off)


def _small_cfg(dtype, patch=2):
    """train3d.py's model at narrow widths: PUNet3 (16, 32), 8 damped
    "xla" polish sweeps, the std of U as the input scale."""
    return ModelConfig(model="PUNet3", punet_patch=patch,
                       punet_widths=(16, 32), punet_bottleneck_convs=2,
                       polish_sweeps=8, compute_dtype=dtype,
                       normalize_input_chan="UDiv")


def _step_vs_jax(dtype, seed=5):
    """(port loss, JAX loss, port gradients, JAX gradients as the port's
    state_dict) of train3d.py's loss at 16^3, batch 2, on one batch."""
    mcfg = _small_cfg(dtype)
    model = init_params3(FluidNet3(mcfg), seed)
    params = random_flax_params3(model.net.table, seed)
    U_div, flags, _, _ = (np.asarray(a) for a in j_syn3.generate_batch3(
        jax.random.PRNGKey(seed), 2, 16, 16, 16, 40))
    jmodel = JFluidNet3(JModelConfig(**dataclasses.asdict(mcfg)))

    def j_loss(p):
        zero = jnp.zeros(flags.shape, jnp.float32)
        _, U_out = jmodel.apply({"params": {"PUNet3_0": p}}, zero, U_div,
                                flags, zero)
        div = j_ops3d.velocity_divergence3(U_out, flags)
        return jnp.mean(div * div)

    want, jgrads = jax.jit(jax.value_and_grad(j_loss))(params)
    loss = loss3(model, pack_weights3(model.net), T(U_div), T(flags))
    loss.backward()
    want_grads = flax_to_state_dict3(
        jax.tree_util.tree_map(np.asarray, jgrads))
    got_grads = {n: p.grad for n, p in model.net.named_parameters()}
    return float(loss.detach()), float(want), got_grads, want_grads


def test_float32_train_step_matches_jax_value_and_grad():
    """One float32 FluidNet3 loss and its gradient (the plain convs and
    their backward, the polish's adjoint) against jax.value_and_grad of
    train3d.py's loss: the loss to 1e-5, each gradient to 1e-4 of its
    tensor's largest value."""
    loss, want, got, wgrads = _step_vs_jax("float32")
    assert abs(loss - want) <= 1e-5 * abs(want)
    assert set(got) == set(wgrads)
    for name, g in got.items():
        _close(g, wgrads[name].numpy(), 1e-4)


def test_bfloat16_train_step_gap_to_jax():
    """The same step in bfloat16 (N's flax route's rounding points in the
    forward and the backward) against JAX's: the loss within 1e-4 of its
    value, each gradient within 5% of its tensor's norm (relative L2);
    prints each tensor's largest gap as a share of its largest value and
    its relative L2 gap. The gaps are bfloat16 roundings that flip: the
    net's input differs from JAX's by an f32 ulp in ~15% of its values
    (the std scale summed in another order), a float32 sum in another
    order lands a bf16 output on the other side of a rounding point, and
    a pre-activation that rounds to 0 on one side only flips a ReLU mask,
    which moves every weight gradient of its output channel (on the same
    input and upstream gradient the port's backward equals flax's but for
    such flips)."""
    loss, want, got, wgrads = _step_vs_jax("bfloat16")
    gaps = {n: (float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)),
                float((g - w).norm() / w.norm().clamp_min(1e-30)))
            for n, (g, w) in ((n, (g, wgrads[n])) for n, g in got.items())}
    print(f"bfloat16 step: loss {loss:.7g} vs JAX {want:.7g} (gap "
          f"{abs(loss - want) / abs(want):.3e}); gradient gaps (largest, "
          f"L2) { {n: f'{a:.2e}, {b:.2e}' for n, (a, b) in gaps.items()} }")
    assert abs(loss - want) <= 1e-4 * abs(want)
    assert max(b for _, b in gaps.values()) <= 5e-2


def test_collect_rollout_frames3_matches_jax():
    """The 3-D plume frames (pre-projection, the learned projection's
    input) and the inlet mask against JAX's collector at 16^3: two frames,
    the second from the first's classical finish (JAX's compile of each
    kind of step costs ~8 s here, so no warm-up or stride steps: the full
    step is held to JAX in tests/test_torch_step3d.py)."""
    cfg = dict(dt=0.25, jacobi_iter=30, buoyancy_scale=0.5,
               gravity_vec=(0.0, -1.0, 0.0), line_trace=False, max_disp=1,
               advection_impl="window")
    js = j_scene3(16, 16, 16, density_val=0.1, u_scale=0.6 * 16 / 64.0)
    frames, flags, mask = j_collect3(j_plume_config(**cfg), js, 2,
                                     stride=1, warmup=0)
    ts = create_plume_scene3(16, 16, 16, density_val=0.1,
                             u_scale=0.6 * 16 / 64.0)
    got, got_flags, got_mask = collect_rollout_frames3(
        plume_config(use_pallas=True, **cfg), ts, 2, stride=1, warmup=0)
    assert got.shape == (2, 3, 16, 16, 16)
    _close(got, frames, 1e-4)
    assert torch.equal(got_flags, T(np.asarray(flags)))
    assert torch.equal(got_mask, T(np.asarray(mask)))
    assert not bool(got_mask.all())


def test_train3d_cli_writes_a_model_dir_run_plume3d_loads(tmp_path,
                                                          capsys):
    """The twin CLI for 2 chunks at 16^3 on the CPU (patch 2, 20 label
    sweeps, 2 plume frames mixed in): its reports, the final mean|div|
    line last, a model dir whose torch_state_dict.pt and model_config.json
    run_plume3d's learned case loads (the trained parameters)."""
    out = tmp_path / "m3"
    res = train3d.main(["--steps", "10", "--res", "16", "--bsz", "2",
                        "--labelIters", "20", "--patch", "2",
                        "--plumeFrames", "2", "--modelDir", str(out),
                        "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("mean|div|: input ")
    assert "frames ready: (2, 3, 16, 16, 16)" in lines
    assert res["steps"] == 10 and len(res["losses"]) == 1
    assert np.isfinite(res["losses"]).all()
    mcfg = load_model_config(str(out))
    assert (mcfg.model, mcfg.punet_patch, mcfg.compute_dtype,
            mcfg.polish_sweeps) == ("PUNet3", 2, "bfloat16", 8)
    sd = load_state_dict_file(out)
    assert (out / "best" / "train_state.pt").is_file()
    run = run_plume3d(16, 2, device="cpu", sim_method="convnet",
                      model_dir=out, path="flax")
    assert run["weights"] == "trained"
    assert all(bool(torch.isfinite(t).all()) for t in run["state"][:4])
    init = init_params3(FluidNet3(mcfg), 0).net.state_dict()
    assert any(not torch.equal(sd[k], init[k]) for k in sd)


@pytest.mark.parametrize("shape,k,stride", [((8, 8, 8), 3, 2),
                                            ((8, 6, 4), 3, 1),
                                            ((4, 4, 4), 1, 1),
                                            ((7, 8, 5), 3, 2)])
def test_dgrad_classes3_cover_every_cell_and_tap(shape, k, stride):
    """The input gradient's parity classes: every dx cell in one class,
    every tap in at most one, and each class's taps read exactly the dy
    cells the conv's SAME geometry says (i + lo - tap) / stride."""
    classes = conv_grad3.dgrad_classes3(shape, k, stride)
    lo = [conv_grad3.same_pads(s, k, stride, 1)[0] for s in shape]
    out = [-(-s // stride) for s in shape]
    seen = np.zeros(shape, int)
    taps = []
    for start, size, ctaps in classes:
        taps += [t[0] for t in ctaps]
        for q in np.ndindex(*size):
            cell = [start[a] + stride * q[a] for a in range(3)]
            seen[tuple(cell)] += 1
            for tap, *off in ctaps:
                kk = (tap // (k * k), tap // k % k, tap % k)
                for a in range(3):
                    assert (cell[a] + lo[a] - kk[a]) == stride * (q[a]
                                                                   + off[a])
            want = {t for t in range(k ** 3)
                    if all((cell[a] + lo[a] - (t // k ** (2 - a)) % k)
                           % stride == 0 for a in range(3))}
            assert {t[0] for t in ctaps} == want
    assert (seen == 1).all() and len(taps) == len(set(taps))
    assert all(o >= 1 for o in out)
    table = list(conv_grad3.dgrad_table3(shape, k, stride))
    assert table[0] == len(classes) and len(table) == 1 + 7 * len(
        classes) + 4 * len(taps)


def test_check_trainable_and_the_wrappers_refusals():
    """check_trainable passes a bfloat16 PUNet3 on the card and refuses a
    float32 one there (A.5.5) and the fused tail; it passes every 2-D net
    in bfloat16 (kernel B's bfloat16 route has its backward kernels since
    A.5.3); the gradient wrappers and the adjoint run their plain versions
    only on CPU tensors and raise for other devices; the fused route has
    no backward."""
    check_trainable(_small_cfg("bfloat16"), "cuda")
    with pytest.raises(NotImplementedError, match="A.5.5"):
        check_trainable(_small_cfg("float32"), "cuda")
    for model in ("PUNet", "FluidNet", "ScaleNet"):
        check_trainable(ModelConfig(model=model, compute_dtype="bfloat16",
                                    polish_impl="xla"), "cuda")
    with pytest.raises(NotImplementedError, match="polish tail"):
        check_trainable(dataclasses.replace(_small_cfg("bfloat16"),
                                            polish_impl="fused"), "cuda")
    check_trainable(_small_cfg("float32"), "cpu")
    meta = torch.zeros((1, 4, 4, 4, 32), device="meta", dtype=BF16)
    w = torch.zeros((3, 3, 3, 32, 32), device="meta", dtype=BF16)
    for call in (lambda: conv_grad3.conv3d_dgrad(meta, w, 1, (4, 4, 4)),
                 lambda: conv_grad3.conv3d_wgrad(meta, meta, 3, 1),
                 lambda: jacobi3.jacobi3_adjoint(
                     torch.zeros((1, 4, 4, 4), device="meta",
                                 dtype=torch.int32),
                     torch.zeros((1, 4, 4, 4), device="meta"), 2)):
        with pytest.raises(ValueError, match="device"):
            call()
    x = torch.zeros((1, 4, 4, 4, 32), dtype=BF16)
    wt = torch.zeros((3, 3, 3, 32, 32), dtype=BF16, requires_grad=True)
    with pytest.raises(ValueError, match="fused route"):
        punet3.conv3d_ndhwc_autograd(x, wt, torch.zeros(32), 1, True, None,
                                     torch.float32, False)
