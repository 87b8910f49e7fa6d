"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its elapsed seconds):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with one nvcc command, printing the
     -Xptxas -v register, shared-memory and spill lines;
  3. each kernel (A advection, B PUNet conv, C projection tail) once at the
     512^2 slice's shapes against its plain PyTorch version on the card
     (TF32 off), with its tolerance, then CUDA-event times of the kernel,
     the plain version and, for B, the same forward as cuDNN F.conv2d calls;
  4. a small-input check: 3 steps of the 64^2 plume on the card against the
     plain path on the CPU;
  5. the main path: 20 steps of the 512^2 plume through run_plume with every
     launch counter set to 0 just before and read just after; finite fields,
     ms per step, mean|div| in and out of the last projection, the
     `kernels` JSON line;
  6. a torch.profiler window of 5 more steps: device time per step, the
     device's idle share and the kernels that take the most device time.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without it; a watchdog turns a phase that hangs for 600 s into a non-zero
exit with a traceback. Imports nothing of JAX.

Bounds (`bound_ms`) are the larger of bytes moved (each input read once,
each output written once) over 3.35 TB/s and operations over 67 TFLOP/s
(H100 SXM fp32 without tensor cores), counted from this run's inputs.
"""
import faulthandler
import json
import subprocess
import sys
import time

import torch

WATCHDOG_S = 600
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
RES = 512
STEPS = 20
SEED = 0


def phase(name):
    """Start a phase: re-arm the watchdog, return a function that prints the
    phase's elapsed seconds."""
    faulthandler.cancel_dump_traceback_later()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)

    def done():
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return done


def cuda_ms(fn, reps, warmup=2):
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(nbytes, nops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def scale_of(want):
    return max(1.0, max(float(w.abs().max()) for w in want))


def check(name, err, tol):
    print(f"{name}: max_abs_err {err:.3e} tolerance {tol:.3e}", flush=True)
    if not err <= tol:
        raise SystemExit(f"{name} disagrees with its plain version")


def stress_inputs(gen, dev, res):
    """Plume-sized inputs that exercise every branch: walls plus 8% random
    obstacles, velocities up to 5 cells a step at dt 0.1 (past the window
    clamp of 4)."""
    from fluidnet_cxx_tpu_torch.celltype import FLUID, OBSTACLE

    flags = torch.full((1, res, res), FLUID, dtype=torch.int32)
    flags[:, 0, :] = flags[:, -1, :] = OBSTACLE
    flags[:, :, 0] = flags[:, :, -1] = OBSTACLE
    flags[torch.rand((1, res, res), generator=gen) < 0.08] = OBSTACLE
    U = 100.0 * (torch.rand((1, 2, res, res), generator=gen) - 0.5)
    rho = torch.rand((1, res, res), generator=gen)
    return flags.to(dev), U.to(dev), rho.to(dev)


def advect_ops(flags, D):
    """Operations of one advection call on these flags: ~300 per cell plus
    two slab tests (~20 ops each) per blocked cell in each fluid cell's
    (2D+1)^2 trace window, for the forward and the backward trace."""
    blocked = (flags != 1).float()[:, None]
    k = 2 * D + 1
    in_window = torch.nn.functional.conv2d(
        blocked, torch.ones((1, 1, k, k), device=flags.device), padding=D)
    fluid = (flags == 1)[:, None]
    return 300.0 * flags.numel() + 2 * 20.0 * float(in_window[fluid].sum())


def phase_kernels(dev, results):
    from fluidnet_cxx_tpu_torch.models.punet import depth_to_space
    from fluidnet_cxx_tpu_torch.models.punet import space_to_depth
    from fluidnet_cxx_tpu_torch.ops.kernels import advect, proj_tail, punet
    from fluidnet_cxx_tpu_torch.ops.kernels.punet import same_pads
    from fluidnet_cxx_tpu_torch.run_plume import MODEL_DIR, build_punet
    from fluidnet_cxx_tpu_torch.config import load_model_config
    from fluidnet_cxx_tpu_torch.sim.scenes import create_plume_scene

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    flags, U, rho = stress_inputs(gen, dev, RES)
    n = RES * RES
    D = 4

    # ---- A: advection ----
    done = phase("kernel A advect_all")
    args = (0.1, rho, U, flags, 0.6, False, D, True)
    got = advect.advect_all(*args)
    torch.cuda.synchronize()
    want = advect.advect_all_plain(*args)
    err, tol = max_err(got, want), 1e-4 * scale_of(want)
    check("A advect_all", err, tol)
    # The branches the main path does not take: no trace, plain bilinear.
    other = (0.1, rho, U, flags, 0.6, True, D, False)
    want2 = advect.advect_all_plain(*other)
    check("A advect_all (trace off, sample outside)",
          max_err(advect.advect_all(*other), want2), 1e-4 * scale_of(want2))
    ms = cuda_ms(lambda: advect.advect_all(*args), 20)
    plain_ms = cuda_ms(lambda: advect.advect_all_plain(*args), 3, warmup=1)
    b_ms, b_by = bound(28 * n, advect_ops(flags, D))
    results["A"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
    print(f"A: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    done()

    # ---- B: PUNet forward through the conv kernel ----
    done = phase("kernel B punet conv")
    mcfg = load_model_config(str(MODEL_DIR))
    net = build_punet(mcfg, SEED, dev)
    packed = punet.pack_weights(net)
    x = torch.stack([torch.randn((1, RES, RES), generator=gen),
                     (torch.rand((1, RES, RES), generator=gen) < 0.1).float()],
                    dim=-1).to(dev)
    inv = torch.tensor([3.0], device=dev)
    with torch.no_grad():
        got = punet.punet_forward(net, packed, x, inv)
        torch.cuda.synchronize()
        want = net(x, inv_scale=inv)
        err, tol = max_err([got], [want]), 1e-4 * scale_of([want])
        check("B punet conv", err, tol)
        ms = cuda_ms(lambda: punet.punet_forward(net, packed, x, inv), 20)
        plain_ms = cuda_ms(lambda: net(x, inv_scale=inv), 20)

        # library: the same forward as cuDNN F.conv2d calls on NCHW tensors.
        def library():
            h = x.clone()
            h[..., 0] *= inv[0]
            h = space_to_depth(h, net.patch).permute(0, 3, 1, 2)

            def conv(name, h, relu=True):
                c = net.convs[name]
                k, s, d = net.geometry[name]
                p = same_pads(h.shape[-1], k, s, d)
                h = torch.nn.functional.conv2d(
                    torch.nn.functional.pad(h, (p[0], p[1], p[0], p[1])),
                    c.weight, c.bias, stride=s, dilation=d)
                return torch.relu(h) if relu else h

            def d2s(h, p):
                return depth_to_space(h.permute(0, 2, 3, 1), p).permute(
                    0, 3, 1, 2)

            h = conv("embed", h)
            skips = []
            for i in range(len(net.widths)):
                if i > 0:
                    h = conv(f"down{i}", h)
                h = conv(f"enc{i}_0", h)
                skips.append(h)
            for j in range(net.bottleneck_convs):
                h = conv(f"mid{j}", h)
            for i in range(len(net.widths) - 2, -1, -1):
                h = d2s(conv(f"up{i}", h, relu=False), 2)
                h = conv(f"dec{i}_0", torch.cat([h, skips[i]], dim=1))
            return d2s(conv("head", h, relu=False), net.patch)

        lib_err = max_err([library().permute(0, 2, 3, 1)], [want])
        print(f"B library forward vs plain: max_abs_err {lib_err:.3e}")
        library_ms = cuda_ms(library, 20)
    # Output side of each layer in forward order (s2d by the patch first,
    # stride-2 downs halve it, each up's depth-to-space doubles it).
    sizes, side = {}, RES // net.patch
    for name in net.convs:
        if net.geometry[name][1] == 2:
            side //= 2
        sizes[name] = side
        if name.startswith("up"):
            side *= 2
    macs = sum(sizes[nm] ** 2 * w.shape[0] * w.shape[1] * w.shape[2] *
               w.shape[3] for nm, (w, _) in packed.items())
    wbytes = sum(4 * (w.numel() + b.numel()) for w, b in packed.values())
    b_ms, b_by = bound(4 * x.numel() + wbytes + 4 * n, 2.0 * macs)
    results["B"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=library_ms)
    print(f"B: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, library "
          f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"{2.0 * macs / 1e9:.3f} GFLOP", flush=True)
    done()

    # ---- C: projection tail ----
    done = phase("kernel C project_tail")
    scene = create_plume_scene(RES, RES, 0.1, 8.0, 0.145, device=dev)
    p0 = torch.randn((1, RES, RES), generator=gen).to(dev)
    scale = torch.tensor([0.37], device=dev)
    kw = dict(damping=2.0 / 3.0, scale=scale, U_bc=scene.U_bc,
              U_bc_inv_mask=scene.U_bc_inv_mask)
    got = proj_tail.project_tail(flags, U, p0, 32, **kw)
    torch.cuda.synchronize()
    want = proj_tail.project_tail_plain(flags, U, p0, 32, **kw)
    err, tol = max_err(got, want), 1e-5 * scale_of(want)
    check("C project_tail", err, tol)
    # Odd sweep count (the other ping-pong parity), no scale, no inlet.
    want2 = proj_tail.project_tail_plain(flags, U, p0, 3)
    check("C project_tail (3 sweeps, no scale/inlet)",
          max_err(proj_tail.project_tail(flags, U, p0, 3), want2),
          1e-5 * scale_of(want2))
    ms = cuda_ms(lambda: proj_tail.project_tail(flags, U, p0, 32, **kw), 20)
    plain_ms = cuda_ms(
        lambda: proj_tail.project_tail_plain(flags, U, p0, 32, **kw), 5)
    b_ms, b_by = bound(44 * n, (32 * 10 + 30) * n)
    results["C"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
    print(f"C: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    done()


def phase_small_check():
    """3 steps of the 64^2 plume: kernels on the card vs plain on the CPU."""
    from fluidnet_cxx_tpu_torch.run_plume import run_plume

    done = phase("small-input check (64^2, 3 steps, card vs CPU)")
    gpu = run_plume(64, 3, device="cuda", seed=SEED)["state"]
    cpu = run_plume(64, 3, device="cpu", seed=SEED)["state"]
    for name in ("U", "density", "p"):
        g, c = getattr(gpu, name).cpu(), getattr(cpu, name)
        check(f"64^2 step {name}", max_err([g], [c]), 1e-4 * scale_of([c]))
    done()


def phase_profile():
    """Device time and idle share of 5 steps under torch.profiler (the
    profiler's own host cost makes the idle share an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    from fluidnet_cxx_tpu_torch.run_plume import plume_case
    from fluidnet_cxx_tpu_torch.sim.step import simulate_step

    done = phase(f"profile ({RES}^2, 5 steps)")
    n = 5
    with torch.no_grad():
        cfg, state, project = plume_case(RES, "cuda", SEED)
        for _ in range(3):
            state = simulate_step(cfg, state, project)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                state = simulate_step(cfg, state, project)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / n

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0.0) or 0.0

    # Device-side events only: an aten op's own row repeats the time of
    # the kernels it launched.
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    dev_ms = sum(dev_us(e) for e in events) / 1e3 / n
    if not events:
        print("profiler: no device time recorded", flush=True)
    else:
        print(f"profile: wall {wall_ms:.4f} ms/step, device busy "
              f"{dev_ms:.4f} ms/step, idle share {1 - dev_ms / wall_ms:.3f}",
              flush=True)
        for e in sorted(events, key=dev_us, reverse=True)[:10]:
            print(f"  {dev_us(e) / 1e3 / n:9.4f} ms/step "
                  f"{e.count / n:6.1f} calls/step  {e.key[:70]}", flush=True)
    done()


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)

    done = phase("card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    done()

    done = phase("build (nvcc)")
    from fluidnet_cxx_tpu_torch.ops.kernels import _build
    _build.build(ptxas_verbose=True)
    _build.library()
    done()

    dev = torch.device("cuda")
    results = {}
    phase_kernels(dev, results)
    phase_small_check()

    from fluidnet_cxx_tpu_torch.ops.kernels import advect, proj_tail, punet
    from fluidnet_cxx_tpu_torch.run_plume import run_plume

    done = phase(f"main path ({RES}^2, {STEPS} steps)")
    counters = {"A": advect.advect_all, "B": punet.conv2d_nhwc,
                "C": proj_tail.project_tail}
    for fn in counters.values():
        fn.launches = 0
    out = run_plume(RES, STEPS, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    st = out["state"]
    for name in ("U", "density", "p"):
        t = getattr(st, name)
        if not bool(torch.isfinite(t).all()):
            raise SystemExit(f"main path: {name} is not finite")
    if tuple(st.U.shape) != (1, 2, RES, RES):
        raise SystemExit(f"main path: U has shape {tuple(st.U.shape)}")
    if min(launches.values()) < 1:
        raise SystemExit(f"main path missed a kernel: {launches}")
    print(f"ms/step {out['ms_per_step']:.4f}; mean|div| before projection "
          f"{out['div_in']:.6e}, after {out['div_out']:.6e}; "
          f"rho max {float(st.density.max()):.4f}; launches {launches} "
          f"({ {k: v / STEPS for k, v in launches.items()} } per step)",
          flush=True)
    done()

    phase_profile()

    meta = {
        "A": ("advect_all", "fluidnet_cxx_tpu_torch/csrc/advect_all.cu",
              "fluidnet_cxx_tpu/ops/pallas/advect_pallas.py:715"),
        "B": ("punet_conv2d", "fluidnet_cxx_tpu_torch/csrc/conv2d.cu",
              "fluidnet_cxx_tpu/ops/pallas/punet_pallas.py:366"),
        "C": ("project_tail", "fluidnet_cxx_tpu_torch/csrc/proj_tail.cu",
              "fluidnet_cxx_tpu/ops/pallas/proj_tail_pallas.py:164"),
    }
    kernels = []
    for k, (name, source, replaces) in meta.items():
        r = results[k]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
