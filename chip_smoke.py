"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its elapsed seconds):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with one nvcc command, printing the
     -Xptxas -v register, shared-memory and spill lines, and the dynamic
     shared memory of kernel M's backward march at each max_disp and of
     kernel E's tiles at max_disp 4 and the built limit;
  3. each kernel (A merged advection, B PUNet conv, C projection tail,
     D scalar advection, E velocity advection, F Jacobi, G multigrid
     solve, H multigrid projection, I 3-D Jacobi, J 3-D projection tail,
     K 3-D scalar advection, L 3-D merged advection, M 3-D velocity
     advection, N PUNet3 conv) against its plain PyTorch version on
     the card (TF32 off), with its tolerance, at the main paths' shapes:
     512^2 with 8% random obstacles; C bit for bit at 32 sweeps with
     scale and inlet, at 3 with neither, at 0, 1, 7, 8, 9 and at 9 with
     two samples; A, D and E bit for bit on the 512^2 stress inputs, A and
     D also on the plume scene's flags and the 128x512 Rayleigh-Taylor
     box (D with the trace on and off on all three), E on the 8000x800
     cylinder with its viscous field as `orig` (and at max_disp 1-4), A
     at max_disp 1-4 and D also at its built limit with the trace on and
     off, A and E with an `orig` far from U, D and A with the trace off
     and sample_outside on, D and E past their built max_disp (which must
     raise); F also at 800x8000 on the cylinder's flags;
     F, G and H also on the 512x128 Rayleigh-Taylor box (G and H cold and
     warm on both, each bit-equal on a repeat); at 512^2 G and H also no
     further than twice the plain version's float32 rounding from its
     float64 run; I, K, L and M at 128^3 with 8% random obstacles
     and displacements up to 3 cells (past the 3-D window clamp of 2), K
     and L with the first-hit trace on and off, L also against K and M, M
     also at max_disp 1, 3 and 4 (bit for bit),
     K, L and M also on the plume scene's flags (the border shell alone)
     with the same U, K and L timed with the trace on and off on both
     flag sets with the share of rays that walked their pruned box,
     I cold and warm with damping 6/7; J at 128^3 with 8% obstacles,
     cold and warm, damping 2/3, 16 and 8 sweeps, bit-exact; B each layer
     of the 512^2 forward on the activations the forward hands it, with
     the planner's split-K and with the 16^2 level's, then the whole
     forward; N each layer kind alone (1x1, 3x3x3, stride 2, 3x3x3 at
     8^3, the decoder's concat, the up and head layers) at the p8 main
     path's shapes in float32 and bfloat16, with the planner's split and
     with the 8^3 level's, then the whole PUNet3 forward at 128^3 with
     patch 8 (g0 16) and patch 4 (g0 32) in both, and each layer of the
     bfloat16 forwards on their own activations; B's and N's forwards
     called twice give the same bits; then CUDA-event times of the
     kernel, the plain version and, for B and N, the same forward as cuDNN
     F.conv2d/F.conv3d calls (N: in bfloat16 with channels_last_3d, and
     in float32), A (stress, scene and RT flags), B, C, D, E (cylinder
     and 512^2), F (also at 512x128 and 8000x800), G, H (cold and warm at
     512^2 and 512x128), I, J (16 and 8 sweeps), M (stress and scene
     flags), N and the cuDNN chains as device time (the call captured in
     a CUDA graph; the eager time beside it), A, C, D, E, G, H, J and M
     beside their times before their redesign (STEP0_MS), A and D with
     their pruned trace's walk and bound, G and H with
     their device time split into the single-block tail, the per-level
     launches and the rest, C into its prologue, sweeps and epilogue,
     C, F, G, H, I and J with their launches a call, and the
     per-layer tables of B (512^2) and N (p8, p4 in bfloat16): each
     layer's plan, blocks, device time, cuDNN's same layer and its bound;
     kernel G's learned cut (ops/kernels/mg.py::solve_mg_learned: the two
     halves of csrc/mg.cu around MGCoarseNet's PUNet on kernel B) with
     the trained MGCoarse_128 against the plain solve_mg(coarse_fn=...)
     within 1.4e-5 of the largest output, bit-equal on a repeat: 512^2
     plume flags with 8% obstacles, one V-cycle cold (the main path's) and
     two warm, and the 512x128 box (its cut is the tail's first level);
     the planner's tail rule against fn_mg_cut_level on 10 shapes; a cut
     inside the tail raising ValueError; its device time split into G's
     halves, B and the torch glue, with its launches and bound; B's
     bfloat16 route bit for bit against its plain version on inputs whose
     sums are exact, so that only its two rounding points are under test
     (check_bf16_rounding); B on MGCoarseNet's 128^2 input (16^2 after
     s2d; bfloat16, each layer within one bf16 ulp and at most one value
     in 1000 off, check_bf16) and on the 1000x100 map
     of PUNetD2_128 at 8000x800, layer by layer and whole, beside the
     cuDNN chain; H at 8000x800 on the cylinder's flags, cold and warm,
     after fn_mg_workspace and fn_mg_cut_level there, with its split;
     B's thin-channel route: every layer of FluidNetTower (DataTrain_128,
     10 convs) and MultiScaleNet (ScaleNet_jets_128, 17 convs, 5x5 taps
     among them) at 512^2 on the plume's assembled input at step 0, on
     zero-padded weights and 32-channel activations, against its plain
     version on the unpadded weights within 1e-5 of its largest output
     (its padded output channels exactly 0), each forward within 1e-4,
     a repeat bit-equal, device and eager ms beside the plain forward and
     the cuDNN chain, launches, the bound on the unpadded work, and the
     per-layer table; M with a viscous `orig` bit for bit at 128^3 (stress
     inputs) and on the 32x128x384 cylinder at max_disp 1-3, past its
     three rings' limit raising, timed beside M without it; N's flax route
     (flax's two roundings, bfloat16 up and head outputs, a bfloat16
     concat) bit for bit on exact sums and each layer of PUNet3p8_64's
     128^3 forward within one bfloat16 ulp at each rounding point with at
     most one value in 1000 off, the forward timed beside cuDNN's bfloat16
     chain; I's launches and the device time of one solve_mg3 at 128^3 and
     on the cylinder, the solve held to the CPU within 1e-5 (phase_new3d);
  4. small-input checks, the card against the plain path on the CPU:
     3 steps of the 64^2 plume with the learned projection, jacobi-28,
     mg-2v and unfused jacobi-28, and under DataTrain_128 and
     ScaleNet_jets_128 (the flax path), of the 256^2 plume under
     mg_learned, of
     the 64x32 Rayleigh-Taylor scene under multigrid, of the 64x256
     cylinder (radius 8 at x 40) under jacobi-34, multigrid and convnet,
     and of the 32^3 plume under jacobi-60, merged with the trace and
     separate with and without it, and under the learned projection with
     patch 8 and 4, the flax path and PUNet3p8j_64; the 32^3 plume under
     the 3-D multigrid; the 8x24x48 and 16x32x64 3-D cylinders (Jacobi;
     multigrid with vorticity confinement);
  5. the main paths, 20 steps each with every launch counter set to 0
     just before and read just after: the 512^2 plume with the learned
     projection (A, B, C), jacobi-200 (A, F) and mg-2v (A, H), the
     128x512 Rayleigh-Taylor scene under jacobi-200 (A, F) and multigrid
     (A, G), the 8000x800 cylinder under jacobi-34 (E, F) and the 512^2
     plume with unfused advection under jacobi-200 (D, E, F), and the
     128^3 3-D plume under jacobi-60 (scripts/bench3d.py's classical
     case) with separate advection without the trace (K, M, I) and with
     it (K, M, I; bench3d's --lineTrace), and with merged advection and
     the first-hit trace (L, I), and bench3d's learned case
     at 128^3 with PUNet3p8_64 (K, M, J, N) and PUNet3_32 (patch 4; K, M,
     J, N) at full widths, the trained weights (each run prints which),
     and with PUNet3p8j_64 and PUNet3p8r_64, the flax path with
     PUNet3p8_64 as it ships (K, M, N's flax route, I), bench3d's "pallas
     + multigrid" case merged (L, I in solve_mg3), the 32x128x384 3-D
     cylinder under jacobi-34 and multigrid and jacobi-34 with vorticity
     confinement (M with orig, I),
     the 512^2 plume under mg_learned with the trained MGCoarse_128 (A,
     G's learned cut, B), and the 8000x800 cylinder under multigrid (E, H)
     and under PUNetD2_128 (E, B, C; the step's unfused branch), and the
     512^2 plume under the flax-path FluidNet with DataTrain_128's
     FluidNetTower (A, B 10 convs) and ScaleNet_jets_128's MultiScaleNet
     (A, B 17 convs), no polish (C 0); finite
     fields, ms per step, quality stats (mean|div|, max|div|), launches
     per step (J, N, C on the 512^2 convnet step, F on the jacobi paths,
     H on mg-2v and the cylinder's multigrid, G on the RT multigrid path,
     the learned cut and B (its bfloat16 route) on mg_learned, B and C
     on the cylinder's
     convnet, E on the cylinder and D and E on the unfused plume held to
     their exact counts) and C entry (ctypes) calls per step (C's
     fn_tail, F's fn_jacobi_solve, H's fn_mg_project and each half of
     the learned cut held to one a step); then the `kernels` JSON line
     (the 14 kernels, and rows for G's learned cut, B's bfloat16 route
     on MGCoarse_128 at 128^2, B on the
     1000x100 map and on the tower's and ScaleNet's 512^2 forwards, H and
     C at 8000x800, M with orig and N's flax route);
  6. a torch.profiler window of 5 more steps of each main path: device
     time per step, the device's idle share, the 8 kernels that take the
     most device time and every other kernel of the port's;
  7. the benches (fluidnet_cxx_tpu_torch/bench.py and bench3d.py) called
     as functions: the five 2-D cases at 128^2 with their full 400-step
     rollouts and cnn at 512^2 with its 300-step rollout, and the 3-D
     classical row's 60-step rollout at 128^3, each held to
     bench_reference.json (the JAX package's columns: mean|div| and
     max|div| within 1%, the height within a row; 3-D max|div|, mean|div|,
     density sum and max|U| within 1%), and bench3d's classical and
     multigrid rows at 64^3 (their JAX reference's size); every case
     timed as a CUDA-graph
     replay and eagerly at a reduced n; each case's line printed.
  8. training (ROADMAP A.5; configs/train.yaml's FluidNetTower and
     MultiScaleNet at 128^2, batch 64, seed weights): the input gradient
     fn_conv2d_dgrad (csrc/conv2d_dgrad.cu, ops/kernels/conv_grad.py::
     conv2d_dgrad) on every conv call of the tower's forward but conv1, on
     each of its routes that takes the layer (the planned one named), held
     to cuDNN's conv2d_input on the unpadded weights within 1e-5 of its
     largest value and to its plain version (padded input channels exactly
     0), each route timed beside the parent's time (DGRAD_STEP0_MS), and
     the weight
     gradient fn_conv2d_wgrad (csrc/conv2d_grad.cu) on every call, held
     to twice the plain float32 version's (torch.nn.grad.conv2d_weight
     and a sum) distance from its float64 run, each bit-equal on a repeat,
     timed as device ms beside the plain version and cuDNN with the
     bound; the same on every ScaleNet layer (wgrad over each layer's real
     channels, its padded entries exactly 0, also timed under one fixed
     plan per output-channel class), each net's summed wgrad in the
     kernels line; both nets' forward and
     backward through the kernels against plain autograd on the card and
     in float64 (batch 16; the kernel route within twice the plain float32
     route's distance from float64); one loss and its gradients at 64^2,
     batch 4, LT on with a fixed 4-step draw, the card against the CPU
     (terms 1e-4, gradients 1e-3 of the net's largest); the main paths: make_on_device_train_step with
     TrainConfig() and 600 label sweeps, 10 steps of the tower and 5 of
     ScaleNet (one warm-up each, then the counters set to 0): ms/step,
     finite loss terms, peak memory, launches per step of B's forward,
     its input gradient, wgrad, E and F (the backward's exact), a
     profiler window of one more step; then the dataset path (--synthetic
     8 at 128^2, batch 16, one epoch with validation, a checkpoint, a
     resume to a second epoch whose step count continues) and
     --plumeFrames 16 with 5 mixed steps, through the entry point. PUNet
     (PUNetD2_128's architecture: widths 96/128/128, dilation 2, 32 damped
     "xla" polish sweeps; ROADMAP A.5.1) the same way: every conv call's
     input gradient (fn_conv2d_dgrad, at stride 2 on down1 and down2 with
     its output-parity classes' tap counts printed and the stride-2
     subtotal, the skip concat's over [up | skip]) against the plain
     version and cuDNN's conv2d_input, its
     weight gradient against float64; the polish adjoint
     (fn_jacobi_adjoint) bit for bit against its plain version on the
     512^2 stress flags and the batch's flags at 128^2, batch 64, timed;
     its forward and backward, its 64^2 loss card against CPU, and its
     train main path (10 steps, the input gradient and the adjoint
     counted); the kernels line's rows for them;
  8b. 3-D training (scripts/train3d.py's twin, ROADMAP A.5.2): on every
     layer of train3d.py's p4 (32^3) and p8 (64^3) nets at batch 4, N's
     flax route within one bf16 ulp at each rounding point, and the
     gradient kernels fn_conv3d_dgrad and fn_conv3d_wgrad against their
     plain versions (bit for bit on dyadic inputs, one bf16 ulp on the
     layer's own inputs and upstream gradient, the bias gradient bit for
     bit, bit-equal repeats), each timed beside cuDNN's bf16
     conv3d_input / conv3d_weight and its bound, summed over a train
     step's calls; I's adjoint fn_jacobi3_adjoint bit for bit (8 and 16
     damped and 9 undamped sweeps, obstacles) and I's 400 label sweeps at
     batch 4; one bf16 train step card against the CPU's plain step; the
     three main paths (32^3 p4 for 50 steps, 64^3 p8 for 20, 32^3 with
     --plumeFrames 8 for 20) with launch counters held to the model,
     ms/step, the held-out loss before and after, a profiler window;
     the twin CLI for 10 steps, then run_plume3d from its model dir; the
     kernels line's six rows (phase_train3d);
  8c. bfloat16 2-D training (ROADMAP A.5.3, A.4.3): on every conv call of
     MGCoarseNet (128^2 cut, batch 16) and of PUNetD2_128's architecture,
     the tower and ScaleNet in bfloat16 (128^2, batch 64), B's bfloat16
     forward within one bf16 ulp at each rounding point (5x5 taps and
     thin layers among them), and fn_conv2d_bf16_dgrad,
     fn_conv2d_bf16_wgrad and fn_bias_grad_bf16 against their plain
     versions (bit for bit on dyadic inputs; one bf16 ulp on the layer's
     own inputs, against the exact sum where the plain float32 sum over a
     million cells is itself that far off; the bias bit for bit;
     bit-equal repeats), each timed beside cuDNN's bf16 conv2d_input /
     conv2d_weight (and torch's sum) and its bound; one bf16 step of each
     net card against CPU; the train_mg_coarse twin at --res 512 for 20
     steps (launches held, the loss must fall), run_plume --simMethod
     mg_learned from its model dir; the three nets' bf16 trainer main
     paths (no float32 gradient launch); the kernels line's twelve rows
     (phase_train_bf16);
  9. the scene drivers' twins (`python -m fluidnet_cxx_tpu_torch.scripts.
     run_plume`, `run_rayleigh_taylor`, `run_cylinder`) as users run them,
     from the shipped YAMLs with realTimePlot false: the 128^2 plume under
     jacobi-200 (with VTK), PUNetD2_128 on the flax path and multigrid,
     mg_learned at 256^2; RT 128x512 jacobi-200 and multigrid; the
     8000x800 cylinder under jacobi-34, multigrid and PUNetD2_128; each
     straight (its files checked), then cut and resumed with --restartSim,
     the final p, U and density bit-equal to the straight run's, with
     ms/step, launches per step and mean/max|div|; then `python -m
     fluidnet_cxx_tpu_torch.train --trainConfig configs/train.yaml
     --onDevice 2 --bsz 8` to a finite loss;
  10. the advection engines of the JAX step's XLA path (ROADMAP A.6) and
     the drivers that run on them (phase_engines): the 512^2 plume with a
     disc in its way under plume_config's defaults (use_pallas off: the
     march trace on the window engine for the density, E for the
     velocity), Euler and the gather engine, Jacobi-200 on F, 20 steps
     each with ms/step, mean/max|div| and launches by kernel, then a
     profiler window's device busy and idle share; each engine 3 steps
     at 64^2 and the blob's config 2 steps at 48^3, card against CPU
     within 1e-5 of each field's largest value; the twins `run_blob3d`
     (48^3, --maxIter 50 --statIter 25: I and M), bench3d's "window
     (XLA)" and "gather" rows at 128^3, `eval_parity` (--res 128 --iters
     200 --statIter 50 with PUNetD2_128: E, F, B), `quality_per_ms`
     (--res 512 --iters 100 --statIter 50 --jacobi 28,200 --mg 2 --polish
     32: A, F, H, B and G), `make_dataset` (2+1 scenes at 128^2, 16
     frames: A and H) and `preprocess_data` over them, each with its
     launches by kernel and finite output;
  11. multi-device (ROADMAP A.8, phase_multidevice): one NCCL rank on the
     card (an all_reduce, the sharded Jacobi at dp = sx = 1 bit for bit),
     then two gloo ranks sharing it (NCCL refuses two ranks on one
     device): the sharded Jacobi-34 at sx = 2 on the 8000x800
     cylinder's flags bit for bit against F on the whole grid, the
     cylinder, the 512^2 plume under use_pallas and the 128^3 plume
     merged and unfused, each sharded at sx = 2 against the
     single-process steps (within about three times the difference
     measured: the slabs trace in their own coordinates), the same four
     cases from a velocity in multiples of 1/8 at dt 1/4 without the line
     trace (every back-traced position exact in any coordinates) bit for
     bit, which holds the halo's reach on A, E, K, L and M; the tower's DP train
     step at 128^2, batch 64, dp = 2 (loss terms within 1e-5, the
     gradient within 1e-4 relative L2, parameters bit-equal on both
     ranks), with launches a sharded step; `parallel.dryrun --nproc 2
     --backend gloo`; the plume twin without --fast at 128^2; then
     (ROADMAP A.8.1, multidevice_a81_ranks) two more gloo ranks at sx = 2
     with trained weights: the 8000x800 cylinder under multigrid (E and
     the slab entries of csrc/mg.cu) and PUNetD2_128 (E, B, C), the 512^2
     plume under mg_learned (A, B's bf16 route, the slab entries),
     PUNetD2_128 fused (A, B, C), DataTrain_128 on the flax path (A, B)
     and the gather engine (F), the 128x512 Rayleigh-Taylor box under
     multigrid (A, the slab entries), the 128^3 plume under solve_mg3 (L,
     I) and PUNet3p8_64 fused (K, M, N, J), each against the
     single-process step within MULTI_A81_TOL, with its halo, exchanges
     and launches a step. Before it (phase_slab_kernels, after phase 3's
     G and H) each slab entry on a slab of the cylinder's flags against
     its plain version within SLAB_TOL, bit-equal on a repeat, timed
     beside the plain version and its bound. Every time beside the card's
     name and power limit; two ranks on one card measure no scaling.
`python3 chip_smoke.py --mg-only` times kernels G and H alone (mg_only),
`python3 chip_smoke.py --3d-only` kernels J, M, K and L, phase_new3d, the
new 3-D small checks and the 3-D paths with J, M or multigrid
(threed_only),
`python3 chip_smoke.py --adv-only` kernels A, D and E (adv_only),
`python3 chip_smoke.py --tail-only` kernels C and F (tail_only),
`python3 chip_smoke.py --learned-only` G's learned cut, H at 8000x800, B
on the 1000x100 map and the mg_learned and cylinder paths (learned_only),
`python3 chip_smoke.py --nets-only` B's thin-channel phase, the 64^2
card-against-CPU checks and the 512^2 main paths of DataTrain_128 and
ScaleNet_jets_128 (nets_only),
`python3 chip_smoke.py --train-only` phase 8 alone and the kernels line
of its five rows (train_only), `python3 chip_smoke.py --dgrad-only` the
input gradient of phase 8 alone, every route on every layer
(dgrad_only), `python3 chip_smoke.py --drivers-only` phase 9 alone
(phase_drivers), `python3 chip_smoke.py --train3d-only` phase 8b alone
and the kernels line of its six rows (train3d_only), `python3
chip_smoke.py --mg-coarse-only` phase 8c alone and the kernels line of
its twelve rows (mg_coarse_only), `python3 chip_smoke.py --engines-only`
phase 10 alone (phase_engines), `python3 chip_smoke.py --multi-only`
phase_slab_kernels and phase 11 alone (phase_multidevice).
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without it; a watchdog turns a phase that hangs for 600 s into a non-zero
exit with a traceback. Imports nothing of JAX.

Bounds (`bound_ms`) are the larger of bytes moved (each input read once,
each output written once) over 3.35 TB/s and operations over 67 TFLOP/s
(H100 SXM fp32 without tensor cores) or, for N's bfloat16 products, 989
TFLOP/s (dense bf16 tensor cores), counted from this run's inputs; B's
line also prints its 3xTF32 figure (three TF32 products a multiply-add at
495 TFLOP/s).
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
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
# Kernel B's float32 multiply-add is three TF32 tensor-core products
# (3xTF32), the card's fastest route at float32's accuracy: B's bounds
# take its operations at a third of the TF32 rate.
TF32X3_OPS_PER_S = TF32_OPS_PER_S / 3
RES = 512
RES3 = 128
# The side of bench_reference.json's 3-D multigrid row (plume3d:64:mg2v).
MG3_REF_RES = 64
RT_W, RT_H = 128, 512
CYL_W, CYL_H = 8000, 800
STEPS = 20
SEED = 0
MODEL_P8 = "trained_models/PUNet3p8_64"
MODEL_P4 = "trained_models/PUNet3_32"
# The reference's own 2-D nets on the flax path (results key -> checkpoint).
NETS = {"B tower": "trained_models/DataTrain_128",
        "B scalenet": "trained_models/ScaleNet_jets_128"}
# (device ms, eager ms) of kernels before their redesign (Step 0), printed
# beside this run's, NVIDIA H100 80GB HBM3 at 700 W: G and H in each case
# of mg_cases (`chip_smoke.py --mg-only` in a checkout of the commit before
# their redesign), J, M, K and L in each case of cases3d (`chip_smoke.py
# --3d-only` in a checkout of the commit before J's and M's; K and L were
# not redesigned then, their times there are the spread's reference), A
# and E in each case of adv_cases (`chip_smoke.py --adv-only` in a
# checkout of the commit before A's trace and E's), C and F in each case
# of tail_cases and D in adv_cases' (`--tail-only` and `--adv-only` in a
# checkout of the commit before C's and D's; F was not redesigned then).
STEP0_MS = {"G 512^2 cold": (0.2390, 1.2144),
            "H 512^2 cold": (0.2404, 0.7435),
            "G 512^2 warm": (0.2397, 0.8818),
            "H 512^2 warm": (0.2487, 0.8891),
            "G RT cold": (0.1818, 0.4410), "H RT cold": (0.1820, 0.4298),
            "G RT warm": (0.1815, 0.5678), "H RT warm": (0.1819, 0.4367),
            "J 16 warm": (0.2400, 0.2858), "J 8 warm": (0.1522, 0.1770),
            "M stress": (0.2228, 0.2261), "M scene": (0.2187, 0.2225),
            "K stress": (0.1600, 0.1637),
            "L stress trace": (0.5919, 0.6021),
            "A stress": (0.0976, 0.1006), "A scene": (0.0627, 0.0660),
            "A RT": (0.0286, 0.0312),
            "E cylinder": (0.2154, 0.2192), "E 512^2": (0.0117, 0.0242),
            "C 32": (0.0668, 0.2268), "F 200": (0.1864, 0.3202),
            "D stress": (0.0342, 0.0373), "D scene": (0.0264, 0.0426),
            "D RT": (0.0137, 0.0274)}
# Device ms of the input gradient before its redesign for Hopper (kernel
# B's body with a transposed gather over padded channels), per conv call
# of phase 8's nets at 128^2, batch 64 ("model layer map" -> ms), printed
# beside this run's: `chip_smoke.py --train-only` in a checkout of the
# commit before the redesign, NVIDIA H100 80GB HBM3 at 700 W.
DGRAD_STEP0_MS = {"FluidNet bank_conv1 128x128": 0.7918,
                  "FluidNet bank_conv2 128x128": 0.7987,
                  "FluidNet bank_conv1 64x64": 0.2058,
                  "FluidNet bank_conv2 64x64": 0.2059,
                  "FluidNet bank_conv1 32x32": 0.0566,
                  "FluidNet bank_conv2 32x32": 0.0565,
                  "FluidNet conv2 128x128": 0.1958,
                  "FluidNet conv3 128x128": 0.1976,
                  "FluidNet convOut 128x128": 0.297,
                  "ScaleNet convN_4/Conv_1 32x32": 0.1018,
                  "ScaleNet convN_4/Conv_2 32x32": 0.0759,
                  "ScaleNet convN_4/Conv_3 32x32": 0.064,
                  "ScaleNet convN_2/Conv_0 64x64": 0.5253,
                  "ScaleNet convN_2/Conv_1 64x64": 0.3828,
                  "ScaleNet convN_2/Conv_2 64x64": 1.0106,
                  "ScaleNet convN_2/Conv_3 64x64": 0.9848,
                  "ScaleNet convN_2/Conv_4 64x64": 0.2753,
                  "ScaleNet convN_2/Conv_5 64x64": 0.2286,
                  "ScaleNet convN_1/Conv_0 128x128": 2.004,
                  "ScaleNet convN_1/Conv_1 128x128": 1.4794,
                  "ScaleNet convN_1/Conv_2 128x128": 3.8182,
                  "ScaleNet convN_1/Conv_3 128x128": 3.7577,
                  "ScaleNet convN_1/Conv_4 128x128": 1.0517,
                  "ScaleNet convN_1/Conv_5 128x128": 2.0175,
                  "ScaleNet final 128x128": 0.298,
                  "PUNet enc0_0 16x16": 0.0827, "PUNet down1 16x16": 0.1215,
                  "PUNet enc1_0 8x8": 0.0516, "PUNet down2 8x8": 0.056,
                  "PUNet enc2_0 4x4": 0.0214, "PUNet mid0 4x4": 0.0211,
                  "PUNet mid1 4x4": 0.0216, "PUNet mid2 4x4": 0.0215,
                  "PUNet up1 4x4": 0.0152, "PUNet dec1_0 8x8": 0.0887,
                  "PUNet up0 8x8": 0.0246, "PUNet dec0_0 16x16": 0.161,
                  "PUNet head 16x16": 0.0155}


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


def graph_ms(fn, reps=20):
    """Device milliseconds of one call of ``fn``: ``reps`` calls captured
    in one CUDA graph, replayed once between CUDA events (the host's
    launches of each call are not in the time)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_and_eager(fn):
    """(device ms, eager ms) of one call of ``fn``: graph_ms, and cuda_ms
    over 20 eager calls (the host's launches inside the time)."""
    return graph_ms(fn), cuda_ms(fn, 20)


def launches_of(counter, fn):
    """Kernel launches one call of ``fn`` adds to ``counter.launches``."""
    before = counter.launches
    fn()
    return counter.launches - before


def cont_cells(f):
    """Continuation cells of 2-D flags: interior and not obstacle."""
    return float((f[:, 1:-1, 1:-1] != 2).sum())


def bound(nbytes, nops, ops_per_s=FP32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
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


def advect_ops(flags, D, per_cell=300.0, trace=True):
    """Operations of one advection call on these flags: ``per_cell`` (~150
    for each of the scalar and the velocity half) plus, with the trace,
    two slab tests (~20 ops each) per blocked cell in each fluid cell's
    (2D+1)^2 trace window, for the forward and the backward trace."""
    ops = per_cell * flags.numel()
    if not trace:
        return ops
    blocked = (flags != 1).float()[:, None]
    k = 2 * D + 1
    in_window = torch.nn.functional.conv2d(
        blocked, torch.ones((1, 1, k, k), device=flags.device), padding=D)
    fluid = (flags == 1)[:, None]
    return ops + 2 * 20.0 * float(in_window[fluid].sum())


def far_orig(gen, U):
    """A field that U advects, far from U: U plus a seeded field of the
    same scale (a kernel that read U where it must read orig fails)."""
    noise = torch.rand(U.shape, generator=gen) - 0.5
    return U + 100.0 * noise.to(U.device)


def phase_kernels(dev, results):
    from fluidnet_cxx_tpu_torch.ops.kernels import proj_tail

    gen = torch.Generator().manual_seed(SEED)
    n = RES * RES

    phase_conv2d(dev, gen, results)

    # ---- C: projection tail ----
    done = phase("kernel C project_tail")
    inputs = tail_inputs(dev)
    cases = tail_cases(inputs)
    err = check_tail(inputs, cases)
    run, plain = cases["C 32"][:2]
    ms, eager_ms = device_and_eager(run)
    print_step0("C 32", ms, eager_ms)
    plain_ms = cuda_ms(plain, 5)
    b_ms, b_by = bound(44 * n, (32 * 10 + 30) * n)
    results["C"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
    print(f"C: kernel {ms:.4f} ms device (eager {eager_ms:.4f}), "
          f"{launches_of(proj_tail.project_tail, run)} launches, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    print_tail_split(device_split(run))
    done()
    phase_advection(dev, results)
    phase_f_cylinder(dev)


def tail_inputs(dev):
    """Kernel C's inputs at 512^2 as the convnet step hands them over: the
    stress flags (8% obstacles) and U, a warm start, a scale and the plume
    scene's inlet fields; the divergence of U for kernel F."""
    from fluidnet_cxx_tpu_torch.ops.stencils import velocity_divergence
    from fluidnet_cxx_tpu_torch.sim.scenes import create_plume_scene

    gen = torch.Generator().manual_seed(SEED + 7)
    flags, U, _ = stress_inputs(gen, dev, RES)
    scene = create_plume_scene(RES, RES, 0.1, 8.0, 0.145, device=dev)
    p0 = torch.randn((1, RES, RES), generator=gen).to(dev)
    kw = dict(damping=2.0 / 3.0, scale=torch.tensor([0.37], device=dev),
              U_bc=scene.U_bc, U_bc_inv_mask=scene.U_bc_inv_mask)
    return dict(flags=flags, U=U, p0=p0, kw=kw,
                div=velocity_divergence(U, flags))


def tail_cases(inputs):
    """name -> (kernel call, plain call, the wrapper that counts its
    launches) of C at 512^2 with 32 damped sweeps, scale and inlet (the
    convnet step's), and of F at 512^2 with 200 sweeps."""
    from fluidnet_cxx_tpu_torch.ops.jacobi import solve_jacobi_fixed
    from fluidnet_cxx_tpu_torch.ops.kernels import jacobi, proj_tail

    flags, U, p0, kw, div = (inputs[k] for k in ("flags", "U", "p0", "kw",
                                                 "div"))
    return {
        "C 32": (lambda: list(proj_tail.project_tail(flags, U, p0, 32, **kw)),
                 lambda: list(proj_tail.project_tail_plain(flags, U, p0, 32,
                                                           **kw)),
                 proj_tail.project_tail),
        "F 200": (lambda: [jacobi.solve_jacobi(flags, div, 200)],
                  lambda: [solve_jacobi_fixed(flags, div, 200)],
                  jacobi.solve_jacobi)}


def check_tail(inputs, cases):
    """C bit for bit against its plain version: 32 sweeps with scale and
    inlet, 3 with neither, 0, 1, 7, 8 and 9 with both (each parity of the
    ping-pong, a launch's last sweep and one past it) and two samples at 9;
    F at 200 sweeps. Returns C's error at 32 sweeps."""
    from fluidnet_cxx_tpu_torch.ops.kernels import proj_tail

    flags, U, p0, kw = (inputs[k] for k in ("flags", "U", "p0", "kw"))
    errs = {}
    for name, (run, plain, _) in cases.items():
        got = run()
        torch.cuda.synchronize()
        errs[name] = max_err(got, plain())
        check(name, errs[name], 0.0)
    cat = lambda t: torch.cat([t, t.flip(-1)]).contiguous()
    two = dict(damping=kw["damping"], scale=torch.cat([kw["scale"],
                                                       2 * kw["scale"]]),
               U_bc=cat(kw["U_bc"]), U_bc_inv_mask=cat(kw["U_bc_inv_mask"]))
    for iters, args in ((3, (flags, U, p0)), (0, None), (1, None), (7, None),
                        (8, None), (9, None), (9, "b2")):
        if args == "b2":
            a, k, what = (cat(flags), cat(U), cat(p0)), two, ", b = 2"
        elif args is None:
            a, k, what = (flags, U, p0), kw, ""
        else:
            a, k, what = args, {}, ", no scale or inlet"
        check(f"C {iters} sweeps{what}",
              max_err(proj_tail.project_tail(*a, iters, **k),
                      proj_tail.project_tail_plain(*a, iters, **k)), 0.0)
    return errs["C 32"]


def print_tail_split(split):
    """C's device time by launch kind: prologue, sweeps, epilogue (a
    folded launch counts as sweeps), then each kernel."""
    parts = {g: [0.0, 0.0] for g in ("prologue", "sweeps", "epilogue")}
    for key, (ms, n) in split.items():
        g = next((g for g in ("prologue", "epilogue") if g in key), "sweeps")
        parts[g][0] += ms
        parts[g][1] += n
    print("C split: " + ", ".join(f"{g} {ms:.4f} ms ({n:g} launches)"
                                  for g, (ms, n) in parts.items()),
          flush=True)
    for key, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.4f} ms {n:5.1f} launches  {key[:90]}", flush=True)


def check_repeat(name, fn):
    """Two calls of ``fn`` give the same bits (fixed-order sums, no
    atomics)."""
    a, b = fn(), fn()
    same = torch.equal(a, b)
    print(f"{name}: two calls bit-equal {same}", flush=True)
    if not same:
        raise SystemExit(f"{name} is not deterministic")


def record_layers(run, wrapper):
    """Run a forward whose ``conv`` hook calls ``wrapper``; return [(name,
    args, kwargs)] of each conv call in forward order."""
    calls = []

    def hook(name, args, kwargs):
        calls.append((name, args, kwargs))
        return wrapper(*args, **kwargs)

    run(hook)
    return calls


def conv_table(title, rows):
    """Print the per-layer table: kernel and cuDNN device ms of each layer
    in the same run (graph_ms), its bound, its plan and blocks."""
    print(f"{title}: layer, M, co, K, plan (bm x bn, splits), blocks, "
          "kernel ms, cuDNN ms, bound ms", flush=True)
    for r in rows:
        print(f"  {r['name']:8s} M {r['m']:6d} co {r['co']:4d} K {r['k']:5d} "
              f"{r['bm']:3d}x{r['bn']:<3d} S {r['splits']:2d} blocks "
              f"{r['blocks']:4d}  kernel {r['ms']:.4f}  cuDNN "
              f"{r['lib_ms']:.4f}  bound {r['bound_ms']:.4f}", flush=True)
    tot = {k: sum(r[k] for r in rows) for k in ("ms", "lib_ms", "bound_ms")}
    print(f"  sum of layers: kernel {tot['ms']:.4f}  cuDNN "
          f"{tot['lib_ms']:.4f}  bound {tot['bound_ms']:.4f}", flush=True)


def phase_conv2d(dev, gen, results):
    """Kernel B at the 512^2 plume's shapes: each layer of the PUNetD2_128
    forward on the activations the forward hands it, with the planner's
    split and with the 16^2 level's split; the whole forward; repeats; the
    per-layer table beside cuDNN's same layer (float32, TF32 off)."""
    from fluidnet_cxx_tpu_torch.config import load_model_config
    from fluidnet_cxx_tpu_torch.models.convert import STATE_DICT_FILE
    from fluidnet_cxx_tpu_torch.ops.kernels import punet
    from fluidnet_cxx_tpu_torch.ops.kernels.conv_plan import plan_conv
    from fluidnet_cxx_tpu_torch.ops.kernels.punet import same_pads
    from fluidnet_cxx_tpu_torch.run_plume import MODEL_DIR, build_net

    done = phase("kernel B punet conv")
    n = RES * RES
    mcfg = load_model_config(str(MODEL_DIR))
    net = build_net(mcfg, None, dev)
    print(f"B: trained weights, {MODEL_DIR.name}/{STATE_DICT_FILE}",
          flush=True)
    with torch.no_grad():
        packed = punet.pack_weights(net)
    x = torch.stack([torch.randn((1, RES, RES), generator=gen),
                     (torch.rand((1, RES, RES), generator=gen) < 0.1).float()],
                    dim=-1).to(dev)
    inv = torch.tensor([3.0], device=dev)
    # The same net at 128^2: its first level is the 512^2 net's 16^2 one.
    gen128 = torch.Generator().manual_seed(SEED + 6)
    x128 = torch.stack([
        torch.randn((1, RES // 4, RES // 4), generator=gen128),
        (torch.rand((1, RES // 4, RES // 4), generator=gen128) < 0.1).float()],
        dim=-1).to(dev)

    def run_on(xin):
        def run(hook):
            def conv(name, h, x2=None, relu=True, in_scale=None,
                     scale_mod=1):
                w, b = packed[name]
                _, stride, dil = net.geometry[name]
                return hook(name, (h, w, b, stride, dil, relu, x2, in_scale,
                                   scale_mod), {})
            return net(xin, inv_scale=inv, conv=conv)
        return run

    def geometry(args):
        h, w, _, stride, _, _, x2, _, _ = args
        m = h.shape[0] * (-(-h.shape[1] // stride)) ** 2
        c2 = 0 if x2 is None else x2.shape[-1]
        return m, w.shape[3], w.shape[0] ** 2, h.shape[-1], c2

    with torch.no_grad():
        layers = record_layers(run_on(x), punet.conv2d_nhwc)
        torch.cuda.synchronize()
        # Each layer within 1e-5 of its largest output: 3xTF32 drops the
        # small x small term (below 2^-21 of each product) and the sum runs
        # in another order than cuDNN's float32 conv. At 512^2 and at
        # 128^2, where every layer kind runs at the 16^2 level's size with
        # the split the planner gives it there.
        for side, recs in ((RES, layers), (RES // 4, record_layers(
                run_on(x128), punet.conv2d_nhwc))):
            for name, args, _ in recs:
                h, w, *rest = args
                want = punet.conv2d_nhwc_plain(h, w.permute(3, 2, 0, 1),
                                               *rest)
                got = punet.conv2d_nhwc(*args)
                torch.cuda.synchronize()
                plan = plan_conv(*geometry(args), "tf32x3")
                check(f"B layer {name} at {side}^2 (plan {plan.bm}x{plan.bn},"
                      f" {plan.splits} splits)", max_err([got], [want]),
                      1e-5 * float(want.abs().max()))
        fwd = lambda: punet.net_forward(net, packed, x, inv_scale=inv)
        got = fwd()
        torch.cuda.synchronize()
        want = net(x, inv_scale=inv)
        err, tol = max_err([got], [want]), 1e-4 * scale_of([want])
        check("B punet conv", err, tol)
        check_repeat("B punet forward", fwd)
        ms = graph_ms(fwd)
        eager_ms = cuda_ms(fwd, 20)
        plain_ms = cuda_ms(lambda: net(x, inv_scale=inv), 20)

        library = punet_library(net, x, inv)
        lib_err = max_err([library().permute(0, 2, 3, 1)], [want])
        print(f"B library forward vs plain: max_abs_err {lib_err:.3e}")
        library_ms = graph_ms(library)
        library_eager_ms = cuda_ms(library, 20)

        rows = []
        for name, args, _ in layers:
            h, w, b, stride, dil, relu, x2, in_scale, scale_mod = args
            m, co, taps, c1, c2 = geometry(args)
            hn = punet._scaled(h, in_scale, scale_mod)
            if x2 is not None:
                hn = torch.cat([hn, x2], dim=-1)
            p = same_pads(h.shape[1], w.shape[0], stride, dil)
            hn = torch.nn.functional.pad(hn.permute(0, 3, 1, 2),
                                         (p[0], p[1], p[0], p[1]))
            wn = w.permute(3, 2, 0, 1).contiguous()

            def lib(hn=hn, wn=wn, b=b, stride=stride, dil=dil, relu=relu):
                y = torch.nn.functional.conv2d(hn, wn, b, stride=stride,
                                               dilation=dil)
                return torch.relu(y) if relu else y

            plan = plan_conv(m, co, taps, c1, c2, "tf32x3")
            ops = 2.0 * m * co * taps * (c1 + c2)
            nbytes = 4 * (h.numel() + (0 if x2 is None else x2.numel())
                          + w.numel() + co + m * co)
            rows.append(dict(
                name=name, m=m, co=co, k=taps * (c1 + c2), bm=plan.bm,
                bn=plan.bn, splits=plan.splits, blocks=plan.blocks,
                ms=graph_ms(lambda: punet.conv2d_nhwc(*args)),
                lib_ms=graph_ms(lib),
                bound_ms=bound(nbytes, ops, TF32X3_OPS_PER_S)[0]))
        conv_table(f"B per layer at {RES}^2 (bound: 3xTF32 rate)", rows)
    macs = punet_macs(net, RES, RES)
    wbytes = sum(4 * (w.numel() + b.numel()) for w, b in packed.values())
    b_ms, b_by = bound(4 * x.numel() + wbytes + 4 * n, 2.0 * macs,
                       TF32X3_OPS_PER_S)
    results["B"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=library_ms)
    print(f"B: kernel {ms:.4f} ms (eager {eager_ms:.4f}), plain "
          f"{plain_ms:.3f} ms, library {library_ms:.4f} ms (eager "
          f"{library_eager_ms:.4f}), bound {b_ms:.4f} ms ({b_by}, 3xTF32; "
          f"fp32 CUDA cores {1e3 * 2.0 * macs / FP32_OPS_PER_S:.4f} ms), "
          f"{2.0 * macs / 1e9:.3f} GFLOP", flush=True)
    done()


def punet_library(net, x, inv=None):
    """The PUNet forward of NHWC ``x`` as cuDNN F.conv2d calls on NCHW
    tensors in the net's compute dtype (the library call of kernel B's
    row); returns it as a function of no arguments."""
    from fluidnet_cxx_tpu_torch.models.punet import (depth_to_space,
                                                     space_to_depth)
    from fluidnet_cxx_tpu_torch.ops.kernels.punet import same_pads

    dt = net.compute_dtype
    wts = {name: (c.weight.detach().to(dt), c.bias.detach().to(dt))
           for name, c in net.convs.items()}

    def library():
        h = x.clone()
        if inv is not None:
            h[..., 0] *= inv[0]
        h = space_to_depth(h.to(dt), net.patch).permute(0, 3, 1, 2)

        def conv(name, h, relu=True):
            k, s, d = net.geometry[name]
            ph = same_pads(h.shape[-2], k, s, d)
            pw = same_pads(h.shape[-1], k, s, d)
            h = torch.nn.functional.conv2d(
                torch.nn.functional.pad(h, (pw[0], pw[1], ph[0], ph[1])),
                *wts[name], stride=s, dilation=d)
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
        return d2s(conv("head", h, relu=False), net.patch).float()

    return library


def punet_macs(net, h, w):
    """Multiply-adds of one PUNet forward on an h x w input: each layer's
    output cells (s2d by the patch first, stride-2 downs halve the sides,
    each up's depth-to-space doubles them) times its weights."""
    sizes, side = {}, (h // net.patch, w // net.patch)
    for name in net.convs:
        if net.geometry[name][1] == 2:
            side = (side[0] // 2, side[1] // 2)
        sizes[name] = side[0] * side[1]
        if name.startswith("up"):
            side = (2 * side[0], 2 * side[1])
    return sum(sizes[nm] * c.weight.numel() for nm, c in net.convs.items())


# A bfloat16 forward's distance from its plain version, as a share of its
# largest output: a float32 sum taken in another order rounds a few
# activations to the neighbouring bfloat16 and the next layers carry
# that on (on an H100 8.3e-3 on MGCoarse_128's 128^2 input; twice that,
# rounded up).
BF16_FORWARD_TOL = 2e-2
# mg_learned's pressure after one cold V-cycle at 512^2 with the bfloat16
# net against its plain version, as a share of the largest pressure (on an
# H100 1.7e-7: no activation rounds the other way on that input).
BF16_VCYCLE_TOL = 1e-6
# mg_learned's fields after 3 plume steps at 256^2, card against CPU, as a
# share of each field's largest value: the net's rounding carried through
# the steps (on an H100 3.3e-3; twice that, rounded up).
BF16_PATH_TOL = 7e-3
# Of a bfloat16 output, the share of values that may round to the other
# bfloat16 than the plain version's (a sum taken in another order): B's
# bfloat16 route (on an H100 at most 1 of 16384 on MGCoarse_128), and
# kernel N, whose concat layers take the float32 up half as three
# bfloat16 products (C.5; on an H100 up to 1.1e-3, PUNet3_32's dec0_0).
BF16_OFF_SHARE = 1e-3
N_BF16_OFF_SHARE = 3e-3


def check_b_forward(label, net, x, inv=None):
    """Kernel B on one PUNet forward: each layer on the activations the
    forward hands it within 1e-5 of its largest output (a bfloat16 net:
    within one bfloat16 ulp, check_bf16), the forward within 1e-4 of its
    largest value (bfloat16: BF16_FORWARD_TOL), a repeat bit-equal; device
    and eager ms of the kernel, the plain version's and the cuDNN chain's
    ms (in the net's dtype). Returns (max_abs_err, ms, plain_ms,
    library_ms, bound_ms, bound_by)."""
    from fluidnet_cxx_tpu_torch.ops.kernels import punet

    low = net.compute_dtype == torch.bfloat16
    with torch.no_grad():
        packed = punet.pack_weights(net)

    def run(hook):
        def conv(name, h, x2=None, relu=True, in_scale=None, scale_mod=1):
            w, b = packed[name]
            _, stride, dil = net.geometry[name]
            dt = net.compute_dtype
            return hook(name, (h.to(dt), w, b, stride, dil, relu,
                               None if x2 is None else x2.to(dt), in_scale,
                               scale_mod), {})
        return net(x, inv_scale=inv, conv=conv)

    with torch.no_grad():
        for name, args, _ in record_layers(run, punet.conv2d_nhwc):
            h, w, *rest = args
            want = punet.conv2d_nhwc_plain(h, w.permute(3, 2, 0, 1), *rest)
            got = punet.conv2d_nhwc(*args)
            torch.cuda.synchronize()
            if low:
                check_bf16(f"B {label} layer {name} ({tuple(h.shape)})",
                           got, want)
            else:
                check(f"B {label} layer {name} ({tuple(h.shape)})",
                      max_err([got], [want]), 1e-5 * float(want.abs().max()))
        fwd = lambda: punet.net_forward(net, packed, x, inv_scale=inv)
        got, want = fwd(), net(x, inv_scale=inv)
        torch.cuda.synchronize()
        err = max_err([got], [want])
        check(f"B {label} forward ({err / scale_of([want]):.3e} of its "
              "largest value)", err,
              (BF16_FORWARD_TOL if low else 1e-4) * scale_of([want]))
        check_repeat(f"B {label} forward", fwd)
        ms, eager_ms = device_and_eager(fwd)
        plain_ms = cuda_ms(lambda: net(x, inv_scale=inv), 10)
        library = punet_library(net, x, inv)
        lib_err = max_err([library().permute(0, 2, 3, 1)], [want])
        library_ms = graph_ms(library)
    macs = punet_macs(net, x.shape[1], x.shape[2])
    wbytes = sum(w.numel() * w.element_size() + 4 * b.numel()
                 for w, b in packed.values())
    b_ms, b_by = bound(4 * x.numel() + wbytes + 4 * x[..., 0].numel(),
                       2.0 * macs, BF16_OPS_PER_S if low else TF32X3_OPS_PER_S)
    print(f"B {label}: kernel {ms:.4f} ms device (eager {eager_ms:.4f}), "
          f"plain {plain_ms:.3f} ms, cuDNN chain {library_ms:.4f} ms "
          f"(its error {lib_err:.3e}), bound {b_ms:.4f} ms ({b_by}, "
          f"{'bf16' if low else '3xTF32'}; fp32 CUDA cores "
          f"{1e3 * 2.0 * macs / FP32_OPS_PER_S:.4f} ms), "
          f"{2.0 * macs / 1e9:.3f} GFLOP", flush=True)
    return err, ms, plain_ms, library_ms, b_ms, b_by


def mg_learned_ops(shapes, cut, pre=4, post=4):
    """Operations of one learned V-cycle, per cell of each level it
    touches (mg_ops' counts): the levels above the cut as in a V-cycle,
    the cut level's projection and post-sweeps; 3 per fine cell the
    gauge. The coarse net's own are B's."""
    n = [h * w for h, w in shapes[:cut + 1]]
    per = sum(c * ((pre + post) * 13 + 12 + 3 + 4 + 10) + 2 * 14 * nc
              for c, nc in zip(n[:-1], n[1:]))
    return per + n[-1] * (3 + post * 13) + 3 * n[0]


def learned_inputs(dev):
    """The 512^2 plume scene's flags with 8% random obstacles, the
    divergence of a U of up to 5 cells a step (as stress_inputs) and a
    warm start."""
    from fluidnet_cxx_tpu_torch.celltype import OBSTACLE
    from fluidnet_cxx_tpu_torch.ops.stencils import velocity_divergence
    from fluidnet_cxx_tpu_torch.sim.scenes import create_plume_scene

    gen = torch.Generator().manual_seed(SEED + 7)
    flags = create_plume_scene(RES, RES, 0.1, 8.0, 0.145).flags.clone()
    inner = torch.zeros_like(flags, dtype=torch.bool)
    inner[:, 1:-1, 1:-1] = True
    flags[inner & (torch.rand(flags.shape, generator=gen) < 0.08)] = OBSTACLE
    U = 100.0 * (torch.rand((1, 2, RES, RES), generator=gen) - 0.5)
    p0 = torch.randn((1, RES, RES), generator=gen)
    flags, U = flags.to(dev), U.to(dev)
    return flags, velocity_divergence(U, flags), p0.to(dev)


def phase_mg_learned(dev, results):
    """Kernel G's learned-cut route (fn_mg_learned_down, B's MGCoarseNet,
    fn_mg_learned_up) at 512^2 with the trained MGCoarse_128: G's halves
    against the plain solve_mg(coarse_fn=...) with the float32 net (its
    plain forward), within 1.4e-5 of the largest output, one V-cycle cold
    and two warm, bit-equal on a repeat; the main path's bfloat16 net
    (B's bfloat16 route) against the plain V-cycle with its plain
    bfloat16 forward within BF16_VCYCLE_TOL of the largest pressure; the
    planner against fn_mg_cut_level; the refusal of a cut
    inside the tail; device time split by launch kind, timed on the
    bfloat16 net; B's bfloat16 route on MGCoarseNet's 128^2 input beside
    cuDNN's bfloat16 chain."""
    from fluidnet_cxx_tpu_torch.models.mg_coarse import _cont, make_coarse_fn
    from fluidnet_cxx_tpu_torch.ops.kernels import _build, mg, punet
    from fluidnet_cxx_tpu_torch.ops.multigrid import level_shapes
    from fluidnet_cxx_tpu_torch.ops.multigrid import solve_mg as mg_plain
    from fluidnet_cxx_tpu_torch.run_plume import MG_COARSE_DIR, build_mg_coarse

    done = phase("kernel G's learned cut (G halves + B)")
    for h, w in ((RES, RES), (RT_H, RT_W), (CYL_H, CYL_W), (64, 64),
                 (128, 128), (256, 256), (1024, 1024), (96, 160), (32, 32),
                 (2048, 256)):
        want = _build.query("fn_mg_cut_level", h, w, 8)
        got = mg.tail_first_level(level_shapes(h, w))
        if got != want:
            raise SystemExit(f"plan_learned_cut's tail rule gives {got} at "
                             f"{h}x{w}, fn_mg_cut_level {want}")
    print("the planner's tail rule equals fn_mg_cut_level on 10 shapes",
          flush=True)
    model = build_mg_coarse(None, dev)
    f32_model = build_mg_coarse(None, dev, dtype="float32")
    print(f"G learned: trained weights, {MG_COARSE_DIR.name}, the main "
          f"path's net in {model.punet.compute_dtype}", flush=True)
    f32_fn = make_coarse_fn(f32_model)
    f32_plain = lambda f, r: f32_model(f, r)
    small = torch.ones((1, 64, 64), dtype=torch.int32, device=dev)
    try:
        mg.solve_mg(small, torch.zeros((1, 64, 64), device=dev),
                    n_vcycles=1, coarse_fn=f32_fn, coarse_size=32)
    except ValueError as e:
        print(f"a cut inside the tail raises: {e}", flush=True)
    else:
        raise SystemExit("a learned cut inside the tail did not raise")
    flags, div, p0 = learned_inputs(dev)
    cut = mg.plan_learned_cut(RES, RES)
    shapes = level_shapes(RES, RES)
    print(f"G learned at {RES}^2: cut at level {cut} {shapes[cut]}, the "
          f"tail's first level {mg.tail_first_level(shapes)}", flush=True)
    # The RT box's cut (128x32) is the tail's first level: no tail launch.
    rt = solver_inputs(dev)["RT"]
    cases = {"1 V-cycle cold": (flags, div, dict(n_vcycles=1)),
             "2 V-cycles warm": (flags, div, dict(n_vcycles=2, p0=p0)),
             f"{RT_H}x{RT_W} cold": (rt[0], rt[2], dict(n_vcycles=1))}
    errs = {}
    with torch.no_grad():
        for name, (f, d, kw) in cases.items():
            run = lambda f=f, d=d, kw=kw: mg.solve_mg(
                f, d, coarse_fn=f32_fn, **kw)
            got = run()
            torch.cuda.synchronize()
            want = mg_plain(f, d, coarse_fn=f32_plain, **kw)
            errs[name] = max_err([got], [want])
            check(f"G learned {name}, float32 net", errs[name],
                  1.4e-5 * float(want.abs().max()))
            check(f"G learned {name} (repeat)", max_err([run()], [got]), 0.0)
        coarse_fn = make_coarse_fn(model)
        plain_fn = lambda f, r: model(f, r)
        got = mg.solve_mg(flags, div, n_vcycles=1, coarse_fn=coarse_fn)
        want = mg_plain(flags, div, n_vcycles=1, coarse_fn=plain_fn)
        torch.cuda.synchronize()
        e = max_err([got], [want])
        check(f"G learned 1 V-cycle cold, bfloat16 net "
              f"({e / float(want.abs().max()):.3e} of the largest pressure)",
              e, BF16_VCYCLE_TOL * float(want.abs().max()))
        run = lambda: mg.solve_mg(flags, div, n_vcycles=1,
                                  coarse_fn=coarse_fn)
        launches = launches_of(mg.solve_mg_learned, run)
        b_calls = launches_of(punet.conv2d_nhwc, run)
        ms, eager_ms = device_and_eager(run)
        plain_ms = cuda_ms(lambda: mg_plain(flags, div, n_vcycles=1,
                                            coarse_fn=plain_fn), 5)
        split = device_split(run)
    groups = {"G halves": ("mg_",), "B convs": ("conv",)}
    parts = {g: [0.0, 0.0] for g in list(groups) + ["glue"]}
    for key, (t, n) in split.items():
        g = next((g for g, ks in groups.items()
                  if any(k in key for k in ks)), "glue")
        parts[g][0] += t
        parts[g][1] += n
    print("G learned split: " + ", ".join(
        f"{g} {t:.4f} ms ({n:g} launches)" for g, (t, n) in parts.items()),
        flush=True)
    for key, (t, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        print(f"  {t:9.4f} ms {n:5.1f} launches  {key[:70]}", flush=True)
    n = RES * RES
    macs = punet_macs(model.punet, *shapes[cut])
    # The net's multiply-adds at the bf16 tensor-core rate, counted as
    # operations at the fp32 rate of the levels' stencils.
    b_ms, b_by = bound(12 * n, mg_learned_ops(shapes, cut)
                       + 2.0 * macs * FP32_OPS_PER_S / BF16_OPS_PER_S)
    results["G learned"] = dict(err=max(errs.values()), ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None)
    print(f"G learned ({RES}^2, 1 V-cycle cold): kernel {ms:.4f} ms device "
          f"(eager {eager_ms:.4f}), {launches} G launches and {b_calls} B "
          f"convs a call, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    gen = torch.Generator().manual_seed(SEED + 8)
    hc, wc = shapes[cut]
    rhs = torch.randn((1, hc, wc), generator=gen)
    fc = torch.where(torch.rand((1, hc, wc), generator=gen) < 0.08, 2,
                     1).to(torch.int32)
    fc[:, [0, -1], :] = 2
    fc[:, :, [0, -1]] = 2
    cont = _cont(fc)
    x = torch.stack([rhs * cont, cont], dim=-1).to(dev)
    check_bf16_rounding(dev)
    err, ms, plain_ms, lib_ms, b_ms, b_by = check_b_forward(
        f"MGCoarse_128 (bfloat16) at {hc}x{wc}", model.punet, x)
    results["B mg_coarse"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib_ms)
    done()


def step0_projection_input(model_dir, dev):
    """(p, U, flags, density) that the 512^2 plume's first step hands
    the learned projection of ``model_dir`` (the step's unfused branch,
    captured from a run of that step)."""
    from fluidnet_cxx_tpu_torch.run_plume import plume_case
    from fluidnet_cxx_tpu_torch.sim.step import simulate_step

    cfg, state, project = plume_case(RES, dev, model_dir=model_dir)
    seen = []

    def capture(p, U, flags, density):
        seen.append((p, U, flags, density))
        return project(p, U, flags, density)

    with torch.no_grad():
        simulate_step(cfg, state, capture)
    return seen[0]


def thin_layer_work(net, calls):
    """(operations, bytes) of each recorded conv call of a ConvNet on its
    unpadded channels: 2 a multiply-add; input, weights, bias and output
    read or written once, float32."""
    out = []
    for name, args, _ in calls:
        h = args[0]
        c = net.convs[name]
        co, ci, k, _ = c.weight.shape
        m = h.shape[0] * h.shape[1] * h.shape[2]
        out.append((2.0 * m * co * ci * k * k,
                    4.0 * (m * ci + c.weight.numel() + co + m * co)))
    return out


def cudnn_conv(net):
    """The per-layer hook of a ConvNet as cuDNN F.conv2d calls on the
    unpadded weights, NHWC tensors as channels-last NCHW views (the
    library call of B's thin-channel rows)."""
    def conv(name, h, x2=None, relu=True, in_scale=None, scale_mod=1):
        c = net.convs[name]
        y = torch.nn.functional.conv2d(h.permute(0, 3, 1, 2), c.weight,
                                       c.bias, padding=c.kernel_size[0] // 2)
        return (torch.relu(y) if relu else y).permute(0, 2, 3, 1)
    return conv


def phase_nets(dev, results):
    """Kernel B's thin-channel route: every layer of FluidNetTower
    (DataTrain_128) and MultiScaleNet (ScaleNet_jets_128) at 512^2 on the
    plume's assembled input at step 0, trained weights, each held to its
    plain version on the unpadded weights (F.conv2d, TF32 off) within
    1e-5 of its largest output and its padded output channels exactly 0;
    each forward within 1e-4 of its largest value, a repeat bit-equal;
    device and eager ms beside the plain forward's and the cuDNN chain's,
    launches, the bound on the unpadded work; the per-layer table."""
    from fluidnet_cxx_tpu_torch.config import load_model_config
    from fluidnet_cxx_tpu_torch.models.fluidnet import assemble_inputs
    from fluidnet_cxx_tpu_torch.ops.kernels import punet
    from fluidnet_cxx_tpu_torch.ops.kernels.conv_plan import plan_conv
    from fluidnet_cxx_tpu_torch.run_plume import build_net

    done = phase("kernel B thin-channel layers (FluidNetTower, ScaleNet)")
    for key, model_dir in NETS.items():
        mcfg = load_model_config(model_dir)
        net = build_net(mcfg, None, dev, model_dir)
        with torch.no_grad():
            packed = punet.pack_weights(net)
        with torch.no_grad():
            x = assemble_inputs(mcfg, *step0_projection_input(model_dir,
                                                              dev))[0]
        label = f"{model_dir.split('/')[-1]} at {RES}^2"
        print(f"B {label}: trained weights, {mcfg.model}, input "
              f"{tuple(x.shape)} max|x| {float(x.abs().max()):.4e}",
              flush=True)

        def run(hook):
            def conv(name, h, x2=None, relu=True, in_scale=None,
                     scale_mod=1):
                w, b = packed[name]
                return hook(name, (h, w, b, 1, 1, relu), {})
            return net(x, conv=conv, width=punet.STAGE)

        with torch.no_grad():
            calls = record_layers(run, punet.conv2d_nhwc)
            torch.cuda.synchronize()
            for name, args, _ in calls:
                h, w, b, _, _, relu = args
                c = net.convs[name]
                co, ci = c.weight.shape[:2]
                want = punet.conv2d_nhwc_plain(h[..., :ci], c.weight, c.bias,
                                               relu=relu)
                got = punet.conv2d_nhwc(*args)
                torch.cuda.synchronize()
                if bool(got[..., co:].any()):
                    raise SystemExit(f"B {label} layer {name}: a padded "
                                     "output channel is not 0")
                plan = plan_conv(h.shape[0] * h.shape[1] * h.shape[2],
                                 w.shape[3], w.shape[0] ** 2, h.shape[3], 0,
                                 "tf32x3")
                check(f"B {label} layer {name} {tuple(h.shape[1:3])} "
                      f"k{w.shape[0]} {ci}->{co} (padded {h.shape[3]}->"
                      f"{w.shape[3]}; plan {plan.bm}x{plan.bn}, "
                      f"{plan.splits} splits)", max_err([got[..., :co]],
                                                        [want]),
                      1e-5 * float(want.abs().max()))
            fwd = lambda: punet.net_forward(net, packed, x)
            got, want = fwd(), net(x)
            torch.cuda.synchronize()
            err = max_err([got], [want])
            check(f"B {label} forward", err, 1e-4 * scale_of([want]))
            check_repeat(f"B {label} forward", fwd)
            launches = launches_of(punet.conv2d_nhwc, fwd)
            ms, eager_ms = device_and_eager(fwd)
            plain_ms = cuda_ms(lambda: net(x), 10)
            library = lambda: net(x, conv=cudnn_conv(net))
            lib_err = max_err([library()], [want])
            library_ms, library_eager_ms = device_and_eager(library)
            work = thin_layer_work(net, calls)
            rows = []
            for (name, args, _), (ops, nbytes) in zip(calls, work):
                h, w = args[:2]
                c = net.convs[name]
                co, ci = c.weight.shape[:2]
                plan = plan_conv(h.shape[0] * h.shape[1] * h.shape[2],
                                 w.shape[3], w.shape[0] ** 2, h.shape[3], 0,
                                 "tf32x3")
                hn = h[..., :ci].contiguous()
                lib = lambda hn=hn, name=name: cudnn_conv(net)(name, hn)
                rows.append(dict(
                    name=name.replace("convN_", "N").replace("/Conv_", "."),
                    m=h.shape[0] * h.shape[1] * h.shape[2], co=w.shape[3], k=w.shape[0] ** 2 * h.shape[3],
                    bm=plan.bm, bn=plan.bn, splits=plan.splits,
                    blocks=plan.blocks,
                    ms=graph_ms(lambda args=args: punet.conv2d_nhwc(*args)),
                    lib_ms=graph_ms(lib),
                    bound_ms=bound(nbytes, ops, TF32X3_OPS_PER_S)[0]))
            conv_table(f"B per layer, {label} (padded M, co, K; cuDNN and "
                       "the bound on the unpadded layer, 3xTF32 rate)", rows)
        flops = sum(ops for ops, _ in work)
        wbytes = sum(4 * t.numel() for t in net.state_dict().values())
        b_ms, b_by = bound(4 * x.numel() + wbytes + 4 * x[..., 0].numel(),
                           flops, TF32X3_OPS_PER_S)
        layer_ms, layer_by = bound(sum(nb for _, nb in work), flops,
                                   TF32X3_OPS_PER_S)
        results[key] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=library_ms)
        print(f"B {label}: kernel {ms:.4f} ms device (eager {eager_ms:.4f}),"
              f" {launches} launches, plain {plain_ms:.3f} ms, cuDNN chain "
              f"{library_ms:.4f} ms (eager {library_eager_ms:.4f}; its error "
              f"{lib_err:.3e}), bound {b_ms:.4f} ms ({b_by}, 3xTF32; layer by "
              f"layer {layer_ms:.4f}, {layer_by}), {flops / 1e9:.3f} GFLOP "
              f"unpadded ({flops / x[..., 0].numel() / 1e3:.1f} kFLOP a "
              "cell)", flush=True)
    done()


def phase_cylinder_kernels(dev, results):
    """Kernel H at 8000x800 on the cylinder's flags (2 V-cycles, cold and
    warm, as cylinder_config's multigrid runs them) against its plain
    version, within 1e-4 of each output's largest value and bit-equal on a
    repeat, after fn_mg_workspace and fn_mg_cut_level there; kernel C at
    8000x800 as the unfused convnet step calls it (PUNetD2_128's 32
    damped polish sweeps from a warm start, a scale, no inlet) bit for bit
    against its plain version and on a repeat; kernel B on the 1000x100
    map of PUNetD2_128's forward at 8000x800."""
    from fluidnet_cxx_tpu_torch.config import load_model_config
    from fluidnet_cxx_tpu_torch.ops.kernels import _build, mg, proj_tail
    from fluidnet_cxx_tpu_torch.ops.multigrid import level_shapes
    from fluidnet_cxx_tpu_torch.run_plume import MODEL_DIR, build_net

    gen = torch.Generator().manual_seed(SEED + 9)
    cflags, cU, _ = cylinder_inputs(gen, dev)
    p0 = torch.randn((1, CYL_H, CYL_W), generator=gen).to(dev)
    done = phase(f"kernel H at {CYL_W}x{CYL_H}")
    shapes = level_shapes(CYL_H, CYL_W)
    cut = _build.query("fn_mg_cut_level", CYL_H, CYL_W, 8)
    nbytes = _build.query("fn_mg_workspace", 1, CYL_H, CYL_W, 8, 4, 4, 32, 1)
    print(f"H {CYL_W}x{CYL_H}: levels {shapes}; the tail runs {shapes[cut:]}"
          f"; workspace {nbytes} bytes", flush=True)
    if cut >= len(shapes) or nbytes <= 0:
        raise SystemExit(f"H at {CYL_W}x{CYL_H}: no tail or no workspace")
    errs = {}
    for name, kw in (("cold", dict(n_vcycles=2)),
                     ("warm", dict(n_vcycles=2, p0=p0))):
        run = lambda kw=kw: list(mg.project_mg(cflags, cU, **kw))
        got = run()
        torch.cuda.synchronize()
        want = list(mg.project_mg_plain(cflags, cU, **kw))
        for i, field in enumerate(("p", "U'")):
            check(f"H {CYL_W}x{CYL_H} {name} {field}",
                  max_err(got[i:i + 1], want[i:i + 1]),
                  1e-4 * scale_of(want[i:i + 1]))
        errs[name] = max_err(got, want)
        check(f"H {CYL_W}x{CYL_H} {name} (repeat)", max_err(run(), got), 0.0)
    run = lambda: mg.project_mg(cflags, cU, n_vcycles=2, p0=p0)
    ms, eager_ms = device_and_eager(run)
    launches = launches_of(mg.project_mg, run)
    plain_ms = cuda_ms(lambda: mg.project_mg_plain(cflags, cU, n_vcycles=2,
                                                   p0=p0), 3, warmup=1)
    nc = CYL_W * CYL_H
    b_ms, b_by = bound(28 * nc, mg_ops(shapes, 2) + 12 * nc)
    results["H cylinder"] = dict(err=max(errs.values()), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None)
    print(f"H {CYL_W}x{CYL_H} warm: kernel {ms:.4f} ms device (eager "
          f"{eager_ms:.4f}), {launches} launches, plain {plain_ms:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    print_split(f"H {CYL_W}x{CYL_H} warm", device_split(run))
    done()

    done = phase(f"kernel C at {CYL_W}x{CYL_H}")
    mcfg = load_model_config(str(MODEL_DIR))
    it = mcfg.polish_sweeps
    kw = dict(damping=mcfg.polish_damping,
              scale=torch.tensor([0.37], device=dev))
    run = lambda: list(proj_tail.project_tail(cflags, cU, p0, it, **kw))
    plain = lambda: list(proj_tail.project_tail_plain(cflags, cU, p0, it,
                                                      **kw))
    got = run()
    torch.cuda.synchronize()
    err = max_err(got, plain())
    check(f"C {CYL_W}x{CYL_H} ({it} sweeps, scale, no inlet)", err, 0.0)
    check(f"C {CYL_W}x{CYL_H} (repeat)", max_err(run(), got), 0.0)
    ms, eager_ms = device_and_eager(run)
    launches = launches_of(proj_tail.project_tail, run)
    plain_ms = cuda_ms(plain, 3, warmup=1)
    # flags, U and p0 read, p and U' written: 28 B a cell without inlet.
    b_ms, b_by = bound(28 * nc, (it * 10 + 30) * nc)
    results["C cylinder"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None)
    print(f"C {CYL_W}x{CYL_H}, {it} sweeps: kernel {ms:.4f} ms device "
          f"(eager {eager_ms:.4f}), {launches} launches, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    print_tail_split(device_split(run))
    done()

    done = phase(f"kernel B on the {CYL_W // 8}x{CYL_H // 8} map")
    net = build_net(mcfg, None, dev)
    x = torch.stack([torch.randn((1, CYL_H, CYL_W), generator=gen),
                     (torch.rand((1, CYL_H, CYL_W), generator=gen)
                      < 0.1).float()], dim=-1).to(dev)
    err, ms, plain_ms, lib_ms, b_ms, b_by = check_b_forward(
        f"PUNetD2_128 at {CYL_W}x{CYL_H}", net, x,
        torch.tensor([3.0], device=dev))
    results["B cylinder"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms)
    done()


def phase_f_cylinder(dev):
    """Kernel F at 8000x800 on the cylinder's flags, 34 sweeps, on the
    divergence of the viscous field of adv_inputs' cylinder U."""
    from fluidnet_cxx_tpu_torch.ops.jacobi import solve_jacobi_fixed
    from fluidnet_cxx_tpu_torch.ops.kernels import jacobi
    from fluidnet_cxx_tpu_torch.ops.stencils import velocity_divergence

    cflags, _, corig = cylinder_inputs(
        torch.Generator().manual_seed(SEED + 5), dev)
    nc = CYL_W * CYL_H
    done = phase(f"kernel F at {CYL_W}x{CYL_H}")
    div = velocity_divergence(corig, cflags)
    want = solve_jacobi_fixed(cflags, div, 34)
    check(f"F solve_jacobi ({CYL_W}x{CYL_H} cylinder, 34 sweeps)",
          max_err([jacobi.solve_jacobi(cflags, div, 34)], [want]), 0.0)
    run = lambda: jacobi.solve_jacobi(cflags, div, 34)
    f_ms, f_eager = device_and_eager(run)
    b_ms, b_by = bound(12 * nc, 10.0 * 34 * cont_cells(cflags))
    print(f"F {CYL_W}x{CYL_H}, 34 sweeps: kernel {f_ms:.4f} ms device (eager "
          f"{f_eager:.4f}), "
          f"{launches_of(jacobi.solve_jacobi, run)} launches, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    done()


def cylinder_inputs(gen, dev):
    """The cylinder's own flags and shape, U with up to 5-cell
    displacements at dt 0.1 and its viscous field as orig."""
    from fluidnet_cxx_tpu_torch.ops.source_terms import add_viscosity
    from fluidnet_cxx_tpu_torch.sim.scenes import create_cylinder_scene

    state, nu = create_cylinder_scene(CYL_W, CYL_H, device=dev)
    cU = state.U + 100.0 * (torch.rand(state.U.shape, generator=gen)
                            - 0.5).to(dev)
    return state.flags, cU, add_viscosity(0.1, cU, state.flags, nu)


def adv_inputs(dev):
    """Inputs of kernels A, D and E at the main paths' shapes: the 512^2
    stress inputs (8% obstacles, up to 5-cell displacements at dt 0.1),
    the plume scene's own flags (the border shell alone, as the plume
    paths run them) with the same U and rho, the 128x512 Rayleigh-Taylor
    box with U and rho of the stress kind, and the cylinder's
    (cylinder_inputs)."""
    from fluidnet_cxx_tpu_torch.sim.scenes import (
        create_plume_scene, create_rayleigh_taylor_scene)

    gen = torch.Generator().manual_seed(SEED + 5)
    flags, U, rho = stress_inputs(gen, dev, RES)
    scene = create_plume_scene(RES, RES, 0.1, 8.0, 0.145, device=dev).flags
    rt_flags = create_rayleigh_taylor_scene(RT_W, RT_H, device=dev).flags
    rt_U = (100.0 * (torch.rand((1, 2, RT_H, RT_W), generator=gen)
                     - 0.5)).to(dev)
    rt_rho = torch.rand((1, RT_H, RT_W), generator=gen).to(dev)
    return dict(stress=(flags, U, rho), scene=(scene, U, rho),
                RT=(rt_flags, rt_U, rt_rho),
                cylinder=cylinder_inputs(gen, dev))


def adv_cases(inputs):
    """name -> (kernel call, plain call, the wrapper that counts its
    launches, flags, bytes a cell, operations a cell, traced) of A, D and
    E at max_disp 4, dt 0.1, MacCormack 0.6: A and D with the trace on the
    stress, the plume scene's and the RT flags, E on the cylinder with its
    viscous orig and on the 512^2 stress flags without one."""
    from fluidnet_cxx_tpu_torch.ops import advection
    from fluidnet_cxx_tpu_torch.ops.kernels import advect

    D, cases = 4, {}
    for where in ("stress", "scene", "RT"):
        f, U, rho = inputs[where]
        args = (0.1, rho, U, f, 0.6, False, D, True)
        cases[f"A {where}"] = (
            lambda a=args: list(advect.advect_all(*a)),
            lambda a=args: list(advect.advect_all_plain(*a)),
            advect.advect_all, f, 28, 300.0, True)
    for where in ("stress", "scene", "RT"):
        f, U, rho = inputs[where]
        cases[f"D {where}"] = (
            lambda a=(0.1, rho, U, f, 0.6, False, D, True):
                [advect.advect_scalar(*a)],
            lambda a=(0.1, rho, U, f, False, 0.6, True, D):
                [advection.advect_scalar(*a)],
            advect.advect_scalar, f, 20, 150.0, True)
    f, U, rho = inputs["stress"]
    cf, cU, corig = inputs["cylinder"]
    cases["E cylinder"] = (
        lambda: [advect.advect_velocity(0.1, cU, cf, 0.6, D, orig=corig)],
        lambda: [advection.advect_velocity(0.1, corig, cU, cf, 0.6, D)],
        advect.advect_velocity, cf, 28, 150.0, False)
    cases[f"E {RES}^2"] = (
        lambda: [advect.advect_velocity(0.1, U, f, 0.6, D)],
        lambda: [advection.advect_velocity(0.1, U, U, f, 0.6, D)],
        advect.advect_velocity, f, 20, 150.0, False)
    return cases


def check_adv_branches(inputs):
    """The branches and max_disp values the main paths do not take, each
    bit for bit: A with the trace off and sample_outside on, A and E with
    an orig far from U, A at max_disp 1-4 with the trace on and off
    (512^2 stress inputs: displacements past each clamp), E on the
    cylinder at max_disp 1-4; D with the trace off and sample_outside on,
    with the trace off on the stress, scene and RT flags, and at max_disp
    1-4 and its built limit with the trace on and off; then one call each
    of E and D past that limit, which must raise."""
    from fluidnet_cxx_tpu_torch.ops import advection
    from fluidnet_cxx_tpu_torch.ops.kernels import _build, advect

    f, U, rho = inputs["stress"]
    orig = far_orig(torch.Generator().manual_seed(SEED + 6), U)
    other = (0.1, rho, U, f, 0.6, True, 4, False)
    check("A advect_all (trace off, sample outside)",
          max_err(advect.advect_all(*other),
                  advect.advect_all_plain(*other)), 0.0)
    args = (0.1, rho, U, f, 0.6, False, 4, True)
    check("A advect_all (orig far from U)",
          max_err(advect.advect_all(*args, orig=orig),
                  advect.advect_all_plain(*args, orig=orig)), 0.0)
    check("E advect_velocity (orig far from U)",
          max_err([advect.advect_velocity(0.1, U, f, 0.6, 4, orig=orig)],
                  [advection.advect_velocity(0.1, orig, U, f, 0.6, 4)]), 0.0)
    check("D advect_scalar (trace off, sample outside)",
          max_err([advect.advect_scalar(0.1, rho, U, f, 0.6, True, 4,
                                        False)],
                  [advection.advect_scalar(0.1, rho, U, f, True, 0.6, False,
                                           4)]), 0.0)
    for where in ("stress", "scene", "RT"):
        fw, Uw, rw = inputs[where]
        check(f"D advect_scalar ({where}, trace off)",
              max_err([advect.advect_scalar(0.1, rw, Uw, fw, 0.6, False, 4,
                                            False)],
                      [advection.advect_scalar(0.1, rw, Uw, fw, False, 0.6,
                                               False, 4)]), 0.0)
    most = _build.constant("fn_advect_max_disp")
    # D is held to E's built limit (a checkout from before the limit takes
    # any max_disp).
    d_most = hasattr(advect, "_check_max_disp")
    for D in (1, 2, 3, 4) + ((most,) if d_most else ()):
        for trace in (True, False):
            a = (0.1, rho, U, f, 0.6, False, D, trace)
            on = "on" if trace else "off"
            if D <= 4:
                check(f"A advect_all (max_disp {D}, trace {on})",
                      max_err(advect.advect_all(*a),
                              advect.advect_all_plain(*a)), 0.0)
            check(f"D advect_scalar (max_disp {D}, trace {on})",
                  max_err([advect.advect_scalar(*a)],
                          [advection.advect_scalar(0.1, rho, U, f, False, 0.6,
                                                   trace, D)]), 0.0)
    cf, cU, corig = inputs["cylinder"]
    for D in (1, 2, 3, 4):
        got = advect.advect_velocity(0.1, cU, cf, 0.6, D, orig=corig)
        torch.cuda.synchronize()
        check(f"E advect_velocity ({CYL_W}x{CYL_H} cylinder, orig, "
              f"max_disp {D})",
              max_err([got], [advection.advect_velocity(0.1, corig, cU, cf,
                                                        0.6, D)]), 0.0)
    past = [("E", lambda: advect.advect_velocity(0.1, U, f, 0.6, most + 1))]
    if d_most:
        past.append(("D", lambda: advect.advect_scalar(0.1, rho, U, f, 0.6,
                                                       False, most + 1)))
    for k, fn in past:
        try:
            fn()
        except ValueError as e:
            print(f"{k} at max_disp {most + 1} raises: {e}", flush=True)
        else:
            raise SystemExit(f"{k} ran past its built max_disp {most}")


def phase_advection(dev, results):
    """Kernels A, D and E against their plain versions (bit for bit) on
    every case of adv_cases and check_adv_branches, then timed: device
    time (CUDA graph) with the eager time and Step 0 beside it, launches
    a call, the plain version's time and the bounds (advect_ops's, and
    one that counts only the blocked cells of the pruned boxes), with how
    the pruned trace walks on each flag set (walk_stats)."""
    from fluidnet_cxx_tpu_torch.ops.advection import get_centered
    from fluidnet_cxx_tpu_torch.ops.common import border_mask, where0

    inputs = adv_inputs(dev)
    cases = adv_cases(inputs)
    done = phase("kernels A, D, E against their plain versions")
    errs = {}
    for name, (run, plain, *_) in cases.items():
        got = run()
        torch.cuda.synchronize()
        errs[name] = max_err(got, plain())
        check(name, errs[name], 0.0)
    check_adv_branches(inputs)
    done()

    done = phase("kernels A, D, E timed")
    times = adv_times(cases)
    for name, (run, plain, counter, f, nbytes, per_cell, trace) in \
            cases.items():
        n = f.numel()
        b_ms, b_by = bound(nbytes * n, advect_ops(f, 4, per_cell, trace))
        line = f"{b_ms:.4f} ({b_by})"
        if trace:
            h, w = f.shape[1:]
            U = next(v[1] for v in inputs.values() if v[0] is f)
            cc = where0(~border_mask(h, w, 1, f.device)[None, None],
                        get_centered(U))
            st = walk_stats(f, cc, 4, 0.1)
            box_ms, box_by = bound(nbytes * n, per_cell * n
                                   + 20.0 * st["tested"])
            line += (f"; pruned box {box_ms:.4f} ({box_by}); trace walk: "
                     f"{st['rays']} rays, {st['walked']:.4f} walked, "
                     f"{st['offsets']:.3f} offsets a ray (window "
                     f"{(2 * 4 + 1) ** 2 - 1}), "
                     f"{st['tested'] / st['rays']:.3f} blocked cells "
                     "tested a ray")
        plain_ms = cuda_ms(plain, 2, warmup=1)
        ms = times[name][0]
        print(f"{name}: {launches_of(counter, run)} launches a call, plain "
              f"{plain_ms:.3f} ms, bound {line}", flush=True)
        key = {"A stress": "A", "D stress": "D", "E cylinder": "E"}.get(name)
        if key:
            results[key] = dict(err=errs[name], ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None)
    done()


def adv_times(cases):
    """(device, eager) ms of every case of adv_cases, each printed beside
    Step 0, and the STEP0_MS literal of this run."""
    times = {name: device_and_eager(c[0]) for name, c in cases.items()}
    for name, (ms, eager) in times.items():
        print_step0(name, ms, eager)
    print("STEP0_MS 2-D advection = " + repr(
        {k: (round(d, 4), round(e, 4)) for k, (d, e) in times.items()}),
        flush=True)
    return times


def d_split(inputs):
    """D's device time split into its forward and backward launches on the
    stress, scene and RT flags with the trace on and off."""
    from fluidnet_cxx_tpu_torch.ops.kernels import advect

    for where in ("stress", "scene", "RT"):
        f, U, rho = inputs[where]
        for trace in (True, False):
            run = lambda: advect.advect_scalar(0.1, rho, U, f, 0.6, False, 4,
                                               trace)
            parts = {"forward": 0.0, "backward": 0.0}
            for key, (ms, _) in device_split(run).items():
                bwd = "backward" in key
                parts["backward" if bwd else "forward"] += ms
            print(f"D {where} trace {'on' if trace else 'off'}: device "
                  f"{graph_ms(run):.4f} ms, forward {parts['forward']:.4f}, "
                  f"backward {parts['backward']:.4f}", flush=True)


def check_rounding(name, got, want, exact):
    """Hold the kernel's distance from ``exact`` (the plain version run in
    float64) to twice the plain float32 version's own distance from it: a
    kernel that only sums in another order is as close to the exact
    arithmetic as the plain version."""
    e_kernel, e_plain = max_err(got, exact), max_err(want, exact)
    print(f"{name}: kernel vs float64 {e_kernel:.3e}, plain float32 vs "
          f"float64 {e_plain:.3e}", flush=True)
    if not e_kernel <= 2.0 * e_plain:
        raise SystemExit(f"{name}: the kernel is further from float64 than "
                         "float32 rounding explains")


def mg_ops(shapes, n_vcycles, pre=4, post=4, coarse=32):
    """Operations of n_vcycles V-cycles over these levels, per cell of each
    level: 13 a damped sweep, 12 the residual, 3 the compatibility
    projection, 4 the fold and child sum, 10 the prolongation and add; 14
    an extension pass on each coarse level; 3 per fine cell the gauge."""
    n = [h * w for h, w in shapes]
    per = sum(c * ((pre + post) * 13 + 12 + 3 + 4 + 10) + 2 * 14 * nc
              for c, nc in zip(n[:-1], n[1:]))
    per += n[-1] * (coarse * 13 + 3)
    return n_vcycles * per + 3 * n[0]


def solver_inputs(dev):
    """The 512^2 stress flags (8% obstacles), U, its divergence and a warm
    start, and the same four on the 512x128 Rayleigh-Taylor box."""
    from fluidnet_cxx_tpu_torch.ops.stencils import velocity_divergence
    from fluidnet_cxx_tpu_torch.sim.scenes import create_rayleigh_taylor_scene

    gen = torch.Generator().manual_seed(SEED + 1)
    flags, U, _ = stress_inputs(gen, dev, RES)
    p0 = torch.randn((1, RES, RES), generator=gen).to(dev)
    rt_flags = create_rayleigh_taylor_scene(RT_W, RT_H, device=dev).flags
    rt_U = (2.0 * torch.randn((1, 2, RT_H, RT_W), generator=gen)).to(dev)
    rt_p0 = torch.randn((1, RT_H, RT_W), generator=gen).to(dev)
    return {f"{RES}^2": (flags, U, velocity_divergence(U, flags), p0),
            "RT": (rt_flags, rt_U, velocity_divergence(rt_U, rt_flags),
                   rt_p0)}


def mg_cases(inputs):
    """name -> (kernel call, plain call) of G and H, 2 V-cycles cold and
    warm, at 512^2 with obstacles and on the 512x128 box."""
    from fluidnet_cxx_tpu_torch.ops.kernels import mg
    from fluidnet_cxx_tpu_torch.ops.multigrid import solve_mg as mg_plain

    cases = {}
    for where, (flags, U, div, p0) in inputs.items():
        for start, kw in (("cold", dict(n_vcycles=2)),
                          ("warm", dict(n_vcycles=2, p0=p0))):
            cases[f"G {where} {start}"] = (
                lambda f=flags, d=div, kw=kw: [mg.solve_mg(f, d, **kw)],
                lambda f=flags, d=div, kw=kw: [mg_plain(f, d, **kw)])
            cases[f"H {where} {start}"] = (
                lambda f=flags, u=U, kw=kw: list(mg.project_mg(f, u, **kw)),
                lambda f=flags, u=U, kw=kw: list(mg.project_mg_plain(f, u,
                                                                     **kw)))
    return cases


def mg_times(inputs):
    """Device and eager ms of every case of mg_cases (the Step 0
    measurement: run it on any version of the package)."""
    return {name: device_and_eager(run)
            for name, (run, _) in mg_cases(inputs).items()}


def dev_us(e):
    return getattr(e, "self_device_time_total", 0.0) or 0.0


def device_split(fn, reps=5):
    """{kernel name: (device ms, launches)} per call of ``fn`` under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (dev_us(e) / 1e3 / reps, e.count / reps)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0}


def print_split(name, split):
    """G's or H's device time split into the single-block tail, the
    per-level down and up launches and the rest (set-up, epilogue)."""
    groups = {"tail": ("mg_tail",), "down": ("mg_down",), "up": ("mg_up",)}
    parts = {g: [0.0, 0.0] for g in list(groups) + ["rest"]}
    for key, (ms, n) in split.items():
        g = next((g for g, ks in groups.items()
                  if any(k in key for k in ks)), "rest")
        parts[g][0] += ms
        parts[g][1] += n
    print(f"{name} split: " + ", ".join(
        f"{g} {ms:.4f} ms ({n:g} launches)" for g, (ms, n) in parts.items()),
        flush=True)
    for key, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.4f} ms {n:5.1f} launches  {key[:70]}", flush=True)


def phase_solvers(dev, results):
    """Kernel F at the main paths' shapes."""
    from fluidnet_cxx_tpu_torch.ops.jacobi import solve_jacobi_fixed
    from fluidnet_cxx_tpu_torch.ops.kernels import jacobi

    inputs = solver_inputs(dev)
    flags, _, div, p0 = inputs[f"{RES}^2"]
    rt_flags, _, rt_div, _ = inputs["RT"]
    n, n_rt = RES * RES, RT_H * RT_W

    done = phase("kernel F solve_jacobi")
    it = 200
    got = jacobi.solve_jacobi(flags, div, it)
    torch.cuda.synchronize()
    want = solve_jacobi_fixed(flags, div, it)
    # Same float32 operations in the same order as the plain sweep (built
    # with -fmad=false): held bit for bit.
    err = max_err([got], [want])
    check(f"F solve_jacobi ({RES}^2, {it} sweeps)", err, 0.0)
    want2 = solve_jacobi_fixed(flags, div, 13, p0=p0, damping=2.0 / 3.0)
    check("F solve_jacobi (warm, 13 damped sweeps)",
          max_err([jacobi.solve_jacobi(flags, div, 13, p0=p0,
                                       damping=2.0 / 3.0)], [want2]), 0.0)
    want3 = solve_jacobi_fixed(rt_flags, rt_div, it)
    check(f"F solve_jacobi ({RT_H}x{RT_W}, {it} sweeps)",
          max_err([jacobi.solve_jacobi(rt_flags, rt_div, it)], [want3]), 0.0)
    run = lambda: jacobi.solve_jacobi(flags, div, it)
    ms, eager_ms = device_and_eager(run)
    plain_ms = cuda_ms(lambda: solve_jacobi_fixed(flags, div, it), 3,
                       warmup=1)
    b_ms, b_by = bound(12 * n, 10.0 * it * cont_cells(flags))
    results["F"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
    print(f"F: kernel {ms:.4f} ms device (eager {eager_ms:.4f}), "
          f"{launches_of(jacobi.solve_jacobi, run)} "
          f"launches, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    run = lambda: jacobi.solve_jacobi(rt_flags, rt_div, it)
    rt_ms, rt_eager = device_and_eager(run)
    rt_b, rt_by = bound(12 * n_rt, 10.0 * it * cont_cells(rt_flags))
    print(f"F {RT_H}x{RT_W}, {it} sweeps: kernel {rt_ms:.4f} ms device "
          f"(eager {rt_eager:.4f}), "
          f"{launches_of(jacobi.solve_jacobi, run)} launches, bound "
          f"{rt_b:.4f} ms ({rt_by})", flush=True)
    done()


def phase_mg(dev, results):
    """Kernels G and H: every case of mg_cases against its plain version
    (1e-4 of each output's largest value: the compatibility projections,
    the gauge and the partial sums add in another order than PyTorch's
    reductions) and bit-equal on a repeat; at 512^2 (|p| ~3.8e3, where
    the float32 plain version is itself ~1e-1 from its float64 run) also
    against the plain version's float64 run. Then device and eager time
    beside Step 0's (the parent kernels), launches a call and the split
    of device time by launch kind."""
    from fluidnet_cxx_tpu_torch.ops.kernels import _build, mg
    from fluidnet_cxx_tpu_torch.ops.multigrid import level_shapes

    inputs = solver_inputs(dev)
    cases = mg_cases(inputs)
    done = phase("kernels G solve_mg and H project_mg")
    errs = {}
    for name, (run, plain) in cases.items():
        got, want = run(), plain()
        fields = ("p", "U'")[:len(got)]
        for i, field in enumerate(fields):
            check(f"{name} {field}", max_err(got[i:i + 1], want[i:i + 1]),
                  1e-4 * scale_of(want[i:i + 1]))
        errs[name] = max_err(got, want)
        check(f"{name} (repeat)", max_err(run(), got), 0.0)
        if f"{RES}^2" in name:
            flags, U, div, p0 = inputs[f"{RES}^2"]
            warm = {"p0": p0.double()} if "warm" in name else {}
            exact = (mg.project_mg_plain(flags, U.double(), n_vcycles=2,
                                         **warm) if name[0] == "H" else
                     [mg.solve_mg_plain(flags, div.double(), n_vcycles=2,
                                        **warm)])
            for i, field in enumerate(fields):
                check_rounding(f"{name} {field}", got[i:i + 1],
                               want[i:i + 1], exact[i:i + 1])
    done()

    done = phase("kernels G and H timed")
    times = mg_times(inputs)
    counters = {"G": mg.solve_mg, "H": mg.project_mg}
    for name, (ms, eager) in times.items():
        step0 = STEP0_MS[name]
        print(f"{name}: kernel {ms:.4f} ms device (eager {eager:.4f}); Step 0 "
              f"{step0[0]:.4f} (eager {step0[1]:.4f}); "
              f"{launches_of(counters[name[0]], cases[name][0])} launches",
              flush=True)
    for name, (h, w) in (("G RT warm", (RT_H, RT_W)),
                         (f"H {RES}^2 warm", (RES, RES))):
        cut = _build.query("fn_mg_cut_level", h, w, 8)
        print(f"{name}: the single-block tail runs levels "
              f"{level_shapes(h, w)[cut:]}", flush=True)
        print_split(name, device_split(cases[name][0]))
    n, n_rt = RES * RES, RT_H * RT_W
    # G's main path is the periodic RT box, H's the 512^2 plume.
    for k, name, nbytes, nops in (
            ("G", "G RT warm", 16 * n_rt, mg_ops(level_shapes(RT_H, RT_W), 2)),
            ("H", f"H {RES}^2 warm", 28 * n,
             mg_ops(level_shapes(RES, RES), 2) + 12 * n)):
        plain_ms = cuda_ms(cases[name][1], 3, warmup=1)
        b_ms, b_by = bound(nbytes, nops)
        results[k] = dict(err=errs[name], ms=times[name][0],
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=None)
        print(f"{k} ({name}): plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
    done()


# The width-sharded V-cycle's slab entries (csrc/mg.cu, ROADMAP A.8.1):
# the result key, the kernel row's name and the TPU kernel the path's
# V-cycle stands for (H for the per-level launches, G for the tail).
SLAB_ROWS = (("Gs setup", "mg_slab_setup", "Gs", "H"),
             ("Gs down", "mg_slab_down", "Gd", "H"),
             ("Gs up", "mg_slab_up", "Gu", "H"),
             ("Gs epilogue", "mg_slab_epilogue", "Ge", "H"),
             ("Gs tail", "mg_tail_solve", "Gt", "G"))
# Each slab entry against its plain version on the same inputs, as a
# share of the output's largest value: the per-cell operators keep the
# plain float32 order; the child sums, the partial sums and the tail's
# means add in another order.
SLAB_TOL = 1e-5


def slab_counters():
    """{key: wrapper} of the slab entries' launch counters."""
    from fluidnet_cxx_tpu_torch.ops.kernels import mg

    return {"Gs": mg.slab, "Gd": mg.slab_down, "Gu": mg.slab_up,
            "Ge": mg.slab_epilogue, "Gt": mg.tail_solve}


def phase_slab_kernels(dev, results):
    """The width-sharded V-cycle's new entries of csrc/mg.cu, each on a
    slab of the 8000x800 cylinder's flags as rank 0 of sx = 2 holds it
    (level 0: columns -16 .. 4015 taken around the grid; level 1 under it:
    -8 .. 2007; the tail on the 25x250 gathered level), against its plain
    version (ops/multigrid.py) on the same inputs on the card; device ms
    of each beside the plain version's and its bound."""
    from fluidnet_cxx_tpu_torch.ops import multigrid as mgp
    from fluidnet_cxx_tpu_torch.ops.kernels import mg
    from fluidnet_cxx_tpu_torch.ops.multigrid import level_shapes
    from fluidnet_cxx_tpu_torch.run_cylinder import cylinder_case

    done = phase("slab entries of the sharded V-cycle (A.8.1)")
    _, state, _ = cylinder_case(CYL_W, CYL_H, dev)
    flags = state.flags
    gen = torch.Generator().manual_seed(SEED + 9)
    h, W = CYL_H, CYL_W
    rhs = torch.randn((1, h, W), generator=gen).to(dev)
    p = torch.randn((1, h, W), generator=gen).to(dev)
    e = torch.randn((1, h // 2, W // 2), generator=gen).to(dev)
    U = torch.randn((1, 2, h, W), generator=gen).to(dev)
    x0, halo, wl = -16, 16, W // 2
    cols = torch.remainder(torch.arange(x0, x0 + wl + 2 * halo), W).to(dev)
    ccols = torch.remainder(torch.arange(x0 // 2, x0 // 2 + wl // 2 + halo),
                            W // 2).to(dev)
    sl = lambda t: t.index_select(-1, cols).contiguous()  # noqa: E731
    fs, rs, ps = sl(flags), sl(rhs), sl(p)
    cf = mgp._coarsen_flags(flags)
    cfs = cf.index_select(-1, ccols).contiguous()
    es = e.index_select(-1, ccols).contiguous()
    s = mg.slab(fs, x0, W)
    s_c = mg.slab(cfs, x0 // 2, W // 2)
    lo, hi = halo, halo + wl
    sums = mg.slab_sums(s, rs, lo, hi)
    n = h * wl
    shapes = level_shapes(h, W)
    tail_lvl = mg.tail_first_level(shapes)
    th, tw = shapes[tail_lvl]
    tail_flags = flags
    for _ in range(tail_lvl):
        tail_flags = mgp._coarsen_flags(tail_flags)
    tail_rhs = torch.randn((1, th, tw), generator=gen).to(dev)
    cases = {
        "Gs setup": (lambda: [mg.slab_coarsen(s).flags.float(),
                              mg.slab_sums(s, rs, lo, hi)],
                     lambda: [mgp.slab_coarsen(fs, x0, W).float(),
                              mgp.slab_sums(rs, fs, x0, W, lo, hi)],
                     5 * n, 20 * n),
        "Gs down": (lambda: list(mg.slab_down(s, s_c, ps, rs, sums, 4, lo,
                                              hi, True)),
                    lambda: list(mgp.slab_down(fs, x0, W, ps, rs, sums, 4,
                                               lo, hi, True)),
                    14 * n, (4 * 13 + 12 + 3 + 4) * n),
        "Gs up": (lambda: [mg.slab_up(s, s_c, ps, rs, sums, es, 4, lo, hi)],
                  lambda: [mgp.slab_up(fs, x0, W, cfs, x0 // 2, ps, rs,
                                       sums, es, 4, lo, hi)],
                  14 * n, (4 * 13 + 3 + 10) * n + 2 * 14 * n // 4),
        "Gs epilogue": (lambda: list(mg.slab_epilogue(
            mg.Slab(fs, x0, W), ps, sums, lo, hi, sl(U))),
                        lambda: list(mgp.slab_epilogue(fs, x0, W, ps, sums,
                                                       lo, hi, sl(U))),
                        28 * n, 20 * n),
        "Gs tail": (lambda: [mg.tail_solve(tail_flags, tail_rhs)],
                    lambda: [mgp.tail_solve(tail_flags, tail_rhs)],
                    12 * th * tw, mg_ops(shapes[tail_lvl:], 1)),
    }
    # A Slab of CUDA tensors made by hand, without its mask bytes, still
    # launches the kernels (the wrapper makes the mask): one mask launch
    # for each of the two slabs and one down launch, bit-equal to the
    # masked slabs' result.
    before = (mg.slab.launches, mg.slab_down.launches)
    bare = mg.slab_down(mg.Slab(fs, x0, W), mg.Slab(cfs, x0 // 2, W // 2),
                        ps, rs, sums, 4, lo, hi, True)
    counted = (mg.slab.launches - before[0], mg.slab_down.launches
               - before[1])
    if counted != (2, 1):
        raise SystemExit(f"Gs down from a Slab without its mask launched "
                         f"(mask, down) {counted}, not (2, 1)")
    check("Gs down from a Slab without its mask (against the masked)",
          max_err(list(bare), list(mg.slab_down(s, s_c, ps, rs, sums, 4,
                                                lo, hi, True))), 0.0)
    for key, (run, plain, nbytes, nops) in cases.items():
        got, want = run(), plain()
        err = max_err(got, want)
        rel = max(max_err([g], [w_]) / scale_of([w_])
                  for g, w_ in zip(got, want))
        check(f"{key} against its plain version ({rel:.3e} of its largest "
              "value)", rel, SLAB_TOL)
        check(f"{key} (repeat)", max_err(run(), got), 0.0)
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 5, warmup=1)
        b_ms, b_by = bound(nbytes, nops)
        results[key] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None)
        print(f"{key}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), max |kernel - plain| {err:.3e}",
              flush=True)
    print(f"Gs tail: the gathered level {shapes[tail_lvl]} of {h}x{W} "
          f"(levels {shapes[tail_lvl:]})", flush=True)
    done()


def stress_inputs3(gen, dev, res):
    """128^3 inputs that exercise every branch of the 3-D kernels: the
    border shell plus 8% random obstacles, velocities up to 3 cells a step
    at dt 0.25 (past the 3-D window clamp of 2)."""
    from fluidnet_cxx_tpu_torch.celltype import OBSTACLE
    from fluidnet_cxx_tpu_torch.ops.ops3d import empty_domain3

    flags = empty_domain3(1, res, res, res)
    flags[torch.rand(flags.shape, generator=gen) < 0.08] = OBSTACLE
    U = 24.0 * (torch.rand((1, 3, res, res, res), generator=gen) - 0.5)
    rho = torch.rand((1, res, res, res), generator=gen)
    return flags.to(dev), U.to(dev), rho.to(dev)


def advect3_ops(flags, D, per_cell, trace):
    """Operations of one 3-D advection call on these flags: ``per_cell``
    (~150 for the scalar half, ~140 for each velocity component: window
    clamps, two trilinear samples, correction, clamp) plus, with the
    trace, three slab tests (~30 operations) per blocked cell in each
    fluid cell's (2D+1)^3 window, for the forward and the backward
    trace."""
    ops = per_cell * flags.numel()
    if not trace:
        return ops
    blocked = (flags != 1).float()[:, None]
    k = 2 * D + 1
    in_window = torch.nn.functional.conv3d(
        blocked, torch.ones((1, 1, k, k, k), device=flags.device), padding=D)
    fluid = (flags == 1)[:, None]
    return ops + 2 * 30.0 * float(in_window[fluid].sum())


def cases3d(dev):
    """name -> (kernel call, plain call) of the 3-D cases timed beside
    Step 0, at 128^3: J with 16 and 8 warm sweeps damped 2/3 on J's stress
    inputs (seed SEED + 4, as phase_learned3d), M on the stress and the
    scene's flags, K without the trace and L with it on the stress flags
    (seed SEED + 3, as phase_kernels3d)."""
    from fluidnet_cxx_tpu_torch.ops import ops3d
    from fluidnet_cxx_tpu_torch.ops.kernels import advect3, proj_tail3

    gen = torch.Generator().manual_seed(SEED + 3)
    flags, U, rho = stress_inputs3(gen, dev, RES3)
    scene = ops3d.empty_domain3(1, RES3, RES3, RES3, device=dev)
    gen = torch.Generator().manual_seed(SEED + 4)
    j_flags, j_U, _ = stress_inputs3(gen, dev, RES3)
    p0 = torch.randn(j_flags.shape, generator=gen).to(dev)
    D, dt = 2, 0.25
    cases = {}
    for it in (16, 8):
        cases[f"J {it} warm"] = (
            lambda it=it: proj_tail3.project_tail3(j_flags, j_U, p0, it,
                                                   2.0 / 3.0),
            lambda it=it: proj_tail3.project_tail3_plain(j_flags, j_U, p0,
                                                         it, 2.0 / 3.0))
    for name, f in (("stress", flags), ("scene", scene)):
        cases[f"M {name}"] = (
            lambda f=f: [advect3.advect_velocity3(dt, U, f, 0.6, D)],
            lambda f=f: [ops3d.advect_velocity3(dt, U, f, 0.6, max_disp=D)])
    cases["K stress"] = (
        lambda: [advect3.advect_scalar3(dt, rho, U, flags, 0.6, D, False)],
        lambda: [ops3d.advect_scalar3(dt, rho, U, flags, 0.6, max_disp=D)])
    cases["L stress trace"] = (
        lambda: list(advect3.advect_all3(dt, rho, U, flags, 0.6, D, True)),
        lambda: list(advect3.advect_all3_plain(dt, rho, U, flags, 0.6, D,
                                               True)))
    return cases


def print_step0(name, ms, eager):
    step0 = STEP0_MS.get(name)
    before = (f"; Step 0 {step0[0]:.4f} (eager {step0[1]:.4f})" if step0
              else "")
    print(f"{name}: kernel {ms:.4f} ms device (eager {eager:.4f}){before}",
          flush=True)


def phase_kernels3d(dev, results):
    """Kernels I, K, L and M at 128^3 on the 3-D stress inputs, and K, L
    and M also on the plume scene's flags (the border shell alone) with
    the stress U. All four run their plain versions' float32 operations in
    the same order (-fmad=false), so they are expected to be bit-exact;
    the tolerances are those of A and F. K and L are timed with the trace
    on and off on both flag sets, beside their bounds (advect3_ops's, and
    one that counts only the blocked cells of the pruned boxes), with how
    the pruned trace walks there (walk_stats)."""
    from fluidnet_cxx_tpu_torch.ops import ops3d
    from fluidnet_cxx_tpu_torch.ops.kernels import advect3, jacobi3

    gen = torch.Generator().manual_seed(SEED + 3)
    flags, U, rho = stress_inputs3(gen, dev, RES3)
    n, D, dt = RES3 ** 3, 2, 0.25
    p0 = torch.randn(flags.shape, generator=gen).to(dev)
    div = ops3d.velocity_divergence3(U, flags)
    per_scalar, per_component = 150.0, 140.0

    done = phase("kernel I solve_jacobi3")
    it = 60
    got = jacobi3.solve_jacobi3(flags, div, it)
    torch.cuda.synchronize()
    want = ops3d.solve_jacobi_fixed3(flags, div, it)
    err = max_err([got], [want])
    check(f"I solve_jacobi3 ({RES3}^3, {it} sweeps)", err, 0.0)
    kw = dict(p0=p0, damping=6.0 / 7.0)
    want2 = ops3d.solve_jacobi_fixed3(flags, div, 13, **kw)
    check("I solve_jacobi3 (warm, 13 sweeps damped 6/7)",
          max_err([jacobi3.solve_jacobi3(flags, div, 13, **kw)], [want2]),
          0.0)
    run = lambda: jacobi3.solve_jacobi3(flags, div, it)
    ms, eager_ms = device_and_eager(run)
    plain_ms = cuda_ms(lambda: ops3d.solve_jacobi_fixed3(flags, div, it), 3,
                       warmup=1)
    cont = float(ops3d.jacobi3_masks(flags)[0].sum())
    b_ms, b_by = bound(12 * n, 14.0 * it * cont)
    results["I"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
    print(f"I: kernel {ms:.4f} ms device (eager {eager_ms:.4f}), "
          f"{launches_of(jacobi3.solve_jacobi3, run)} "
          f"launches, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})",
          flush=True)
    done()

    def scalar_plain(trace, f=flags):
        return ops3d.advect_scalar3(dt, rho, U, f, 0.6, max_disp=D,
                                    line_trace=trace)

    def velocity_plain(f=flags):
        return ops3d.advect_velocity3(dt, U, f, 0.6, max_disp=D)

    def scalar(trace, f=flags):
        return advect3.advect_scalar3(dt, rho, U, f, 0.6, D, trace)

    def velocity(f=flags):
        return advect3.advect_velocity3(dt, U, f, 0.6, D)

    def merged(trace, f=flags):
        return advect3.advect_all3(dt, rho, U, f, 0.6, D, trace)

    def check_klm(label, f):
        """K and L with the trace on and off, and M, against their plain
        versions on flags ``f``, and L against K and M; returns K's error
        without the trace and L's with it (the main paths' settings)."""
        errs = {}
        for trace in (True, False):
            on = "on" if trace else "off"
            got = scalar(trace, f)
            torch.cuda.synchronize()
            want = scalar_plain(trace, f)
            errs["K", trace] = max_err([got], [want])
            check(f"K advect_scalar3 ({label}, trace {on})", errs["K", trace],
                  1e-4 * scale_of([want]))
            got = merged(trace, f)
            torch.cuda.synchronize()
            want = (scalar_plain(trace, f), velocity_plain(f))
            errs["L", trace] = max_err(got, want)
            check(f"L advect_all3 ({label}, trace {on})", errs["L", trace],
                  1e-4 * scale_of(want))
            check(f"L advect_all3 ({label}, trace {on}) against K and M",
                  max_err(got, (scalar(trace, f), velocity(f))), 0.0)
        got = velocity(f)
        torch.cuda.synchronize()
        want = velocity_plain(f)
        errs["M"] = max_err([got], [want])
        check(f"M advect_velocity3 ({label})", errs["M"],
              1e-4 * scale_of([want]))
        return errs

    scene = ops3d.empty_domain3(1, RES3, RES3, RES3, device=dev)
    flag_sets = {"stress": flags, "scene": scene}
    done = phase("kernels K, L, M against their plain versions")
    errs = {name: check_klm(f"{RES3}^3, {name} flags", f)
            for name, f in flag_sets.items()}
    # M's rings are built for each max_disp up to 4: the other instances,
    # with displacements past each clamp (up to 3 and 6 cells).
    for d_other, dt_other in ((1, dt), (3, 2 * dt), (4, 2 * dt)):
        got = advect3.advect_velocity3(dt_other, U, flags, 0.6, d_other)
        torch.cuda.synchronize()
        want = ops3d.advect_velocity3(dt_other, U, flags, 0.6,
                                      max_disp=d_other)
        check(f"M advect_velocity3 ({RES3}^3, stress flags, max_disp "
              f"{d_other})", max_err([got], [want]), 0.0)
    done()

    done = phase("kernels K, L, M timed")
    times = {}
    for name, f in flag_sets.items():
        for trace in (True, False):
            times["K", name, trace] = cuda_ms(lambda: scalar(trace, f), 20)
            times["L", name, trace] = cuda_ms(lambda: merged(trace, f), 20)
        times["M", name] = device_and_eager(lambda: velocity(f))
    border = ops3d.border_mask3(RES3, RES3, RES3, 1, flags.device)
    cc = ops3d.where0(~border[None, None], ops3d.get_centered3(U))
    stats = {name: walk_stats(f, cc, D, dt) for name, f in flag_sets.items()}
    per_all = per_scalar + 3 * per_component
    plain_ms = {"K": cuda_ms(lambda: scalar_plain(False), 3, warmup=1),
                "K trace": cuda_ms(lambda: scalar_plain(True), 2, warmup=1),
                "M": cuda_ms(velocity_plain, 3, warmup=1),
                "L": cuda_ms(lambda: (scalar_plain(True), velocity_plain()),
                             2, warmup=1)}
    for k, nbytes, ops_cell, trace in (("K", 24, per_scalar, False),
                                       ("L", 36, per_all, True),
                                       ("M", 28, 3 * per_component, False)):
        b_ms, b_by = bound(nbytes * n, advect3_ops(flags, D, ops_cell, trace))
        err = errs["stress"][k, trace] if k != "M" else errs["stress"]["M"]
        ms = (times[k, "stress", trace] if k != "M"
              else times["M", "stress"][0])
        plain = plain_ms[k]
        results[k] = dict(err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
        kind = " device" if k == "M" else ""
        print(f"{k}: kernel {ms:.4f} ms{kind}, plain {plain:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
    for k, nbytes, ops_cell in (("K", 24, per_scalar), ("L", 36, per_all)):
        for name, f in flag_sets.items():
            on_ms, on_by = bound(nbytes * n, advect3_ops(f, D, ops_cell,
                                                         True))
            off_ms, off_by = bound(nbytes * n, advect3_ops(f, D, ops_cell,
                                                           False))
            box_ms, box_by = bound(nbytes * n, ops_cell * n
                                   + 30.0 * stats[name]["tested"])
            print(f"{k} on the {name} flags: trace on "
                  f"{times[k, name, True]:.4f} ms (bound {on_ms:.4f} "
                  f"({on_by}); pruned-box bound "
                  f"{box_ms:.4f} ({box_by})), trace off "
                  f"{times[k, name, False]:.4f} ms (bound {off_ms:.4f} "
                  f"({off_by}))", flush=True)
    print(f"K plain with the trace {plain_ms['K trace']:.3f} ms", flush=True)
    for name in flag_sets:
        print_step0(f"M {name}", *times["M", name])
    for name, st in stats.items():
        print(f"trace walk on the {name} flags (forward and backward rays): "
              f"{st['rays']} rays, {st['walked']:.4f} walked (a blocked "
              f"cell in the box), {st['offsets']:.3f} offsets a ray and "
              f"{st['offsets_walk']:.3f} a walking ray (window "
              f"{(2 * D + 1) ** 3 - 1}), {st['tested'] / st['rays']:.3f} "
              "blocked cells tested a ray", flush=True)
    done()


def walk_stats(flags, cc, D, dt):
    """How the pruned first-hit trace of kernels A, D, K and L walks on
    ``flags`` (b, h, w) or (b, d, h, w), counted from
    ``line_trace.firsthit_box`` for the scalar's forward and backward rays
    (fluid cells, displacement -/+dt times the centred velocity ``cc``
    (zero on the border) clipped to +-D, of length > 1e-12): the rays,
    the share whose box holds a blocked cell (only those run slab tests),
    the mean offsets of the box within the grid (the ray's own cell left
    out) over all rays and over those that walked, and the blocked cells
    tested in all."""
    import itertools

    from fluidnet_cxx_tpu_torch.celltype import FLUID
    from fluidnet_cxx_tpu_torch.ops.line_trace import (firsthit_box,
                                                       firsthit_slack2)

    dims = flags.shape[1:]            # (h, w) or (d, h, w)
    k = len(dims)
    fluid = flags == FLUID
    blocked = torch.nn.functional.pad((~fluid).float(), (D,) * 2 * k) > 0.5
    idx = torch.meshgrid(*[torch.arange(n, device=flags.device)
                           for n in dims], indexing="ij")
    idx = [i.expand(flags.shape) for i in reversed(idx)]   # x, y (, z)
    sizes = list(reversed(dims))
    slack = firsthit_slack2(dims, D)
    rays = walked = offsets = offsets_walk = tested = 0
    for sdt in (dt, -dt):
        disp = torch.clamp(-sdt * cc, -D, D)
        ray = fluid & (disp.square().sum(1).sqrt() > 1e-12)
        box = firsthit_box(disp, D, slack)
        cells = 1
        for (lo, hi), ii, n in zip(box, idx, sizes):
            cells = cells * (torch.minimum(hi, n - 1 - ii)
                             - torch.maximum(lo, -ii) + 1)
        vol = cells - 1
        hits = torch.zeros_like(vol)
        for off in itertools.product(range(-D, D + 1), repeat=k):
            # off is (.., oy, ox) in the order of dims; box is (x, y, ..).
            nb = blocked[(slice(None),) + tuple(
                slice(D + o, D + o + n) for o, n in zip(off, dims))]
            inb = nb
            for (lo, hi), o in zip(box, reversed(off)):
                inb = inb & (lo <= o) & (o <= hi)
            hits += inb.int()
        walks = ray & (hits > 0)
        rays += int(ray.sum())
        walked += int(walks.sum())
        offsets += float(vol[ray].sum())
        offsets_walk += float(vol[walks].sum())
        tested += float(hits[ray].sum())
    return dict(rays=rays, walked=walked / rays, offsets=offsets / rays,
                offsets_walk=offsets_walk / max(walked, 1), tested=tested)


def check_bf16(name, got, want, off_share=BF16_OFF_SHARE, presum=None):
    """Hold a bfloat16 output to its plain version: each value within one
    bfloat16 ulp of the plain value, or within 1e-5 of the largest output
    where cancellation leaves the value near zero (a sum taken in another
    order may round to the neighbouring bfloat16), and at most
    ``off_share`` of the values not equal to it. With ``presum`` (the
    plain version's float32 sum of a layer that rounds the sum to bfloat16
    before the bias add, N's flax route) one ulp at each rounding point:
    the ulp of the sum (1% up, for a sum in the next binade) plus the ulp
    of the larger output, since the bias add carries a sum that rounded to
    the neighbouring bfloat16 into the output, several output ulps where
    the bias cancels most of the sum. Returns the largest absolute
    error."""
    err, excess, off = bf16_gap(got, want, presum)
    print(f"{name}: max_abs_err {err:.3e}; largest excess over max(1 ulp"
          f"{' at each rounding point' if presum is not None else ''}, "
          f"1e-5 of the largest output) {excess:.3e}; {off} of {got.numel()} "
          "values off", flush=True)
    if not excess <= 0 or off > off_share * got.numel():
        raise SystemExit(f"{name} disagrees with its plain version")
    return err


def bf16_gap(got, want, presum=None):
    """(largest absolute error, largest excess over check_bf16's
    tolerance, values off) of ``got`` against ``want``."""
    def ulp(a):
        a = a.abs()
        return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                           torch.zeros_like(a))

    w = want.float()
    d = (got.float() - w).abs()
    tol = (ulp(w) if presum is None else
           ulp(torch.maximum(got.float().abs(), w.abs()))
           + ulp(1.01 * presum.float()))
    tol = torch.clamp(tol, min=1e-5 * float(w.abs().max()))
    return float(d.max()), float((d - tol).max()), int((d > 0).sum())


# (kernel, stride, dilation, relu, c1, c2, co) of the bfloat16 route's
# rounding check: MGCoarse_128's kinds of layer at 32 channels.
BF16_ROUNDING_LAYERS = [
    (3, 1, 1, True, 32, 0, 32), (3, 1, 2, True, 32, 0, 32),
    (3, 2, 1, True, 32, 0, 64), (1, 1, 1, False, 64, 0, 64),
    (3, 1, 1, True, 32, 32, 32), (3, 1, 1, False, 32, 0, 16)]


def check_bf16_rounding(dev):
    """B's bfloat16 route bit for bit against its plain version on inputs
    whose every float32 product and partial sum is exact (values k/8 and
    k/64, |k| <= 16, a bias off the dyadic grid by 1/3), so that only the
    rounding points are under test: the sum rounded to bfloat16, then the
    bias add rounded again (tests/test_torch_bf16_conv.py holds the plain
    version so to flax); on each of BF16_ROUNDING_LAYERS at batch 2 on 16^2
    (split-K plans) and batch 8 on 64^2; and a single rounding after the
    bias add shown to miss the kernel."""
    from fluidnet_cxx_tpu_torch.ops.kernels import punet
    from fluidnet_cxx_tpu_torch.ops.kernels.conv_plan import plan_conv

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)

    def dyadic(shape, num, den):
        return torch.randint(-num, num + 1, shape, generator=gen,
                             device=dev).float() / den

    for n, side in ((2, 16), (8, 64)):
        for k, stride, dil, relu, c1, c2, co in BF16_ROUNDING_LAYERS:
            x = dyadic((n, side, side, c1), 16, 8).to(torch.bfloat16)
            x2 = (dyadic((n, side, side, c2), 16, 8).to(torch.bfloat16)
                  if c2 else None)
            w = dyadic((k, k, c1 + c2, co), 16, 64).to(torch.bfloat16)
            bias = (dyadic((co,), 64, 128) + 1.0 / 3.0).to(
                torch.bfloat16).float()
            got = punet.conv2d_nhwc(x, w, bias, stride, dil, relu, x2)
            want = punet.conv2d_nhwc_plain(x, w.permute(3, 2, 0, 1), bias,
                                           stride, dil, relu, x2)
            xs = x if x2 is None else torch.cat([x, x2], dim=-1)
            once = punet.conv2d_nhwc_plain(
                xs.float(), w.float().permute(3, 2, 0, 1), bias, stride,
                dil, relu).to(torch.bfloat16)
            torch.cuda.synchronize()
            m = n * (-(-side // stride)) ** 2
            plan = plan_conv(m, co, k * k, c1, c2, "bf16")
            tag = (f"B bf16 rounding k{k} s{stride} d{dil} "
                   f"{'relu' if relu else 'lin'} {c1}+{c2}->{co} at "
                   f"{n}x{side}^2 ({plan.splits} splits)")
            missed = int((once != got).sum())
            print(f"{tag}: {int((got != want).sum())} values differ from the"
                  f" plain version; a single rounding misses {missed}",
                  flush=True)
            check(tag, max_err([got.float()], [want.float()]), 0.0)
            if missed == 0:
                raise SystemExit(f"{tag}: a single rounding after the bias "
                                 "add gives the kernel's output: the check "
                                 "cannot see the rounding points")


def punet3_work(net, x):
    """(bytes, operations) of one PUNet3 forward of ``x`` (b, d, h, w, C):
    the float32 input read and the float32 output written once, the
    weights (in the compute dtype) and biases read once; two operations per
    multiply-add of each layer at its output size (a stride-2 down halves
    the side, each up's depth-to-space doubles it)."""
    side = x.shape[1] // net.patch
    macs = 0
    for name, ci, co, k, stride in net.table:
        if stride == 2:
            side //= 2
        macs += x.shape[0] * side ** 3 * k ** 3 * ci * co
        if name.startswith("up"):
            side *= 2
    wbytes = sum(c.weight.numel() * net.act_dtype.itemsize
                 + 4 * c.bias.numel() for c in net.convs.values())
    return 4 * x.numel() + 4 * x[..., 0].numel() + wbytes, 2.0 * macs


def conv3d_library(net, dtype):
    """The PUNet3 forward as cuDNN F.conv3d calls on NCDHW tensors in
    ``dtype`` (bfloat16 in channels_last_3d, or float32 with TF32 off),
    weights cast once; returns ``forward(x)``. A yardstick only: it rounds
    every layer's output to ``dtype``."""
    from fluidnet_cxx_tpu_torch.models.punet3d import (depth_to_space3,
                                                       space_to_depth3)
    from fluidnet_cxx_tpu_torch.ops.kernels.punet import same_pads

    fmt = (torch.channels_last_3d if dtype == torch.bfloat16
           else torch.contiguous_format)
    params = {name: (c.weight.detach().to(dtype).contiguous(
                         memory_format=fmt), c.bias.detach().to(dtype))
              for name, c in net.convs.items()}

    def conv(name, h, relu=True):
        w, b = params[name]
        stride = net.strides[name]
        lo, hi = same_pads(h.shape[-1], w.shape[-1], stride, 1)
        h = torch.nn.functional.conv3d(
            torch.nn.functional.pad(h, (lo, hi) * 3), w, b, stride=stride)
        return torch.relu(h) if relu else h

    def d2s(h, p):
        return depth_to_space3(h.permute(0, 2, 3, 4, 1), p).permute(
            0, 4, 1, 2, 3)

    def forward(x):
        h = space_to_depth3(x, net.patch).permute(0, 4, 1, 2, 3).to(dtype)
        h = conv("embed", h.contiguous(memory_format=fmt))
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
            h = conv(f"dec{i}_0", torch.cat([h, skips[i]], dim=1).contiguous(
                memory_format=fmt))
        return d2s(conv("head", h, relu=False), net.patch)

    return forward


def phase_learned3d(dev, results):
    """Kernels J and N at the learned 3-D main paths' shapes. J runs its
    plain version's float32 operations in the same order (-fmad=false), so
    it is held bit-exact. N sums each output in another order than
    F.conv3d: a float32 layer is held to 1e-5 of its largest output, a
    bfloat16 one to one bfloat16 ulp (check_bf16); the whole float32
    forward to 1e-4 of its largest output, and the whole bfloat16 forward
    to 1e-2: there a sum taken in another order can round an activation
    to the neighbouring bfloat16 and the next layers carry that on (on the
    CPU, summing in float64 instead of float32 at the same rounding points
    moves the p4 forward at 32^3 by 2.1e-3 of its largest output)."""
    import dataclasses

    from fluidnet_cxx_tpu_torch.config import load_model_config
    from fluidnet_cxx_tpu_torch.models.convert import STATE_DICT_FILE
    from fluidnet_cxx_tpu_torch.ops.kernels import proj_tail3, punet3
    from fluidnet_cxx_tpu_torch.run_plume3d import build_punet3

    gen = torch.Generator().manual_seed(SEED + 4)
    flags, U, _ = stress_inputs3(gen, dev, RES3)
    n = RES3 ** 3

    done = phase("kernel J project_tail3")
    p0 = torch.randn(flags.shape, generator=gen).to(dev)
    for start, p in (("cold", torch.zeros_like(p0)), ("warm", p0)):
        for it in (16, 8):
            got = proj_tail3.project_tail3(flags, U, p, it, 2.0 / 3.0)
            torch.cuda.synchronize()
            want = proj_tail3.project_tail3_plain(flags, U, p, it, 2.0 / 3.0)
            e = max_err(got, want)
            check(f"J project_tail3 ({RES3}^3, {start}, {it} sweeps damped "
                  "2/3)", e, 0.0)
            if start == "warm" and it == 16:
                err = e
    run = lambda: proj_tail3.project_tail3(flags, U, p0, 16, 2.0 / 3.0)
    ms, eager_ms = device_and_eager(run)
    print_step0("J 16 warm", ms, eager_ms)
    run8 = lambda: proj_tail3.project_tail3(flags, U, p0, 8, 2.0 / 3.0)
    print_step0("J 8 warm", *device_and_eager(run8))
    plain_ms = cuda_ms(lambda: proj_tail3.project_tail3_plain(
        flags, U, p0, 16, 2.0 / 3.0), 3, warmup=1)
    b_ms, b_by = bound(36 * n, (14.0 * 16 + 60) * n)
    b8_ms, b8_by = bound(36 * n, (14.0 * 8 + 60) * n)
    results["J"] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
    print(f"J: {launches_of(proj_tail3.project_tail3, run)} launches (16 "
          f"sweeps), {launches_of(proj_tail3.project_tail3, run8)} (8); "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); 8 "
          f"sweeps: bound {b8_ms:.4f} ms ({b8_by})", flush=True)
    done()

    def net_of(model_dir, dtype):
        mcfg = dataclasses.replace(load_model_config(str(model_dir)),
                                   compute_dtype=dtype)
        net = build_punet3(mcfg, None, dev, model_dir)
        print(f"N ({dtype}): trained weights, {model_dir}/{STATE_DICT_FILE}",
              flush=True)
        return net, punet3.pack_weights3(net)

    phase_punet3(dev, gen, results, net_of)


def phase_punet3(dev, gen, results, net_of):
    """Kernel N: each layer kind alone at the p8 main path's shapes, with
    the planner's plan and with the 8^3 level's split; the whole forwards;
    repeats; the per-layer tables of the bfloat16 forwards beside cuDNN's
    same layers (bfloat16, channels_last_3d)."""
    from fluidnet_cxx_tpu_torch.ops.kernels import punet3
    from fluidnet_cxx_tpu_torch.ops.kernels.conv_plan import plan_conv

    def geometry(x, w, stride, x2):
        m = x.shape[0] * (-(-x.shape[1] // stride)) ** 3
        c2 = 0 if x2 is None else x2.shape[-1]
        return m, w.shape[4], w.shape[0] ** 3, x.shape[-1], c2

    done = phase("kernel N punet3 conv, each layer kind")
    g0 = RES3 // 8
    gen8 = torch.Generator().manual_seed(SEED + 5)
    for dtype in ("float32", "bfloat16"):
        net, packed = net_of(MODEL_P8, dtype)
        act = net.act_dtype
        route = "bf16" if dtype == "bfloat16" else "simt"

        def rand(c, dt=act, side=g0, g=gen):
            return torch.randn((1, side, side, side, c),
                               generator=g).to(dev, dt)

        # Each kind at its main-path shape, then again with every input
        # side halved: at the 8^3 level's size, with the split the planner
        # gives it there.
        for level, side, g in (("main-path shape", g0, gen),
                               ("8^3 level", g0 // 2, gen8)):
            cases = {
                "1x1 (embed)": ("embed", rand(2 * 8 ** 3, side=side, g=g),
                                None),
                "3x3x3 (enc0_0)": ("enc0_0", rand(96, side=side, g=g), None),
                "stride 2 (down1)": ("down1", rand(96, side=side, g=g),
                                     None),
                "1x1 to float32 (up0)": ("up0",
                                         rand(128, side=side // 2, g=g),
                                         None),
                "concat (dec0_0)": ("dec0_0",
                                    rand(96, torch.float32, side, g),
                                    rand(96, side=side, g=g)),
                "1x1 to float32 (head)": ("head", rand(96, side=side, g=g),
                                          None),
                "3x3x3 (enc1_0)": ("enc1_0", rand(128, side=g0 // 2,
                                                  g=gen8), None)}
            with torch.no_grad():
                for label, (name, x, x2) in cases.items():
                    relu = name != "head" and not name.startswith("up")
                    w, b = packed[name]
                    args = (b, net.strides[name], relu, x2,
                            net.out_dtype(relu))
                    want = punet3.conv3d_ndhwc_plain(
                        x, w.permute(4, 3, 0, 1, 2), *args)
                    got = punet3.conv3d_ndhwc(x, w, *args)
                    torch.cuda.synchronize()
                    plan = plan_conv(*geometry(x, w, net.strides[name], x2),
                                     route)
                    tag = (f"N {label} {dtype}, {level} {x.shape[1]}^3 (plan"
                           f" {plan.bm}x{plan.bn}, {plan.splits} splits)")
                    if want.dtype == torch.bfloat16:
                        check_bf16(tag, got, want, N_BF16_OFF_SHARE)
                    else:
                        check(tag, max_err([got], [want]),
                              1e-5 * float(want.abs().max()))
    done()

    x = torch.stack([torch.randn((1, RES3, RES3, RES3), generator=gen),
                     (torch.rand((1, RES3, RES3, RES3), generator=gen)
                      < 0.08).float()], dim=-1).to(dev)
    for label, model_dir in (("p8", MODEL_P8), ("p4", MODEL_P4)):
        for dtype in ("bfloat16", "float32"):
            done = phase(f"kernel N punet3 forward ({label}, {dtype})")
            net, packed = net_of(model_dir, dtype)
            with torch.no_grad():
                got = punet3.punet3_forward(net, packed, x)
                torch.cuda.synchronize()
                want = net(x)
                rel = 1e-2 if dtype == "bfloat16" else 1e-4
                err = max_err([got], [want])
                check(f"N punet3 forward {RES3}^3 {label} {dtype}", err,
                      rel * float(want.abs().max()))
                check_repeat(f"N punet3 forward {label} {dtype}",
                             lambda: punet3.punet3_forward(net, packed, x))
                lib = conv3d_library(net, net.act_dtype)
                lib_err = max_err([lib(x).float().permute(0, 2, 3, 4, 1)],
                                  [want])
                ms = graph_ms(lambda: punet3.punet3_forward(net, packed, x),
                              10)
                eager_ms = cuda_ms(
                    lambda: punet3.punet3_forward(net, packed, x), 10)
                plain_ms = cuda_ms(lambda: net(x), 5)
                library_ms = graph_ms(lambda: lib(x), 10)
                library_eager_ms = cuda_ms(lambda: lib(x), 10)
                if dtype == "bfloat16":
                    punet3_table(net, packed, x, label, geometry)
            nbytes, nops = punet3_work(net, x)
            b_ms, b_by = bound(nbytes, nops, BF16_OPS_PER_S)
            f_ms, _ = bound(nbytes, nops)
            print(f"N {label} {dtype}: kernel {ms:.4f} ms (eager "
                  f"{eager_ms:.4f}), plain {plain_ms:.3f} ms, library "
                  f"{library_ms:.4f} ms (eager {library_eager_ms:.4f}; "
                  f"cuDNN {dtype}; vs plain {lib_err:.3e}), bound "
                  f"{b_ms:.4f} ms ({b_by}, bf16 tensor cores; fp32 "
                  f"{f_ms:.4f} ms), {nops / 1e9:.3f} GFLOP", flush=True)
            if label == "p8" and dtype == "bfloat16":
                results["N"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=library_ms)
            done()


def punet3_table(net, packed, x, label, geometry):
    """Each layer of one bfloat16 PUNet3 forward of ``x`` on the
    activations the forward hands it: held to its plain version (one
    bfloat16 ulp, or 1e-5 of the largest float32 output), then the
    per-layer table of its kernel time beside cuDNN's F.conv3d of the same
    layer in bfloat16 (channels_last_3d, the concat's float32 half rounded
    to bfloat16, as the library chain does) and its bound at the bf16
    tensor-core rate."""
    from fluidnet_cxx_tpu_torch.ops.kernels import punet3
    from fluidnet_cxx_tpu_torch.ops.kernels.conv_plan import plan_conv
    from fluidnet_cxx_tpu_torch.ops.kernels.punet import same_pads

    def run(hook):
        def conv(name, h, x2=None, relu=True):
            w, b = packed[name]
            return hook(name, (h, w, b, net.strides[name], relu, x2,
                               net.out_dtype(relu)), {})
        return net(x, conv=conv)

    cl = torch.channels_last_3d
    rows = []
    for name, args, _ in record_layers(run, punet3.conv3d_ndhwc):
        h, w, b, stride, relu, x2, _ = args
        m, co, taps, c1, c2 = geometry(h, w, stride, x2)
        plan = plan_conv(m, co, taps, c1, c2, "bf16")
        got = punet3.conv3d_ndhwc(*args)
        want = punet3.conv3d_ndhwc_plain(h, w.permute(4, 3, 0, 1, 2),
                                         *args[2:])
        tag = (f"N {label} layer {name} (plan {plan.bm}x{plan.bn}, warp "
               f"tile {plan.warp_m} rows, {plan.splits} splits)")
        if want.dtype == torch.bfloat16:
            check_bf16(tag, got, want, N_BF16_OFF_SHARE)
        else:
            check(tag, max_err([got], [want]), 1e-5 * float(want.abs().max()))
        hn = h.to(torch.bfloat16)
        if x2 is not None:
            hn = torch.cat([hn, x2], dim=-1)
        lo, hi = same_pads(h.shape[1], w.shape[0], stride, 1)
        hn = torch.nn.functional.pad(hn.permute(0, 4, 1, 2, 3),
                                     (lo, hi) * 3).contiguous(
                                         memory_format=cl)
        wn = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=cl)
        bn = b.to(torch.bfloat16)

        def lib(hn=hn, wn=wn, bn=bn, stride=stride, relu=relu):
            y = torch.nn.functional.conv3d(hn, wn, bn, stride=stride)
            return torch.relu(y) if relu else y

        ops = 2.0 * m * co * taps * (c1 + c2)
        nbytes = (h.numel() * h.element_size() + 2 * w.numel() + 4 * co
                  + (0 if x2 is None else 2 * x2.numel())
                  + m * co * args[6].itemsize)
        rows.append(dict(
            name=name, m=m, co=co, k=taps * (c1 + c2), bm=plan.bm,
            bn=plan.bn, splits=plan.splits, blocks=plan.blocks,
            ms=graph_ms(lambda: punet3.conv3d_ndhwc(*args)),
            lib_ms=graph_ms(lib),
            bound_ms=bound(nbytes, ops, BF16_OPS_PER_S)[0]))
    conv_table(f"N per layer, {label} bfloat16 at {RES3}^3 (bound: bf16 "
               "rate)", rows)


# The 3-D cylinder at the JAX package's default size (sim/scenes3.py::
# create_cylinder_scene3: 32 x 128 x 384, radius 12.5 at x 64).
CYL3_D, CYL3_H, CYL3_W = 32, 128, 384
MODEL_P8J = "trained_models/PUNet3p8j_64"
MODEL_P8R = "trained_models/PUNet3p8r_64"
# (kernel, stride, relu, c1, c2, co) of N's flax-route rounding check: the
# flax PUNet3's kinds of layer at 32-channel multiples (the concat takes
# both halves in bfloat16, the up conv and the head round to bfloat16).
N_FLAX_ROUNDING_LAYERS = [(1, 1, True, 64, 0, 32), (3, 1, True, 32, 0, 32),
                          (3, 2, True, 32, 0, 64), (1, 1, False, 64, 0, 256),
                          (3, 1, True, 32, 32, 32), (1, 1, False, 32, 0, 64)]


def cylinder3_inputs(dev, gen):
    """The 3-D cylinder's flags (32 x 128 x 384, the extruded disc) with a
    random U of up to 1.5 cells a step at dt 0.3 and its viscous field
    (viscosity 0.25, the scene's)."""
    from fluidnet_cxx_tpu_torch.ops import ops3d
    from fluidnet_cxx_tpu_torch.sim.scenes3 import create_cylinder_scene3

    state, visc = create_cylinder_scene3(CYL3_D, CYL3_H, CYL3_W)
    U = 10.0 * (torch.rand(state.U.shape, generator=gen) - 0.5)
    orig = ops3d.add_viscosity3(0.3, U, state.flags, visc)
    return state.flags.to(dev), U.to(dev), orig.to(dev)


def check_n_flax_rounding(dev):
    """N's flax route bit for bit against its plain version on inputs
    whose every float32 product and partial sum is exact (values k/8 and
    k/64, |k| <= 16, a bias off the dyadic grid by 1/3), so that only the
    rounding points are under test (the sum rounded to bfloat16, the
    bfloat16 bias added and rounded again; tests/test_torch_flax3d.py
    holds the plain version so to flax): each of N_FLAX_ROUNDING_LAYERS at
    16^3 and at 8^3 (split-K plans); and a single rounding after the bias
    add shown to miss the kernel."""
    from fluidnet_cxx_tpu_torch.ops.kernels import punet3
    from fluidnet_cxx_tpu_torch.ops.kernels.conv_plan import plan_conv

    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    bf = torch.bfloat16

    def dyadic(shape, num, den):
        return torch.randint(-num, num + 1, shape, generator=gen,
                             device=dev).float() / den

    for side in (16, 8):
        for k, stride, relu, c1, c2, co in N_FLAX_ROUNDING_LAYERS:
            x = dyadic((1, side, side, side, c1), 16, 8).to(bf)
            x2 = dyadic((1, side, side, side, c2), 16, 8).to(bf) if c2 \
                else None
            w = dyadic((k, k, k, c1 + c2, co), 16, 64).to(bf)
            bias = (dyadic((co,), 64, 128) + 1.0 / 3.0).to(bf).float()
            args = (bias, stride, relu, x2, bf)
            got = punet3.conv3d_ndhwc(x, w, *args, round_sum=True)
            want = punet3.conv3d_ndhwc_plain(x, w.permute(4, 3, 0, 1, 2),
                                             *args, round_sum=True)
            once = punet3.conv3d_ndhwc_plain(x, w.permute(4, 3, 0, 1, 2),
                                             *args)
            torch.cuda.synchronize()
            m = (-(-side // stride)) ** 3
            plan = plan_conv(m, co, k ** 3, c1, c2, "bf16")
            tag = (f"N flax rounding k{k} s{stride} "
                   f"{'relu' if relu else 'lin'} {c1}+{c2}->{co} at "
                   f"{side}^3 ({plan.splits} splits)")
            missed = int((once != got).sum())
            print(f"{tag}: {int((got != want).sum())} values differ from the"
                  f" plain version; a single rounding misses {missed}",
                  flush=True)
            check(tag, max_err([got.float()], [want.float()]), 0.0)
            if missed == 0:
                raise SystemExit(f"{tag}: a single rounding after the bias "
                                 "add gives the kernel's output: the check "
                                 "cannot see the rounding points")


def phase_new3d(dev, results):
    """Kernel M with a viscous orig, N's flax route and I inside the 3-D
    multigrid, at the new 3-D main paths' shapes. M with orig runs its
    plain version's float32 operations in the same order (-fmad=false):
    held bit for bit at 128^3 (stress inputs) and on the 32x128x384
    cylinder, at max_disp 2 and also 1 and 3 (past each clamp), and a D
    past the three rings' limit must raise. N's flax route bit for bit on
    exact sums (check_n_flax_rounding), then each layer of PUNet3p8_64's
    flax-path forward at 128^3 on the activations the forward hands it
    within one bfloat16 ulp at each of its two rounding points with at
    most one value in 1000 off (check_bf16 with the layer's sum),
    the whole forward within BF16_FORWARD_TOL, a repeat bit-equal, beside
    cuDNN's bfloat16 F.conv3d chain (whose every layer rounds to bfloat16,
    as flax's). I: its launches and device time inside one solve_mg3
    (2 V-cycles, 3 levels, post 8) at 128^3 and on the cylinder, the solve
    against the plain version on the CPU within 1e-5 of its largest
    value."""
    import dataclasses

    from fluidnet_cxx_tpu_torch.config import load_model_config
    from fluidnet_cxx_tpu_torch.ops import multigrid, ops3d
    from fluidnet_cxx_tpu_torch.ops.kernels import (_build, advect3, jacobi3,
                                                    punet3)
    from fluidnet_cxx_tpu_torch.run_plume3d import build_punet3

    gen = torch.Generator().manual_seed(SEED + 23)
    done = phase("kernel M advect_velocity3 with orig")
    flags, U, _ = stress_inputs3(gen, dev, RES3)
    orig = ops3d.add_viscosity3(0.25, U, flags, 0.25)
    c_flags, c_U, c_orig = cylinder3_inputs(dev, gen)
    cases = {f"{RES3}^3 stress": (0.25, U, flags, orig),
             f"{CYL3_D}x{CYL3_H}x{CYL3_W} cylinder": (0.3, c_U, c_flags,
                                                    c_orig)}
    errs = {}
    for label, (dt, u, f, o) in cases.items():
        for D, scale in ((2, 1.0), (1, 1.0), (3, 2.0)):
            got = advect3.advect_velocity3(scale * dt, u, f, 0.6, D, orig=o)
            torch.cuda.synchronize()
            want = ops3d.advect_velocity3(scale * dt, u, f, 0.6, max_disp=D,
                                          orig=o)
            e = max_err([got], [want])
            check(f"M with orig ({label}, max_disp {D})", e, 0.0)
            errs[label, D] = e
    most = _build.query("fn_advect3_velocity_max_disp", 1)
    try:
        advect3.advect_velocity3(0.25, U, flags, 0.6, most + 1, orig=orig)
    except ValueError as e:
        print(f"M with orig at max_disp {most + 1} raises: {e}", flush=True)
    else:
        raise SystemExit(f"M with orig at max_disp {most + 1} did not raise")
    n = RES3 ** 3
    times = {}
    for label, (dt, u, f, o) in cases.items():
        run = (lambda dt=dt, u=u, f=f, o=o:
               advect3.advect_velocity3(dt, u, f, 0.6, 2, orig=o))
        times[label] = device_and_eager(run)
        plain = (lambda dt=dt, u=u, f=f, o=o:
                 ops3d.advect_velocity3(dt, u, f, 0.6, max_disp=2, orig=o))
        cells = f.numel()
        b_ms, b_by = bound(40 * cells, 3 * 140.0 * cells)
        nb_ms, _ = bound(28 * cells, 3 * 140.0 * cells)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        no_orig = device_and_eager(
            lambda dt=dt, u=u, f=f: advect3.advect_velocity3(dt, u, f, 0.6,
                                                             2))
        print(f"M with orig ({label}): kernel {times[label][0]:.4f} ms device"
              f" (eager {times[label][1]:.4f}), without orig "
              f"{no_orig[0]:.4f} (eager {no_orig[1]:.4f}), plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, 40 B a "
              f"cell; 28 B without orig {nb_ms:.4f}), "
              f"{launches_of(advect3.velocity_orig, run)} launches a call",
              flush=True)
        if label.startswith(f"{RES3}^3"):
            results["M orig"] = dict(
                err=errs[label, 2], ms=times[label][0], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
    done()

    done = phase("kernel N punet3 conv, flax route")
    check_n_flax_rounding(dev)
    mcfg = load_model_config(MODEL_P8)
    net = build_punet3(mcfg, None, dev, MODEL_P8, rounding="flax")
    packed = punet3.pack_weights3(net)
    x = torch.stack([torch.randn((1, RES3, RES3, RES3), generator=gen),
                     (torch.rand((1, RES3, RES3, RES3), generator=gen)
                      < 0.08).float()], dim=-1).to(dev)

    def run(hook):
        def conv(name, h, x2=None, relu=True):
            w, b = packed[name]
            return hook(name, (h, w, b, net.strides[name], relu, x2,
                               net.out_dtype(relu), True), {})
        return net(x, conv=conv)

    with torch.no_grad():
        for name, args, _ in record_layers(run, punet3.conv3d_ndhwc):
            h, w, b, stride, relu, x2 = args[:6]
            got = punet3.conv3d_ndhwc(*args)
            want = punet3.conv3d_ndhwc_plain(h, w.permute(4, 3, 0, 1, 2),
                                             *args[2:])
            presum = punet3.conv3d_ndhwc_plain(
                h, w.permute(4, 3, 0, 1, 2), torch.zeros_like(b), stride,
                False, x2)
            torch.cuda.synchronize()
            check_bf16(f"N flax route layer {name} ({h.shape[1]}^3 -> "
                       f"{w.shape[-1]} channels)", got, want, BF16_OFF_SHARE,
                       presum)
        fwd = lambda: punet3.punet3_forward(net, packed, x)
        got = fwd()
        torch.cuda.synchronize()
        want = net(x)
        err = max_err([got], [want])
        check(f"N flax route forward {RES3}^3 p8 bfloat16", err,
              BF16_FORWARD_TOL * float(want.abs().max()))
        check_repeat("N flax route forward p8", fwd)
        lib = conv3d_library(net, torch.bfloat16)
        lib_err = max_err([lib(x).float().permute(0, 2, 3, 4, 1)], [want])
        before = punet3.flax_route.launches
        fwd()
        launches = punet3.flax_route.launches - before
        ms, eager_ms = device_and_eager(fwd)
        plain_ms = cuda_ms(lambda: net(x), 5)
        library_ms = graph_ms(lambda: lib(x), 10)
        library_eager_ms = cuda_ms(lambda: lib(x), 10)
    nbytes, nops = punet3_work(net, x)
    b_ms, b_by = bound(nbytes, nops, BF16_OPS_PER_S)
    results["N flax"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms)
    print(f"N flax route p8 bfloat16: kernel {ms:.4f} ms device (eager "
          f"{eager_ms:.4f}), {launches} launches, plain {plain_ms:.3f} ms, "
          f"library {library_ms:.4f} ms (eager {library_eager_ms:.4f}; cuDNN "
          f"bfloat16 F.conv3d chain; vs plain {lib_err:.3e}), bound "
          f"{b_ms:.4f} ms ({b_by}, bf16 tensor cores), {nops / 1e9:.3f} "
          "GFLOP", flush=True)
    done()

    done = phase("kernel I inside solve_mg3")
    mg_cases = {f"{RES3}^3 stress": flags,
                f"{CYL3_D}x{CYL3_H}x{CYL3_W} cylinder": c_flags}
    for label, f in mg_cases.items():
        u = U if f is flags else c_U
        div = ops3d.velocity_divergence3(u, f)
        kw = dict(n_vcycles=2, pre=4, post=8, coarse_iters=32, max_levels=3)
        solve = lambda f=f, div=div: multigrid.solve_mg3(f, div, **kw)
        got = solve()
        torch.cuda.synchronize()
        want = multigrid.solve_mg3(f.cpu(), div.cpu(), **kw)
        shapes = multigrid.level_shapes3(*f.shape[1:], 8, 3)
        check(f"solve_mg3 ({label}, levels {shapes}) against the CPU",
              max_err([got.cpu()], [want]), 1e-5 * scale_of([want]))
        n_i = launches_of(jacobi3.solve_jacobi3, solve)
        ms, eager_ms = device_and_eager(solve)
        print(f"I inside solve_mg3 ({label}): {n_i} launches a solve; the "
              f"solve {ms:.4f} ms device (eager {eager_ms:.4f})", flush=True)
    done()


# The card-against-CPU checks of the paths phase_new3d's kernels run.
NEW3D_SMALL = ("32^3 plume3d fused multigrid", "32^3 plume3d convnet flax p8",
               "32^3 plume3d convnet p8j", "8x24x48 cylinder3d jacobi-34",
               "16x32x64 cylinder3d multigrid vorticity")


def phase_small_check(keep=lambda name: True):
    """3 steps of small scenes: kernels on the card vs plain on the CPU,
    each field within 1e-4 of its largest value; the learned 3-D
    projection within 1e-3, since its bfloat16 activations round a sum
    taken in another order to the neighbouring bfloat16 now and then (on
    an H100 these checks read 3.3e-5 of the largest value at most);
    mg_learned, whose MGCoarse_128 computes in bfloat16 as JAX's does,
    within BF16_PATH_TOL (the same rounding, carried through the net's
    ten layers)."""
    from fluidnet_cxx_tpu_torch.run_cylinder import run_cylinder
    from fluidnet_cxx_tpu_torch.run_cylinder3d import run_cylinder3d
    from fluidnet_cxx_tpu_torch.run_plume import run_plume
    from fluidnet_cxx_tpu_torch.run_plume3d import run_plume3d
    from fluidnet_cxx_tpu_torch.run_rayleigh_taylor import run_rayleigh_taylor

    cases = {
        "64^2 plume convnet": lambda d: run_plume(64, 3, device=d),
        "64^2 plume jacobi-28": lambda d: run_plume(
            64, 3, device=d, sim_method="jacobi", jacobi_iter=28),
        "64^2 plume mg-2v": lambda d: run_plume(
            64, 3, device=d, sim_method="multigrid", mg_vcycles=2),
        "64^2 plume unfused jacobi-28": lambda d: run_plume(
            64, 3, device=d, sim_method="jacobi", jacobi_iter=28,
            fuse_advection=False),
        "64x32 RT multigrid": lambda d: run_rayleigh_taylor(
            32, 64, 3, device=d, sim_method="multigrid"),
        "64x256 cylinder jacobi-34": lambda d: run_cylinder(
            256, 64, 3, device=d, radius=8.0, center_x=40.0),
        "64x256 cylinder multigrid": lambda d: run_cylinder(
            256, 64, 3, device=d, radius=8.0, center_x=40.0,
            sim_method="multigrid"),
        "64x256 cylinder convnet": lambda d: run_cylinder(
            256, 64, 3, device=d, radius=8.0, center_x=40.0,
            sim_method="convnet"),
        "256^2 plume mg_learned": lambda d: run_plume(
            256, 3, device=d, sim_method="mg_learned"),
        **{f"64^2 plume {m.split('/')[-1]}": lambda d, m=m: run_plume(
            64, 3, device=d, model_dir=m) for m in NETS.values()},
        "32^3 plume3d fused trace jacobi-60": lambda d: run_plume3d(
            32, 3, device=d, fuse_advection=True, line_trace=True),
        "32^3 plume3d unfused jacobi-60": lambda d: run_plume3d(
            32, 3, device=d),
        "32^3 plume3d unfused trace jacobi-60": lambda d: run_plume3d(
            32, 3, device=d, line_trace=True),
        "32^3 plume3d convnet p8": lambda d: run_plume3d(
            32, 3, device=d, sim_method="convnet", model_dir=MODEL_P8),
        "32^3 plume3d convnet p4": lambda d: run_plume3d(
            32, 3, device=d, sim_method="convnet", model_dir=MODEL_P4),
        "32^3 plume3d fused multigrid": lambda d: run_plume3d(
            32, 3, device=d, sim_method="multigrid", fuse_advection=True),
        "32^3 plume3d convnet flax p8": lambda d: run_plume3d(
            32, 3, device=d, sim_method="convnet", model_dir=MODEL_P8,
            path="flax"),
        "32^3 plume3d convnet p8j": lambda d: run_plume3d(
            32, 3, device=d, sim_method="convnet", model_dir=MODEL_P8J),
        "8x24x48 cylinder3d jacobi-34": lambda d: run_cylinder3d(
            8, 24, 48, 3, d, radius=4.5, center_x=12.0),
        "16x32x64 cylinder3d multigrid vorticity": lambda d: run_cylinder3d(
            16, 32, 64, 3, d, "multigrid", vorticity_confinement=0.1,
            radius=4.5, center_x=12.0),
    }
    for name, run in cases.items():
        if not keep(name):
            continue
        done = phase(f"small-input check ({name}, 3 steps, card vs CPU)")
        gpu, cpu = run("cuda")["state"], run("cpu")["state"]
        rel = (1e-3 if "convnet" in name and "3d" in name else
               BF16_PATH_TOL if "mg_learned" in name else 1e-4)
        for field in ("U", "density", "p"):
            g, c = getattr(gpu, field).cpu(), getattr(cpu, field)
            e = max_err([g], [c])
            check(f"{name} {field} ({e / scale_of([c]):.2e} of its largest "
                  "value)", e, rel * scale_of([c]))
        done()


def main_paths():
    """name -> (run for n steps on the card, the (cfg, state, project_fn)
    of its first step, the kernels it must launch)."""
    from fluidnet_cxx_tpu_torch.run_cylinder import cylinder_case, run_cylinder
    from fluidnet_cxx_tpu_torch.run_cylinder3d import (cylinder3d_case,
                                                       run_cylinder3d)
    from fluidnet_cxx_tpu_torch.run_plume import plume_case, run_plume
    from fluidnet_cxx_tpu_torch.run_plume3d import (learned3d_case,
                                                    plume3d_case, run_plume3d)
    from fluidnet_cxx_tpu_torch.run_rayleigh_taylor import (
        rt_case, run_rayleigh_taylor)

    def plume(**kw):
        return (lambda n: run_plume(RES, n, "cuda", **kw),
                lambda: plume_case(RES, "cuda", **kw))

    def rt(method):
        return (lambda n: run_rayleigh_taylor(RT_W, RT_H, n, "cuda", method),
                lambda: rt_case(RT_W, RT_H, "cuda", method) + (None,))

    def plume3d(**kw):
        return (lambda n: run_plume3d(RES3, n, "cuda", **kw),
                lambda: plume3d_case(RES3, "cuda", **kw) + (None,))

    def cylinder(method):
        return (lambda n: run_cylinder(CYL_W, CYL_H, n, "cuda",
                                       sim_method=method),
                lambda: cylinder_case(CYL_W, CYL_H, "cuda",
                                      sim_method=method))

    def learned3d(model_dir, path="fused"):
        return (lambda n: run_plume3d(RES3, n, "cuda", sim_method="convnet",
                                      model_dir=model_dir, path=path),
                lambda: learned3d_case(RES3, "cuda", model_dir, path=path))

    def cylinder3d(method, vorticity=0.0):
        kw = dict(sim_method=method, vorticity_confinement=vorticity)
        return (lambda n: run_cylinder3d(CYL3_D, CYL3_H, CYL3_W, n, "cuda",
                                         **kw),
                lambda: cylinder3d_case(CYL3_D, CYL3_H, CYL3_W, "cuda", **kw)
                + (None,))

    return {
        f"plume {RES}^2 convnet": plume() + ("ABC",),
        f"plume {RES}^2 jacobi-200": plume(sim_method="jacobi",
                                           jacobi_iter=200) + ("AF",),
        f"plume {RES}^2 mg-2v": plume(sim_method="multigrid",
                                      mg_vcycles=2) + ("AH",),
        f"RT {RT_W}x{RT_H} jacobi-200": rt("jacobi") + ("AF",),
        f"RT {RT_W}x{RT_H} multigrid": rt("multigrid") + ("AG",),
        f"cylinder {CYL_W}x{CYL_H} jacobi-34": cylinder("jacobi") + ("EF",),
        f"plume {RES}^2 unfused jacobi-200": plume(
            sim_method="jacobi", jacobi_iter=200,
            fuse_advection=False) + ("DEF",),
        f"plume3d {RES3}^3 unfused jacobi-60": plume3d() + ("KMI",),
        f"plume3d {RES3}^3 unfused trace jacobi-60": plume3d(
            line_trace=True) + ("KMI",),
        f"plume3d {RES3}^3 fused trace jacobi-60": plume3d(
            fuse_advection=True, line_trace=True) + ("LI",),
        f"plume3d {RES3}^3 convnet p8": learned3d(MODEL_P8) + ("KMJN",),
        f"plume3d {RES3}^3 convnet p4": learned3d(MODEL_P4) + ("KMJN",),
        f"plume {RES}^2 mg_learned": plume(sim_method="mg_learned") + (
            ("A", "B", LEARNED_G),),
        f"cylinder {CYL_W}x{CYL_H} multigrid": cylinder("multigrid") + (
            "EH",),
        f"cylinder {CYL_W}x{CYL_H} convnet": cylinder("convnet") + ("EBC",),
        **{f"plume {RES}^2 {m.split('/')[-1]}": plume(model_dir=m) + ("AB",)
           for m in NETS.values()},
        f"plume3d {RES3}^3 fused multigrid": plume3d(
            fuse_advection=True, sim_method="multigrid") + ("LI",),
        f"cylinder3d {CYL3_D}x{CYL3_H}x{CYL3_W} jacobi-34": cylinder3d(
            "jacobi") + (("M", "Mo", "I"),),
        f"cylinder3d {CYL3_D}x{CYL3_H}x{CYL3_W} multigrid": cylinder3d(
            "multigrid") + (("M", "Mo", "I"),),
        f"cylinder3d {CYL3_D}x{CYL3_H}x{CYL3_W} jacobi-34 vorticity": (
            cylinder3d("jacobi", 0.1) + (("M", "Mo", "I"),)),
        f"plume3d {RES3}^3 convnet flax p8": learned3d(MODEL_P8, "flax") + (
            ("K", "M", "N", "Nf", "I"),),
        f"plume3d {RES3}^3 convnet p8j": learned3d(MODEL_P8J) + ("KMJN",),
        f"plume3d {RES3}^3 convnet p8r": learned3d(MODEL_P8R) + ("KMJN",),
    }


# The counter key of kernel G's learned-cut route (a separate wrapper,
# ops/kernels/mg.py::solve_mg_learned).
LEARNED_G = "Gl"

# Launches per step that a main path must show exactly: the learned
# V-cycle's 9 (fn_mg_learned_down: 2 set-up, a down launch for each of the
# two levels above the 128^2 cut, the cut's flags and RHS;
# fn_mg_learned_up: the cut's post-sweeps, two up launches, the gauge)
# and MGCoarseNet's 10 convs; FluidNetTower's 10 convs (conv1, the bank's
# two at three scales, conv2, conv3, convOut) and MultiScaleNet's 17, with
# no polish (C 0); H's 25 at 8000x800 (2 set-up, a down and an
# up launch for each of the 5 levels above the 250x25 tail and the tail,
# for 2 V-cycles, and the epilogue); PUNetD2_128's 14 convs; N's 9 convs; J's
# prologue, epilogue and one z-march per 3 polish sweeps (16 for p8: 6
# marches, 8 for p4: 3); I's mask launch and one z-march per 3 sweeps: the
# flax path's 16 "xla" polish sweeps 7, Jacobi-34 13, and in one solve_mg3
# (2 V-cycles over 3 levels: pre 4 (3), pre 4 (3), coarse 32 (12), post
# 8 (4), post 8 (4)) 52; M's two launches, both with orig on the
# cylinder; H's and G's two set-up launches, 7 (512^2: three
# levels down, the single-block tail, three up) or 5 (512x128) a V-cycle,
# and the epilogue, for 2 V-cycles; E's one launch and D's two; C's
# prologue, epilogue and one tile launch per 8 of its 32 polish sweeps;
# F's mask launch and one tile launch per 8 sweeps (200: 25, 34: 5).
EXACT_LAUNCHES = {f"plume3d {RES3}^3 convnet p8": {"J": 8, "N": 9},
                  f"plume3d {RES3}^3 convnet p8j": {"J": 8, "N": 9},
                  f"plume3d {RES3}^3 convnet p8r": {"J": 8, "N": 9},
                  f"plume3d {RES3}^3 convnet flax p8": {"I": 7, "J": 0,
                                                        "N": 9, "Nf": 9},
                  f"plume3d {RES3}^3 fused multigrid": {"L": 2, "I": 52},
                  f"cylinder3d {CYL3_D}x{CYL3_H}x{CYL3_W} jacobi-34": {
                      "M": 2, "Mo": 2, "I": 13},
                  f"cylinder3d {CYL3_D}x{CYL3_H}x{CYL3_W} multigrid": {
                      "M": 2, "Mo": 2, "I": 52},
                  f"cylinder3d {CYL3_D}x{CYL3_H}x{CYL3_W} jacobi-34 "
                  "vorticity": {"M": 2, "Mo": 2, "I": 13},
                  f"plume3d {RES3}^3 convnet p4": {"J": 5, "N": 9},
                  f"plume {RES}^2 convnet": {"C": 6},
                  f"plume {RES}^2 jacobi-200": {"F": 26},
                  f"plume {RES}^2 mg-2v": {"H": 17},
                  f"RT {RT_W}x{RT_H} jacobi-200": {"F": 26},
                  f"RT {RT_W}x{RT_H} multigrid": {"G": 13},
                  f"cylinder {CYL_W}x{CYL_H} jacobi-34": {"E": 1, "F": 6},
                  f"plume {RES}^2 unfused jacobi-200": {"D": 2, "E": 1,
                                                        "F": 26},
                  f"plume {RES}^2 mg_learned": {"A": 2, "B": 10,
                                                LEARNED_G: 9},
                  f"cylinder {CYL_W}x{CYL_H} multigrid": {"E": 1, "H": 25},
                  f"cylinder {CYL_W}x{CYL_H} convnet": {"B": 14, "C": 6,
                                                        "E": 1},
                  f"plume {RES}^2 DataTrain_128": {"A": 2, "B": 10, "C": 0},
                  f"plume {RES}^2 ScaleNet_jets_128": {"A": 2, "B": 17,
                                                       "C": 0}}
# C entry calls (ctypes calls) per step that a main path must show
# exactly: C's and F's whole solve from one call each.
EXACT_CALLS = {f"plume {RES}^2 convnet": {"fn_tail": 1},
               f"plume {RES}^2 jacobi-200": {"fn_jacobi_solve": 1},
               f"RT {RT_W}x{RT_H} jacobi-200": {"fn_jacobi_solve": 1},
               f"cylinder {CYL_W}x{CYL_H} jacobi-34": {"fn_jacobi_solve": 1},
               f"plume {RES}^2 unfused jacobi-200": {"fn_jacobi_solve": 1},
               f"plume {RES}^2 mg_learned": {"fn_mg_learned_down": 1,
                                             "fn_mg_learned_up": 1},
               f"cylinder {CYL_W}x{CYL_H} multigrid": {"fn_mg_project": 1},
               f"cylinder {CYL_W}x{CYL_H} convnet": {"fn_tail": 1}}


def phase_main_paths(counters, names=None):
    """Drive every main path (or those of ``names``) with the counters set
    to 0 just before and read just after; returns {path: {kernel:
    launches}}."""
    from fluidnet_cxx_tpu_torch.ops.kernels import _build

    seen = {}
    for name, (run, _, kernels) in main_paths().items():
        if names is not None and name not in names:
            continue
        done = phase(f"main path ({name}, {STEPS} steps)")
        for fn in counters.values():
            fn.launches = 0
        _build.calls.clear()
        out = run(STEPS)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        calls = dict(_build.calls)
        st = out["state"]
        for field in ("U", "density", "p"):
            if not bool(torch.isfinite(getattr(st, field)).all()):
                raise SystemExit(f"{name}: {field} is not finite")
        dims = st.flags.dim() - 1   # 2 or 3 velocity components
        if tuple(st.U.shape) != (1, dims) + tuple(st.flags.shape[1:]):
            raise SystemExit(f"{name}: U has shape {tuple(st.U.shape)}")
        missed = [k for k in kernels if launches[k] < 1]
        if missed:
            raise SystemExit(f"{name} missed kernels {missed}: {launches}")
        for k, per_step in EXACT_LAUNCHES.get(name, {}).items():
            if launches[k] != per_step * STEPS:
                raise SystemExit(f"{name}: {k} launched {launches[k]} "
                                 f"times, not {per_step} a step")
        for k, per_step in EXACT_CALLS.get(name, {}).items():
            if calls.get(k, 0) != per_step * STEPS:
                raise SystemExit(f"{name}: {k} called {calls.get(k, 0)} "
                                 f"times, not {per_step} a step")
        stats = {k: v for k, v in out.items()
                 if k not in ("state", "ms_per_step", "launches_per_step")}
        per_step = {k: v / STEPS for k, v in launches.items() if v}
        print(f"{name}: ms/step {out['ms_per_step']:.4f}; {stats}; "
              f"launches {launches} (per step {per_step}); C entry calls "
              f"per step {({k: v / STEPS for k, v in calls.items()})}",
              flush=True)
        seen[name] = launches
        done()
    return seen


def phase_profile(name, case):
    """Device time and idle share of 5 steps under torch.profiler (the
    profiler's own host cost makes the idle share an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    from fluidnet_cxx_tpu_torch.sim.step import simulate_step
    from fluidnet_cxx_tpu_torch.sim.step3d import simulate_step3

    done = phase(f"profile ({name}, 5 steps)")
    n = 5
    with torch.no_grad():
        cfg, state, project = case()
        step = simulate_step3 if state.flags.dim() == 4 else simulate_step
        for _ in range(3):
            state = step(cfg, state, project)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                state = step(cfg, state, project)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / n

    print_profile(name, prof, n, wall_ms)
    done()


def print_profile(name, prof, n, wall_ms):
    """Device busy ms per step, the idle share, the 8 kernels that take
    the most device time and every other kernel of the port's, from a
    profiler window of ``n`` steps that took ``wall_ms`` each."""
    # Device-side events only: an aten op's own row repeats the time of
    # the kernels it launched.
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    dev_ms = sum(dev_us(e) for e in events) / 1e3 / n
    if not events:
        print("profiler: no device time recorded", flush=True)
        return
    print(f"profile {name}: wall {wall_ms:.4f} ms/step, device busy "
          f"{dev_ms:.4f} ms/step, idle share {1 - dev_ms / wall_ms:.3f}",
          flush=True)
    ranked = sorted(events, key=dev_us, reverse=True)
    # The top 8, then the port's own kernels below them.
    for i, e in enumerate(ranked):
        if i >= 8 and not ("(anonymous namespace)::" in e.key
                           or "fnk::" in e.key):
            continue
        print(f"  {dev_us(e) / 1e3 / n:9.4f} ms/step "
              f"{e.count / n:6.1f} calls/step  {e.key[:70]}", flush=True)


def phase_bench():
    """Phase 7: the benches as functions, at their full rollouts and
    bench_reference.json's settings, timed at a reduced n (graph 200 and
    eager 20 at 128^2, 50 and 10 at 512^2, 3 reps; 3-D n 10, 1 rep); fails
    on a case outside its reference."""
    from fluidnet_cxx_tpu_torch import bench

    ref = str(bench.REFERENCE)
    runs = {"bench 128^2, five cases": bench.parse(
                ["--res", "128", "--n-time", "200", "--n-eager", "20",
                 "--reps", "3", "--reference", ref]),
            f"bench {RES}^2 cnn": bench.parse(
                ["--res", str(RES), "--cases", "cnn", "--n-time", "50",
                 "--n-eager", "10", "--reps", "3", "--reference", ref])}
    for name, args in runs.items():
        done = phase(name)
        out, full, failures = bench.run_bench(args)
        for res, rows in full["table"].items():
            for case, r in rows.items():
                print(f"{name}: {res}^2 {case} graph {r['sps']:.1f} steps/s "
                      f"(n {r['n_graph']}, spread {r['sps_spread']:.3f}), "
                      f"eager {r['eager_sps']:.1f} (n {r['n_eager']}); "
                      f"mean|div| {r['mean_div']:.6f} max|div| "
                      f"{r['max_div']:.5f} height {r['height']}; launches "
                      f"a step {r['launches_per_step']}; {r['engine']}",
                      flush=True)
        print(bench.compact(out), flush=True)
        if failures:
            raise SystemExit(f"{name}: reference check failed: {failures}")
        done()
    phase_bench3d([f"bench3d {RES3}^3 classical row",
                   ["--res", str(RES3), "--steps", "10", "--reps", "1",
                    "--reference", ref]],
                  [f"bench3d {MG3_REF_RES}^3 classical and multigrid rows",
                   ["--res", str(MG3_REF_RES), "--steps", "10", "--reps",
                    "1", "--multigrid", "--reference", ref]])


def phase_bench3d(*runs):
    """bench3d called as a function for each (title, argv) of ``runs``,
    every row held to bench_reference.json."""
    from fluidnet_cxx_tpu_torch import bench, bench3d

    for title, argv in runs:
        done = phase(title)
        out, full, failures = bench3d.run_bench3d(bench3d.parse(argv))
        res = argv[argv.index("--res") + 1]
        for case, r in full["table"].items():
            print(f"bench3d {res}^3 {case}: graph {r['sps']:.2f} steps/s, "
                  f"eager {r['eager_sps']:.2f}; max|div| {r['max_div']:.5f} "
                  f"mean|div| {r['mean_div']:.6f} density sum "
                  f"{r['density_sum']:.4f} max|U| {r['max_U']:.4f}; launches "
                  f"a step {r['launches_per_step']}; {r['engine']}",
                  flush=True)
        print(bench.compact(out), flush=True)
        if failures:
            raise SystemExit(f"bench3d: reference check failed: {failures}")
        done()


def mg_only(dev):
    """`python3 chip_smoke.py --mg-only`: kernels G and H alone, on the
    version of the package beside this script (Step 0: a checkout of the
    parent commit with this script copied in; a variant: a copy of the
    checkout with one constant of csrc/mg.cu changed). G's and H's
    (device, eager) ms in every case of mg_cases, as a STEP0_MS literal,
    their split, then the two multigrid main paths' ms/step and device
    busy. No checks: the full run holds the kernels to their plain
    versions."""
    done = phase("kernels G and H timed")
    inputs = solver_inputs(dev)
    times = mg_times(inputs)
    print("STEP0_MS = " + repr({k: (round(d, 4), round(e, 4))
                                for k, (d, e) in times.items()}), flush=True)
    cases = mg_cases(inputs)
    for name in ("G RT warm", f"H {RES}^2 warm"):
        print_split(name, device_split(cases[name][0]))
    done()
    for name, (run, case, _) in main_paths().items():
        if "mg-2v" not in name and "multigrid" not in name:
            continue
        done = phase(f"{name}, {STEPS} steps")
        print(f"{name}: ms/step {run(STEPS)['ms_per_step']:.4f}", flush=True)
        done()
        phase_profile(name, case)


def threed_only(dev):
    """`python3 chip_smoke.py --3d-only`: kernels J, M, K and L alone, on
    the version of the package beside this script (Step 0: a checkout of
    the parent commit with this script copied in; a variant: a copy of
    the checkout with one constant changed). Each case of cases3d held to
    its plain version (J and M bit for bit, K and L within 1e-4 of the
    largest output, as the full run holds them), its (device, eager) ms as
    a STEP0_MS literal, the device time of J's and M's launches by
    kernel; phase_new3d (M with orig, N's flax route, I inside solve_mg3)
    and the new 3-D paths' card-against-CPU checks; then the 3-D main
    paths that run J or M and the 3-D multigrid path with their counters,
    and the profiler's window of each."""
    done = phase("kernels J, M, K, L checked and timed")
    cases = cases3d(dev)
    for name, (run, plain) in cases.items():
        got = run()
        torch.cuda.synchronize()
        want = plain()
        tol = 0.0 if name[0] in "JM" else 1e-4 * scale_of(want)
        check(name, max_err(got, want), tol)
    times = {name: device_and_eager(run) for name, (run, _) in cases.items()}
    for name, (ms, eager) in times.items():
        print_step0(name, ms, eager)
    print("STEP0_MS 3-D = " + repr({k: (round(d, 4), round(e, 4))
                                    for k, (d, e) in times.items()}),
          flush=True)
    for name in ("J 16 warm", "M stress"):
        print(f"{name} by kernel:", flush=True)
        for key, (ms, n) in sorted(device_split(cases[name][0]).items(),
                                   key=lambda kv: -kv[1][0]):
            print(f"  {ms:9.4f} ms {n:5.1f} launches  {key[:90]}",
                  flush=True)
    done()
    phase_new3d(dev, {})
    phase_small_check(lambda name: name in NEW3D_SMALL)
    new = [name for name, (_, _, kernels) in main_paths().items()
           if "3d" in name and (set(kernels) & {"J", "M"}
                                or "multigrid" in name)]
    phase_main_paths(launch_counters(), new)
    for name in new:
        phase_profile(name, main_paths()[name][1])


def tail_only(dev):
    """`python3 chip_smoke.py --tail-only`: kernels C and F alone, on the
    version of the package beside this script (Step 0: a checkout of the
    parent commit with this script copied in). C at 512^2 (32 damped
    sweeps, scale and inlet) and F at 512^2 (200 sweeps) held to their
    plain versions bit for bit (check_tail), their (device, eager) ms
    beside Step 0 and as a STEP0_MS literal, launches and C entry calls a
    call, C's device time split into prologue, sweeps and epilogue; then
    the 512^2 convnet and jacobi-200 main paths: ms/step and the profiler's
    window."""
    from fluidnet_cxx_tpu_torch.ops.kernels import _build

    done = phase("kernels C and F checked and timed")
    inputs = tail_inputs(dev)
    cases = tail_cases(inputs)
    check_tail(inputs, cases)
    times = {name: device_and_eager(c[0]) for name, c in cases.items()}
    for name, (ms, eager) in times.items():
        print_step0(name, ms, eager)
    print("STEP0_MS C and F = " + repr(
        {k: (round(d, 4), round(e, 4)) for k, (d, e) in times.items()}),
        flush=True)
    for name, (run, _, counter) in cases.items():
        calls = getattr(_build, "calls", None)
        before = dict(calls) if calls is not None else {}
        n = launches_of(counter, run)
        made = ({k: v - before.get(k, 0) for k, v in calls.items()
                 if v != before.get(k, 0)} if calls is not None else "n/a")
        print(f"{name}: {n} launches, C entry calls {made}", flush=True)
    print_tail_split(device_split(cases["C 32"][0]))
    done()
    for name, (run, case, kernels) in main_paths().items():
        if f"plume {RES}^2" not in name or "unfused" in name or \
                "mg" in name:
            continue
        done = phase(f"{name}, {STEPS} steps")
        print(f"{name}: ms/step {run(STEPS)['ms_per_step']:.4f}", flush=True)
        done()
        phase_profile(name, case)


def tile_sweep(cases):
    """Device ms of E's cases at every tile of the planner's TILES (the
    planner's own pick marked), to check its choice."""
    from fluidnet_cxx_tpu_torch.ops.kernels import advect

    plan = advect.plan_tile
    try:
        for name, (run, _, counter, f, *_) in cases.items():
            if counter is not advect.advect_velocity:
                continue
            pick = plan(*f.shape, 4)
            row = []
            for tile in advect.TILES:
                advect.plan_tile = lambda *a, t=tile: t
                mark = "*" if tile == pick else ""
                row.append(f"{tile[0]}x{tile[1]}{mark} {graph_ms(run):.4f}")
            print(f"tiles {name}: " + ", ".join(row), flush=True)
    finally:
        advect.plan_tile = plan


def adv_only(dev):
    """`python3 chip_smoke.py --adv-only`: kernels A, D and E alone, on the
    version of the package beside this script (Step 0: a checkout of the
    parent commit with this script copied in). Each case of adv_cases held
    to its plain version bit for bit, with check_adv_branches where the
    package has a built max_disp limit; its (device, eager) ms beside
    Step 0 and as a STEP0_MS literal, launches a call; then the 2-D main
    paths that run A, D or E: ms/step and the profiler's window."""
    from fluidnet_cxx_tpu_torch.ops.kernels import _build

    done = phase("kernels A, D, E checked and timed")
    inputs = adv_inputs(dev)
    cases = adv_cases(inputs)
    for name, (run, plain, *_) in cases.items():
        got = run()
        torch.cuda.synchronize()
        check(name, max_err(got, plain()), 0.0)
    if "fn_advect_max_disp" in _build.QUERIES:
        check_adv_branches(inputs)
    adv_times(cases)
    for name, (run, _, counter, *_) in cases.items():
        print(f"{name}: {launches_of(counter, run)} launches a call",
              flush=True)
    d_split(inputs)
    if "fn_advect_max_disp" in _build.QUERIES:
        tile_sweep(cases)
    done()
    for name, (run, case, kernels) in main_paths().items():
        if "3d" in name or not set(kernels) & set("ADE"):
            continue
        done = phase(f"{name}, {STEPS} steps")
        print(f"{name}: ms/step {run(STEPS)['ms_per_step']:.4f}", flush=True)
        done()
        phase_profile(name, case)


def launch_counters():
    """{key: wrapper} of every kernel's launch counter."""
    from fluidnet_cxx_tpu_torch.ops.kernels import (advect, advect3, jacobi,
                                                    jacobi3, mg, proj_tail,
                                                    proj_tail3, punet, punet3)
    return {"A": advect.advect_all, "B": punet.conv2d_nhwc,
            "C": proj_tail.project_tail, "D": advect.advect_scalar,
            "E": advect.advect_velocity, "F": jacobi.solve_jacobi,
            "G": mg.solve_mg, "H": mg.project_mg,
            "I": jacobi3.solve_jacobi3, "J": proj_tail3.project_tail3,
            "K": advect3.advect_scalar3, "L": advect3.advect_all3,
            "M": advect3.advect_velocity3, "N": punet3.conv3d_ndhwc,
            "Mo": advect3.velocity_orig, "Nf": punet3.flax_route,
            LEARNED_G: mg.solve_mg_learned}


def learned_only(dev):
    """`python3 chip_smoke.py --learned-only`: this slice's phases alone
    (G's learned cut, H and C at 8000x800, B on the 1000x100 map), its
    small checks and its three main paths with their counters and
    profiles."""
    results = {}
    phase_mg_learned(dev, results)
    phase_cylinder_kernels(dev, results)
    phase_small_check(lambda name: "mg_learned" in name or (
        "cylinder" in name and "jacobi" not in name))
    new = [name for name in main_paths()
           if "mg_learned" in name or "cylinder" in name]
    phase_main_paths(launch_counters(), new)
    for name in new:
        phase_profile(name, main_paths()[name][1])


def nets_only(dev):
    """`python3 chip_smoke.py --nets-only`: kernel B's thin-channel phase,
    the 64^2 card-against-CPU checks and the two 512^2 main paths of the
    tower and ScaleNet with their counters and profiles."""
    phase_nets(dev, {})
    phase_small_check(lambda name: any(m.split("/")[-1] in name
                                       for m in NETS.values()))
    new = [name for name in main_paths()
           if any(m.split("/")[-1] in name for m in NETS.values())]
    phase_main_paths(launch_counters(), new)
    for name in new:
        phase_profile(name, main_paths()[name][1])


# Training (ROADMAP A.5): FluidNetTower and MultiScaleNet at configs/
# train.yaml's 128^2, batch 64.
TRAIN_RES, TRAIN_BSZ = 128, 64
TRAIN_MODELS = {"tower": "FluidNet", "scalenet": "ScaleNet",
                "punet": "PUNet"}
# PUNetD2_128's architecture (trained_models/PUNetD2_128/model_config.json:
# widths 96/128/128, dilation 2, 32 damped "xla" polish sweeps; patch 8).
TRAIN_CFG = {"PUNet": dict(punet_widths=(96, 128, 128),
                           punet_bottleneck_dilation=2, polish_sweeps=32)}
# Launches a train step of the backward kernels: the loss's two
# differentiable forwards each run a backward: weight gradients of every
# conv call, input gradients of every call whose input needs one (not the
# tower's conv1, ScaleNet's convN_4/Conv_0 nor PUNet's embed; PUNet's two
# stride-2 downs among them), and the polish's adjoint (a mask launch and
# 4 tile launches for 32 sweeps).
TRAIN_BACKWARD = {
    "FluidNet": {"wgrad": 20, "dgrad": 18, "F adjoint": 0},
    "ScaleNet": {"wgrad": 34, "dgrad": 32, "F adjoint": 0},
    "PUNet": {"wgrad": 28, "dgrad": 26, "F adjoint": 10}}
TRAIN_STEPS = {"FluidNet": 10, "ScaleNet": 5, "PUNet": 10}
TRAIN_REPLACES = "fluidnet_cxx_tpu/train/trainer.py:244"
# Gradients card against CPU, as a share of the net's largest gradient:
# the LT rollout and ReLU masks carry B's 3xTF32 rounding into them (on
# an H100 1.3e-6 for the tower, 1.3e-4 for ScaleNet; a per-tensor share is
# noise for the output layer's bias, whose gradient is 0 up to rounding:
# the loss sees the pressure through its differences only).
GRAD_TOL = 1e-3


def train_counters():
    """{key: wrapper} of the kernels a training step launches: B's
    forward, the input gradient, the weight gradient, the polish adjoint,
    E and F."""
    from fluidnet_cxx_tpu_torch.ops.kernels import (advect, conv_grad, jacobi,
                                                    punet)
    return {"B": punet.conv2d_nhwc, "dgrad": conv_grad.conv2d_dgrad,
            "wgrad": conv_grad.conv2d_wgrad,
            "F adjoint": jacobi.jacobi_adjoint,
            "E": advect.advect_velocity, "F": jacobi.solve_jacobi}


def train_cfg(model):
    """The ModelConfig that phase 8 trains ``model`` with."""
    from fluidnet_cxx_tpu_torch.config import ModelConfig

    return ModelConfig(model=model, **TRAIN_CFG.get(model, {}))


def seeded_net(model, dev, seed=1):
    """The 2-D net of ``model`` with flax's initialisation from ``seed``."""
    from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                       random_flax_params)
    from fluidnet_cxx_tpu_torch.models.fluidnet import make_net

    net = make_net(train_cfg(model))
    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table,
                                                              seed)))
    return net.to(dev)


def train_input(model, dev, bsz=TRAIN_BSZ, res=TRAIN_RES):
    """The net's assembled input on a synthetic batch drawn on the card, as
    the on-device path draws it (600-sweep labels)."""
    from fluidnet_cxx_tpu_torch.data.synthetic import generate_batch
    from fluidnet_cxx_tpu_torch.models.fluidnet import assemble_inputs

    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        b = generate_batch(gen, bsz, res, res, 600, dev)
        return assemble_inputs(train_cfg(model), b.p_div, b.U_div,
                               b.flags, b.density_div)[0]


def fixed_wgrad_plan(n, ho, wo, ci, co, k):
    """The wgrad plan of one fixed choice per output-channel class (the
    planner's wn columns of m16n8 tiles a warp, from co) for the planner's
    to beat: 16-channel slices, 2 m-tiles a warp (4 where it has one
    n-tile), 4 warps a block; the strides, chunk tile and splits the
    planner's own for that choice."""
    from fluidnet_cxx_tpu_torch.ops.kernels import conv_grad

    p = conv_grad.plan_wgrad(n, ho, wo, ci, co, k)
    return conv_grad.plan_wgrad(n, ho, wo, ci, co, k, cw=16,
                                wm=4 if p.wn == 1 else 2,
                                nwr=max(1, 4 // p.nwc))


def plan_text(p):
    return (f"cw {p.cw} warp {p.wm}x{p.wn} warps {p.nwr}x{p.nwc} tw {p.tw} "
            f"S {p.splits}")


def dgrad_layer(label, key, gy, w, conv, ci, co, stride, dil, hw, hp, gyn,
                lo):
    """The input gradient fn_conv2d_dgrad of one conv call on its real
    channels (ci, co), on every route whose planner takes the layer (its
    own pick among them), each held to cuDNN's conv2d_input on the
    unpadded weight (``hp``, ``gyn``: the SAME-padded input's shape and
    dy, NCHW) within 1e-5 of its largest value and to the plain version,
    its padded channels exactly 0, bit-equal on a repeat, timed (device
    ms). Returns the row's fields: the planned route's error and ms, each
    route's ms, the plan's route, the plain version's and cuDNN's ms, the
    parent's ms (DGRAD_STEP0_MS) and, at stride 2, the class tables' tap
    counts."""
    from fluidnet_cxx_tpu_torch.ops.kernels import conv_grad

    n = gy.shape[0]
    (hh, ww), k = hw, w.shape[0]

    def lib():
        return torch.nn.grad.conv2d_input(
            hp.shape, conv.weight, gyn, stride=stride,
            dilation=dil)[:, :, lo:lo + hh, lo:lo + ww]

    def plain():
        return conv_grad.conv2d_dgrad_plain(gy, w, dil, stride, hw, ci, co)

    want = lib().permute(0, 2, 3, 1)
    tol = 1e-5 * float(want.abs().max())
    plan = conv_grad.plan_dgrad(n, hh, ww, ci, co, k, stride, dil)
    row = dict(route=conv_grad.ROUTES[plan.route],
               d_parent_ms=DGRAD_STEP0_MS.get(key, float("nan")),
               taps=[len(c.taps) for c in conv_grad.dgrad_classes(
                   hh, ww, k, stride, dil)])
    for route, name in conv_grad.ROUTES.items():
        try:
            p = conv_grad.plan_dgrad(n, hh, ww, ci, co, k, stride, dil,
                                     route)
        except ValueError:  # the route does not take this layer
            continue

        def fn(p=p):
            return conv_grad.conv2d_dgrad(gy, w, dil, stride, hw, ci, co, p)

        got = fn()
        torch.cuda.synchronize()
        if bool(got[..., ci:].any()):
            raise SystemExit(f"dgrad {label} ({name}): a padded input "
                             "channel is not 0")
        err = max_err([got[..., :ci]], [want])
        check(f"dgrad {label} ({name}, kc {p.kc}, bn {p.bn}, S {p.splits})",
              err, tol)
        check(f"dgrad {label} ({name}) against its plain version",
              max_err([got], [plain()]), tol)
        del got
        check_repeat(f"dgrad {label} ({name})", fn)
        row[f"d_{name}_ms"] = graph_ms(fn)
        if route == plan.route:
            row["d_err"], row["d_ms"] = err, row[f"d_{name}_ms"]
    row["d_plain_ms"] = graph_ms(plain)
    row["d_lib_ms"] = graph_ms(lib)
    return row


def grad_layer_rows(model, net, x, dev, with_wgrad=True):
    """The input gradient fn_conv2d_dgrad (a skip concat's over [up |
    skip]; dgrad_layer, skipped for the first layer, whose input needs no
    gradient) and, ``with_wgrad``, fn_conv2d_wgrad on each conv call of
    ``net``'s padded forward on ``x``, from a seeded upstream gradient
    (zero on the padded output channels): wgrad over the layer's real
    channels, within twice the plain float32 version's distance from its
    float64 run, its padded entries exactly 0, bit-equal on a repeat; the
    same tolerance under fixed_wgrad_plan's plan. Returns per-layer dicts
    of errors, device ms of the kernels (dgrad's on each route it has,
    beside the parent's; wgrad's under its planner's plan and under the
    fixed one), the plain versions and cuDNN, the plans, and the unpadded
    work."""
    from fluidnet_cxx_tpu_torch.ops.kernels import conv_grad, punet

    F = torch.nn.functional
    with torch.no_grad():
        packed = punet.pack_weights(net)

    def run(hook):
        def conv(name, h, x2=None, relu=True, in_scale=None, scale_mod=1):
            w, b = packed[name]
            _, stride, dil = net.geometry[name]
            return hook(name, (h, w, b, stride, dil, relu, x2), {})
        return net(x, conv=conv, width=punet.STAGE)

    with torch.no_grad():
        calls = record_layers(run, punet.conv2d_nhwc)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rows = []
    first = calls[0][0]
    print(f"backward per layer, {model} at {x.shape[1]}^2, batch "
          f"{x.shape[0]} (M; device ms: dgrad kernel on its planned route / "
          "plain / cuDNN, then each route's ms, the parent's ms and at "
          "stride 2 the classes' tap counts; wgrad kernel / plain / cuDNN, "
          "its bound on the unpadded work at the 3xTF32 rate, its error "
          "from float64 beside the plain float32's, its plan; the fixed "
          "plan's ms and plan):", flush=True)
    for name, (h, w, _, stride, dil, _, x2), _ in calls:
        if x2 is not None:
            h = torch.cat([h, x2], dim=-1)
        c = net.convs[name]
        co, ci, k, _ = c.weight.shape
        n, hh, ww = h.shape[:3]
        ho, wo = -(-hh // stride), -(-ww // stride)
        m = n * ho * wo
        pads = punet.same_pads(hh, k, stride, dil)
        gy = torch.randn((n, ho, wo, w.shape[3]), generator=gen, device=dev)
        gy[..., co:] = 0
        gyn = gy[..., :co].permute(0, 3, 1, 2).contiguous()
        hn = h[..., :ci].permute(0, 3, 1, 2).contiguous()
        # cuDNN's calls on the input padded by flax's SAME pads (the
        # stride-2 downs pad (0, 1), which their padding argument cannot
        # say); the cut back is a view.
        hp = F.pad(hn, (pads[0], pads[1], pads[0], pads[1]))
        label = f"{model} {name} {hh}x{ww} k{k} s{stride} {ci}->{co}"
        fixed = fixed_wgrad_plan(n, ho, wo, ci, co, k)
        row = dict(name=name, m=m, k=k, ci=ci, co=co, stride=stride,
                   ops=2.0 * m * k * k * ci * co,
                   d_bytes=4.0 * (m * co + c.weight.numel() + n * hh * ww
                                  * ci),
                   w_bytes=4.0 * (n * hh * ww * ci + m * co
                                  + c.weight.numel() + co),
                   plan=plan_text(conv_grad.plan_wgrad(n, ho, wo, ci, co, k,
                                                       stride, dil)),
                   fixed_plan=plan_text(fixed))
        with torch.no_grad():
            if name != first:
                row.update(dgrad_layer(
                    label, f"{model} {name} {hh}x{ww}", gy, w, c, ci, co,
                    stride, dil, (hh, ww), hp, gyn, pads[0]))

            if not with_wgrad:
                rows.append(row)
                print(f"  {name:16s} k{k} s{stride} {ci:3d}->{co:3d} M "
                      f"{m:8d}  {dgrad_text(row)}", flush=True)
                continue

            def flat(pair):
                return torch.cat([t.flatten() for t in pair])

            def wgrad(h=h, gy=gy, k=k, s=stride, dil=dil, pads=pads, ci=ci,
                      co=co, plan=None):
                return flat(conv_grad.conv2d_wgrad(h, gy, k, s, dil, pads,
                                                   ci, co, plan))

            def plain(h=h, gy=gy, k=k, s=stride, dil=dil, pads=pads, ci=ci,
                      co=co):
                return flat(conv_grad.conv2d_wgrad_plain(h, gy, k, s, dil,
                                                         pads, ci, co))

            exact = flat(conv_grad.conv2d_wgrad_plain(
                h.double(), gy.double(), k, stride, dil, pads, ci, co))
            got, ref = wgrad(), plain()
            got_fixed = (wgrad(plan=fixed) if stride == 1 else None)
            dw, db = conv_grad.conv2d_wgrad(h, gy, k, stride, dil, pads, ci,
                                            co)
            torch.cuda.synchronize()
            if bool(dw[:, :, ci:].any() or dw[..., co:].any()
                    or db[co:].any()):
                raise SystemExit(f"wgrad {label}: a padded entry is not 0")
            row["w_err"] = float((got.double() - exact).abs().max())
            row["w_plain_err"] = float((ref.double() - exact).abs().max())
            row["w_err_plain"] = float((got - ref).abs().max())
            check(f"wgrad {label} (from float64; tolerance twice the plain "
                  f"float32's {row['w_plain_err']:.3e})", row["w_err"],
                  2 * row["w_plain_err"])
            if got_fixed is not None:
                check(f"wgrad {label} under the fixed plan (from float64)",
                      float((got_fixed.double() - exact).abs().max()),
                      2 * row["w_plain_err"])
            del got, got_fixed, ref, exact, dw, db
            check_repeat(f"wgrad {label}", wgrad)
            row["w_ms"] = graph_ms(wgrad)
            row["w_fixed_ms"] = (graph_ms(
                lambda wgrad=wgrad, fixed=fixed: wgrad(plan=fixed))
                if stride == 1 else float("nan"))
            row["w_plain_ms"] = graph_ms(plain)
            row["w_lib_ms"] = graph_ms(
                lambda hp=hp, c=c, gyn=gyn, s=stride, dil=dil:
                torch.nn.grad.conv2d_weight(hp, c.weight.shape, gyn,
                                            stride=s, dilation=dil))
        rows.append(row)
        r = row
        print(f"  {r['name']:16s} k{r['k']} s{r['stride']} {r['ci']:3d}->"
              f"{r['co']:3d} M {r['m']:8d}  {dgrad_text(r)}  wgrad "
              f"{r['w_ms']:.4f} / "
              f"{r['w_plain_ms']:.4f} / {r['w_lib_ms']:.4f}  bound "
              f"{bound(r['w_bytes'], r['ops'], TF32X3_OPS_PER_S)[0]:.4f}  "
              f"err {r['w_err']:.2e} (plain {r['w_plain_err']:.2e})  "
              f"[{r['plan']}]  fixed {r['w_fixed_ms']:.4f} "
              f"[{r['fixed_plan']}]", flush=True)
    return rows


def dgrad_text(r):
    """One layer's input-gradient figures as grad_layer_rows prints them."""
    from fluidnet_cxx_tpu_torch.ops.kernels import conv_grad

    if "d_ms" not in r:
        return "dgrad skipped"
    routes = ", ".join(f"{k[2:-3]} {v:.4f}" for k, v in r.items()
                       if k.startswith("d_") and k.endswith("_ms")
                       and k[2:-3] in conv_grad.ROUTES.values())
    taps = f" class taps {r['taps']}" if r["stride"] == 2 else ""
    return (f"dgrad {r['route']} {r['d_ms']:.4f} / {r['d_plain_ms']:.4f} / "
            f"{r['d_lib_ms']:.4f} ({routes}; parent "
            f"{r['d_parent_ms']:.4f}){taps}")


def route_sums(rs):
    """The input gradient's sums over the layers that more than one route
    takes: each route's (over the layers it takes), the planned routes',
    the fastest routes'."""
    from fluidnet_cxx_tpu_torch.ops.kernels import conv_grad

    keys = [f"d_{n}_ms" for n in conv_grad.ROUTES.values()]
    multi = [r for r in rs if sum(k in r for k in keys) > 1]
    if not multi:
        return "one route a layer"
    each = ", ".join(
        f"{k[2:-3]} {sum(r[k] for r in multi if k in r):.4f} "
        f"({sum(k in r for r in multi)})" for k in keys
        if any(k in r for r in multi))
    return (f"the {len(multi)} layers with more than one route: {each}; "
            f"planned {sum(r['d_ms'] for r in multi):.4f}, fastest "
            f"{sum(min(r[k] for k in keys if k in r) for r in multi):.4f}")


def backward_results(rows, model="FluidNet"):
    """The kernels-line entries of the input gradient and the weight
    gradient over one backward of ``model`` (every layer's call summed),
    and the input gradient's stride-2 calls alone (where the net has
    such layers); the input gradient's sums beside the parent's and
    route_sums'."""
    out = {}
    for key, p, keep in (("dgrad", "d", lambda r: True),
                         ("dgrad s2", "d", lambda r: r["stride"] == 2),
                         ("wgrad", "w", lambda r: True)):
        rs = [r for r in rows if f"{p}_ms" in r and keep(r)]
        if not rs:
            continue
        ms, by = bound(sum(r[f"{p}_bytes"] for r in rs),
                       sum(r["ops"] for r in rs), TF32X3_OPS_PER_S)
        out[key] = dict(err=max(r[f"{p}_err"] for r in rs),
                        ms=sum(r[f"{p}_ms"] for r in rs),
                        plain_ms=sum(r[f"{p}_plain_ms"] for r in rs),
                        library_ms=sum(r[f"{p}_lib_ms"] for r in rs),
                        bound_ms=ms, bound_by=by)
        s1 = [r for r in rs if r["stride"] == 1]
        fixed = (f"; under the fixed plans (stride 1) "
                 f"{sum(r['w_fixed_ms'] for r in s1):.4f}" if p == "w" else
                 f"; the parent {sum(r['d_parent_ms'] for r in rs):.4f}; "
                 + route_sums(rs))
        print(f"{key}, one {model} backward ({len(rs)} calls): kernel "
              f"{out[key]['ms']:.4f} ms device, plain "
              f"{out[key]['plain_ms']:.4f}, cuDNN {out[key]['library_ms']:.4f}"
              f", bound {ms:.4f} ({by}, 3xTF32), max_abs_err "
              f"{out[key]['err']:.3e}{fixed}", flush=True)
    return out


def rel_err(got, want, names):
    """(the largest share of a tensor's largest value by which ``got``
    misses ``want``, that tensor's name; the largest difference over all
    the tensors as a share of the largest value among them)."""
    per = [float((g.double() - w.double()).abs().max())
           / max(float(w.abs().max()), 1e-30) for g, w in zip(got, want)]
    i = max(range(len(per)), key=per.__getitem__)
    whole = (max(float((g.double() - w.double()).abs().max())
                 for g, w in zip(got, want))
             / max(float(w.abs().max()) for w in want))
    return per[i], names[i], whole


def check_net_backward(model, dev, bsz=16):
    """The net's forward and backward together: the kernel route (weights
    packed while autograd records, B, B's input gradient, wgrad) against
    plain autograd through F.conv2d (TF32 off) on the card, and both
    against plain autograd in float64: the kernel route's gradients no
    further from the float64 ones than twice the plain float32 route's (as
    a share of the net's largest gradient: ReLU masks flip where a
    pre-activation is within rounding of 0, which moves both float32
    routes by up to 2.8e-3 on ScaleNet); both routes timed."""
    import copy

    from fluidnet_cxx_tpu_torch.ops.kernels import punet

    net = seeded_net(model, dev)
    net64 = copy.deepcopy(net).double()
    x = train_input(model, dev, bsz)
    up = torch.randn(x.shape[:3] + (1,), generator=torch.Generator(
        device=dev).manual_seed(SEED + 3), device=dev)
    params = list(net.parameters())

    def kernel_route():
        out = punet.net_forward(net, punet.pack_weights(net), x)
        return torch.autograd.grad((out * up).sum(), params)

    def plain_route():
        return torch.autograd.grad((net(x) * up).sum(), params)

    got, want = kernel_route(), plain_route()
    exact = torch.autograd.grad((net64(x.double()) * up.double()).sum(),
                                list(net64.parameters()))
    torch.cuda.synchronize()
    names = [n for n, _ in net.named_parameters()]
    k_plain, k_exact, p_exact = (rel_err(got, want, names),
                                 rel_err(got, exact, names),
                                 rel_err(want, exact, names))
    k_ms, p_ms = cuda_ms(kernel_route, 5), cuda_ms(plain_route, 5)
    print(f"{model} forward+backward at {x.shape[1]}^2, batch {bsz}: "
          "gradients' largest difference as a share of the net's largest "
          f"gradient (and of its own tensor's, worst tensor): kernel route "
          f"to plain float32 {k_plain[2]:.3e} ({k_plain[0]:.3e}, "
          f"{k_plain[1]}), kernel route to float64 {k_exact[2]:.3e} "
          f"({k_exact[0]:.3e}, {k_exact[1]}), plain float32 to float64 "
          f"{p_exact[2]:.3e} ({p_exact[0]:.3e}, {p_exact[1]}); kernel route "
          f"{k_ms:.3f} ms, plain autograd (cuDNN) {p_ms:.3f} ms", flush=True)
    check(f"{model} forward+backward, kernel route to float64 (share of "
          "the net's largest gradient; tolerance twice the plain float32 "
          "route's)", k_exact[2], 2 * p_exact[2])


def check_loss_card_vs_cpu(model, dev):
    """One loss and its gradient at 64^2, batch 4, LT on with a fixed draw
    of 4 steps, on the card (kernels) against the CPU (plain versions):
    each term within 1e-4 of its value, the gradients within GRAD_TOL of
    the net's largest gradient."""
    from fluidnet_cxx_tpu_torch.config import SimConfig, TrainConfig
    from fluidnet_cxx_tpu_torch.data.synthetic import generate_batch
    from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_cxx_tpu_torch.train.trainer import (Batch, _sample_dyn,
                                                      make_loss_fn)

    tc, sc = TrainConfig(batch_size=4), SimConfig()
    with torch.no_grad():
        batch = Batch(*generate_batch(torch.Generator().manual_seed(SEED), 4,
                                      64, 64, 200, "cpu"))
    dyn, _ = _sample_dyn(torch.Generator().manual_seed(SEED), sc, tc)
    out = {}
    for d in (dev, "cpu"):
        net = seeded_net(model, d)
        loss_fn = make_loss_fn(FluidNet(train_cfg(model), net), sc, tc)
        b = Batch(*(t.to(d) for t in batch[:7]))
        total, terms = loss_fn(b, draw=(dyn, 4))
        total.backward()
        out[d] = ([t.detach().cpu() for t in terms],
                  [p.grad.cpu() for p in net.parameters()])
    (gt, gg), (ct, cg) = out[dev], out["cpu"]
    for name, g, c in zip(("total", "p_l2", "div_l2", "p_l1", "div_l1",
                           "div_lt"), gt, ct):
        check(f"{model} loss card vs CPU, {name} {float(c):.6f}",
              max_err([g], [c]), 1e-4 * scale_of([c]))
    names = [n for n, _ in seeded_net(model, "cpu").named_parameters()]
    per, name, whole = rel_err(gg, cg, names)
    print(f"{model} gradients card vs CPU: worst tensor {name} {per:.3e} of "
          "its own largest value", flush=True)
    check(f"{model} gradients card vs CPU (largest difference as a share "
          "of the net's largest gradient)", whole, GRAD_TOL)


def train_main_path(model, dev):
    """make_on_device_train_step with TrainConfig() (configs/train.yaml:
    batch 64, LT on) on ``model`` at 128^2, 600 label sweeps: one warm-up
    step, then the counters set to 0 and TRAIN_STEPS - 1 steps timed with
    CUDA events; finite loss terms, peak memory, launches per step (B's
    forward, its input gradients, wgrad, the polish adjoint, E, F; the
    backward's held to TRAIN_BACKWARD, B's forward to the rollout's
    length), then a profiler window of one more step. Returns the
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from fluidnet_cxx_tpu_torch.config import SimConfig, TrainConfig
    from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_cxx_tpu_torch.train.trainer import (
        init_train_state, make_on_device_train_step)

    name = (f"train {model} {TRAIN_RES}^2 batch {TRAIN_BSZ}, "
            f"{TRAIN_STEPS[model]} steps")
    done = phase(f"main path ({name})")
    tc, sc = TrainConfig(), SimConfig()
    fnet = FluidNet(train_cfg(model)).to(dev)
    ts = init_train_state(fnet, tc, seed=0, steps_per_epoch=50)
    step = make_on_device_train_step(fnet, sc, tc, TRAIN_RES, TRAIN_RES,
                                     tc.batch_size, 600, dev)
    gen = torch.Generator(device=dev).manual_seed(4321)
    host_gen = torch.Generator().manual_seed(4321)
    ts, _ = step(ts, gen, host_gen)
    torch.cuda.synchronize()
    counters = train_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    n = TRAIN_STEPS[model] - 1
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    terms = [step(ts, gen, host_gen)[1] for _ in range(n)]
    e1.record()
    e1.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    ms = e0.elapsed_time(e1) / n
    vals = torch.stack([torch.stack(list(t)) for t in terms]).cpu()
    if not bool(torch.isfinite(vals).all()):
        raise SystemExit(f"{name}: a loss term is not finite: {vals}")
    per = TRAIN_BACKWARD[model]
    missed = [k for k, v in launches.items() if v < 1 and per.get(k, 1)]
    if missed:
        raise SystemExit(f"{name} missed kernels {missed}: {launches}")
    if any(launches[k] != v * n for k, v in per.items()):
        raise SystemExit(f"{name}: backward launches {launches}, not "
                         f"{per} a step")
    convs = per["wgrad"] // 2   # conv calls a forward
    if launches["B"] != convs * (2 * n + launches["E"]):
        raise SystemExit(f"{name}: B launched {launches['B']} times, not "
                         f"{convs} a forward over 2 a step and one a "
                         f"rollout step ({launches['E']})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{name}: ms/step {ms:.2f} ({n} steps after one warm-up), peak "
          f"memory {peak:.2f} GiB, launches {launches} (per step "
          f"{ {k: v / n for k, v in launches.items()} }; rollout steps "
          f"{launches['E']})", flush=True)
    print(f"{name}: loss terms per step (total, pL2, divL2, pL1, divL1, "
          f"divLT): {[[round(v, 5) for v in row] for row in vals.tolist()]}",
          flush=True)
    done()
    done = phase(f"profile ({name}, 1 step)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(ts, gen, host_gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    print_profile(name, prof, 1, wall_ms)
    done()
    return launches


def train_small_paths():
    """The dataset path (--synthetic scenes at 128^2, one epoch with
    validation and a checkpoint, then a resume for a second epoch whose
    step count continues the first's) and --plumeFrames (16 frames, 5
    mixed steps), through the training entry point's main, in a
    directory under build/ that is removed after."""
    import shutil
    from pathlib import Path

    import numpy as np

    from fluidnet_cxx_tpu_torch.train.__main__ import main as train_main

    work = Path(__file__).resolve().parent / "build" / "train_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        done = phase("train dataset path (--synthetic 8 at 128^2, bsz 16)")
        ds = work / "ds"
        common = ["--res", str(TRAIN_RES), "--bsz", "16", "--modelDir",
                  str(ds)]
        train_main(["--synthetic", "8", "--maxEpochs", "1"] + common)
        state = ds / "last_epoch" / "train_state.pt"
        s1 = torch.load(state, weights_only=True)["step"]
        train_main(["--maxEpochs", "2", "--resume"] + common)
        s2 = torch.load(state, weights_only=True)["step"]
        rows = np.load(ds / "val_loss.npy")
        if s1 < 1 or s2 != 2 * s1 or rows.shape != (2, 7) or \
                not np.isfinite(rows).all():
            raise SystemExit(f"dataset path: steps {s1}, {s2}, val rows "
                             f"{rows}")
        print(f"dataset path: {s1} steps an epoch, the resume continued "
              f"to step {s2}; val rows {rows.tolist()}", flush=True)
        done()
        done = phase("train --plumeFrames 16, 5 mixed steps at 128^2")
        pl = work / "plume"
        train_main(["--onDevice", "5", "--plumeFrames", "16", "--res",
                    str(TRAIN_RES), "--bsz", "16", "--modelDir", str(pl)])
        rows = np.load(pl / "train_loss.npy")
        if rows.shape != (1, 7) or not np.isfinite(rows).all():
            raise SystemExit(f"--plumeFrames: loss rows {rows}")
        done()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check_polish_adjoint(dev, results):
    """The polish adjoint (fn_jacobi_adjoint) bit for bit against its plain
    version: 32 damped sweeps and 9 undamped on the 512^2 stress flags
    with an open top row, and 32 damped on a training batch's flags at
    128^2, batch 64 (the main path's shape), timed there beside its plain
    version and its bound (12 bytes a cell; ~14 operations a cell a
    sweep); no PyTorch call computes it."""
    from fluidnet_cxx_tpu_torch.data.synthetic import generate_batch
    from fluidnet_cxx_tpu_torch.ops.kernels import jacobi

    gen = torch.Generator().manual_seed(SEED + 11)
    flags, _, _ = stress_inputs(gen, dev, RES)
    flags = flags.clone()
    flags[:, -1, 1:-1] = 4
    with torch.no_grad():
        b = generate_batch(torch.Generator(device=dev).manual_seed(SEED),
                           TRAIN_BSZ, TRAIN_RES, TRAIN_RES, 20, dev)
    cases = {f"{RES}^2 stress, 32 damped": (flags, 32, 2.0 / 3.0),
             f"{RES}^2 stress, 9 undamped": (flags, 9, 1.0),
             f"{TRAIN_RES}^2 batch {TRAIN_BSZ}, 32 damped": (b.flags, 32,
                                                          2.0 / 3.0)}
    for name, (f, it, w) in cases.items():
        g = torch.randn(f.shape, generator=gen).to(dev)
        run = lambda f=f, g=g, it=it, w=w: jacobi.jacobi_adjoint(f, g, it, w)
        got = run()
        torch.cuda.synchronize()
        err = max_err([got], [jacobi.jacobi_adjoint_fixed(f, g, it, w)])
        check(f"F adjoint {name}", err, 0.0)
        check_repeat(f"F adjoint {name}", run)
    ms, eager_ms = device_and_eager(run)
    plain_ms = cuda_ms(lambda: jacobi.jacobi_adjoint_fixed(f, g, it, w), 3,
                       warmup=1)
    n = f.numel()
    b_ms, b_by = bound(12 * n, 14.0 * it * n)
    results["F adjoint"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=None)
    print(f"F adjoint ({TRAIN_RES}^2, batch {TRAIN_BSZ}, 32 sweeps): kernel "
          f"{ms:.4f} ms device (eager {eager_ms:.4f}), plain {plain_ms:.3f} "
          f"ms, bound {b_ms:.4f} ms ({b_by}), launches a call "
          f"{launches_of(jacobi.jacobi_adjoint, run)}", flush=True)


def phase_train(dev, results):
    """Training: the backward kernels on every conv call of the tower, of
    ScaleNet and of PUNetD2_128's architecture at 128^2, batch 64; the
    polish adjoint; the nets' forward and backward against plain
    autograd; one loss card against CPU; the three main paths; the
    dataset and plume-frame paths. Returns each main path's launches."""
    done = phase("backward kernels (dgrad, wgrad) at 128^2, batch 64")
    tower = seeded_net("FluidNet", dev)
    rows = grad_layer_rows("FluidNet", tower, train_input("FluidNet", dev),
                           dev)
    results.update(backward_results(rows))
    del tower
    scale = seeded_net("ScaleNet", dev)
    rows = grad_layer_rows("ScaleNet", scale, train_input("ScaleNet", dev),
                           dev)
    results.update({f"{k} scalenet": v for k, v in
                    backward_results(rows, "ScaleNet").items()})
    del scale, rows
    net = seeded_net("PUNet", dev)
    rows = grad_layer_rows("PUNet", net, train_input("PUNet", dev), dev)
    results.update({f"{k} punet": v for k, v in
                    backward_results(rows, "PUNet").items()})
    del net, rows
    torch.cuda.empty_cache()
    done()
    done = phase("polish adjoint (fn_jacobi_adjoint)")
    check_polish_adjoint(dev, results)
    done()
    done = phase("nets forward+backward, kernel route vs plain autograd")
    for model in TRAIN_MODELS.values():
        check_net_backward(model, dev)
    done()
    done = phase("one loss and its gradient, card vs CPU (64^2, batch 4)")
    for model in TRAIN_MODELS.values():
        check_loss_card_vs_cpu(model, dev)
    done()
    launches = {m: train_main_path(m, dev) for m in TRAIN_MODELS.values()}
    train_small_paths()
    return launches


def train_rows(results, launches):
    """The kernels-line rows of the backward kernels: launches from the
    tower's training main path (ScaleNet's and PUNet's rows from their
    own)."""
    meta = {"dgrad": ("conv2d_dgrad_tower_128_b64",
                      "fluidnet_cxx_tpu_torch/csrc/conv2d_dgrad.cu",
                      TRAIN_REPLACES, "FluidNet", "dgrad"),
            "dgrad scalenet": ("conv2d_dgrad_scalenet_128_b64",
                               "fluidnet_cxx_tpu_torch/csrc/conv2d_dgrad.cu",
                               TRAIN_REPLACES, "ScaleNet", "dgrad"),
            "dgrad punet": ("conv2d_dgrad_punet_128_b64",
                            "fluidnet_cxx_tpu_torch/csrc/conv2d_dgrad.cu",
                            TRAIN_REPLACES, "PUNet", "dgrad"),
            "F adjoint": ("jacobi_adjoint_punet_128_b64",
                          "fluidnet_cxx_tpu_torch/csrc/jacobi.cu",
                          "fluidnet_cxx_tpu/ops/jacobi.py:56", "PUNet",
                          "F adjoint"),
            "wgrad": ("conv2d_wgrad_tower_128_b64",
                      "fluidnet_cxx_tpu_torch/csrc/conv2d_grad.cu",
                      TRAIN_REPLACES, "FluidNet", "wgrad"),
            "wgrad scalenet": ("conv2d_wgrad_scalenet_128_b64",
                               "fluidnet_cxx_tpu_torch/csrc/conv2d_grad.cu",
                               TRAIN_REPLACES, "ScaleNet", "wgrad")}
    out = []
    for key, (name, source, replaces, model, counter) in meta.items():
        r = results[key]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": launches[model][counter],
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    return out


# 3-D training (ROADMAP A.5.2: scripts/train3d.py's twin). The main paths:
# label -> (res, patch, polish sweeps, --plumeFrames, steps); train3d.py's
# model (PUNet3 widths 96/128, bfloat16, the "xla" polish), batch 4, 400
# label sweeps, lr 2e-4.
TRAIN3D_BSZ, TRAIN3D_LABEL_ITERS, TRAIN3D_LR = 4, 400, 2e-4
TRAIN3D_PATHS = {"train3d 32^3 p4": (32, 4, 8, 0, 50),
                 "train3d 64^3 p8": (64, 8, 16, 0, 20),
                 "train3d 32^3 p4 --plumeFrames 8": (32, 4, 8, 8, 20)}
TRAIN3D_NETS = {"p4": (32, 4, 8), "p8": (64, 8, 16)}
# What the new kernels stand in for: the jax.value_and_grad of
# train3d.py's loss (XLA's backward of flax nn.Conv) and of JAX's damped
# polish (ops3d.solve_jacobi_fixed3).
TRAIN3D_REPLACES = "scripts/train3d.py:116"
ADJOINT3_REPLACES = "fluidnet_cxx_tpu/ops/ops3d.py:216"
# A bfloat16 train step on the card against the port's plain step on the
# CPU (same weights and batch): the loss within 1e-3 of its value, each
# parameter gradient within 5e-2 of its tensor's norm (relative L2). The
# two forwards sum in other orders, so a few bf16 outputs round the other
# way and a pre-activation that rounds to 0 on one side flips a ReLU mask,
# which moves a whole output channel's weight gradient (the port's CPU
# step against JAX's: loss 1e-6, gradients 1e-2-2.6e-2 relative L2,
# tests/test_torch_train3d.py).
TRAIN3D_LOSS_TOL, TRAIN3D_GRAD_TOL = 1e-3, 5e-2


def train3d_counters():
    """{key: wrapper} of the kernels a 3-D train step launches: N (and its
    flax route), the input and weight gradients, I (labels, polish; the
    frames' Jacobi-200), I's adjoint and L (the frames' advection)."""
    from fluidnet_cxx_tpu_torch.ops.kernels import (advect3, conv_grad3,
                                                    jacobi3, punet3)
    return {"N": punet3.conv3d_ndhwc, "Nf": punet3.flax_route,
            "dgrad3": conv_grad3.conv3d_dgrad,
            "wgrad3": conv_grad3.conv3d_wgrad, "I": jacobi3.solve_jacobi3,
            "I adjoint": jacobi3.jacobi3_adjoint, "L": advect3.advect_all3}


def train3d_model(res, patch, sweeps, dev, seed=0):
    """train3d.py's FluidNet3 (patch, polish sweeps) with flax's
    initialisation from ``seed``, on ``dev``."""
    from fluidnet_cxx_tpu_torch.models.punet3d import FluidNet3, init_params3
    from fluidnet_cxx_tpu_torch.scripts import train3d

    args = train3d.parse_args(["--res", str(res), "--patch", str(patch),
                               "--polishSweeps", str(sweeps)])
    return init_params3(FluidNet3(train3d.model_config(args)), seed).to(dev)


def record_grad3_layers(model, res, dev):
    """Each conv call of one forward and backward of ``model``'s PUNet3 on
    a synthetic batch at res^3, batch 4 (the kernel route): (name, x, x2,
    packed weight and bias, stride, relu, the forward's output, the
    output's gradient from a random upstream gradient at the net's
    output)."""
    from fluidnet_cxx_tpu_torch.data.synthetic3 import generate_batch3
    from fluidnet_cxx_tpu_torch.models.punet3d import _scale4
    from fluidnet_cxx_tpu_torch.ops.kernels import punet3
    from fluidnet_cxx_tpu_torch.ops.ops3d import velocity_divergence3
    from fluidnet_cxx_tpu_torch.ops.stencils import flags_to_occupancy

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    with torch.no_grad():
        U, flags, _, _ = generate_batch3(gen, TRAIN3D_BSZ, res, res, res, 60,
                                         dev)
        div = velocity_divergence3(U, flags)
        s4 = _scale4(model.cfg, div, U, div)
        x = torch.stack([div / s4, flags_to_occupancy(flags)], dim=-1)
    net = model.net
    packed = punet3.pack_weights3(net)
    calls, grads = [], {}

    def conv(name, h, x2=None, relu=True):
        w, b = packed[name]
        y = punet3.conv3d_ndhwc_autograd(h, w, b, net.strides[name], relu,
                                         x2, net.out_dtype(relu), True)
        y.register_hook(lambda g, name=name: grads.__setitem__(name, g))
        calls.append((name, h.detach(), None if x2 is None else x2.detach(),
                      w.detach(), b.detach(), net.strides[name], relu,
                      y.detach()))
        return y

    out = net(x, conv=conv)
    up = torch.randn(out.shape, generator=gen, device=dev)
    (out * up).sum().backward()
    return [c + (grads[c[0]],) for c in calls]


def dyadic3(gen, shape, num, den, dev):
    """Values k / den, |k| <= num, in bfloat16: every product and partial
    sum of the gradients below is exact in float32."""
    return (torch.randint(-num, num + 1, shape, generator=gen, device=dev)
            .float() / den).to(torch.bfloat16)


def cudnn_grad3(x, w_dhwio, gy, stride):
    """(input gradient, weight gradient) of one layer by cuDNN's
    ``conv3d_input`` / ``conv3d_weight`` in bfloat16 (channels_last_3d)
    on the SAME-padded input, as closures: the library yardstick."""
    from fluidnet_cxx_tpu_torch.ops.kernels.conv_grad3 import same_pads

    k = w_dhwio.shape[0]
    pads = [same_pads(s, k, stride, 1) for s in x.shape[1:4]]
    padded = [s + lo + hi for s, (lo, hi) in zip(x.shape[1:4], pads)]
    cl = torch.channels_last_3d
    w = w_dhwio.permute(4, 3, 0, 1, 2).contiguous(memory_format=cl)
    g = gy.permute(0, 4, 1, 2, 3).contiguous(memory_format=cl)
    (d0, d1), (h0, h1), (w0, w1) = pads
    xn = torch.nn.functional.pad(x.permute(0, 4, 1, 2, 3),
                                 (w0, w1, h0, h1, d0, d1)).contiguous(
                                     memory_format=cl)
    size = (x.shape[0], x.shape[-1], *padded)

    def dgrad():
        return torch.nn.grad.conv3d_input(size, w, g, stride=stride)

    def wgrad():
        return torch.nn.grad.conv3d_weight(xn, tuple(w.shape), g,
                                           stride=stride)
    return dgrad, wgrad


def grad3_work(x, co, k, stride, so):
    """(dgrad bytes, dgrad operations, wgrad bytes, wgrad operations) of
    one layer: bf16 operands and outputs (db float32), each read or
    written once; 2 operations a multiply-add, the taps of each dx cell's
    parity class only."""
    from fluidnet_cxx_tpu_torch.ops.kernels.conv_grad3 import dgrad_classes3

    n, ci = x.shape[0], x.shape[-1]
    cells_in, cells_out = x[..., 0].numel(), n * so ** 3
    macs = sum(n * dq * hq * wq * len(t)
               for _, (dq, hq, wq), t in dgrad_classes3(
                   tuple(x.shape[1:4]), k, stride)) * ci * co
    wbytes = 2 * k ** 3 * ci * co
    return (2 * (cells_out * co + cells_in * ci) + wbytes, 2.0 * macs,
            2 * (cells_in * ci + cells_out * co) + wbytes + 4 * co,
            2.0 * cells_out * co * ci * k ** 3)


def check_grad3_layers(label, rows, dev):
    """N's flax route at batch 4 and the gradient kernels on each recorded
    layer: N against its plain version within one bf16 ulp at each
    rounding point; fn_conv3d_dgrad and fn_conv3d_wgrad against theirs,
    bit for bit on dyadic inputs, within one bf16 ulp (the bias gradient
    bit for bit) on the layer's own inputs with at most N_BF16_OFF_SHARE
    off, bit-equal repeats; each timed beside cuDNN's bf16 gradients and
    the plain versions, with its bound. Returns per-layer dicts."""
    from fluidnet_cxx_tpu_torch.ops.kernels import conv_grad3, punet3

    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    bf = torch.bfloat16
    out = []
    for name, x1, x2, w, b, stride, relu, y, gy in rows:
        k = w.shape[0]
        co = w.shape[-1]
        xin = x1 if x2 is None else torch.cat([x1, x2], dim=-1).contiguous()
        shape = tuple(xin.shape[1:4])
        tag = f"{label} {name} {tuple(xin.shape)}->{co} k{k} s{stride}"
        got = punet3.conv3d_ndhwc(x1, w, b, stride, relu, x2, bf, True)
        want = punet3.conv3d_ndhwc_plain(x1, w.permute(4, 3, 0, 1, 2), b,
                                         stride, relu, x2, bf, True)
        presum = punet3.conv3d_ndhwc_plain(x1, w.permute(4, 3, 0, 1, 2),
                                           torch.zeros_like(b), stride,
                                           False, x2)
        check_bf16(f"N flax batch 4, {tag}", got, want, N_BF16_OFF_SHARE,
                   presum)
        gy = (torch.where(y > 0, gy, 0.0) if relu else gy).contiguous()
        so = gy.shape[1]
        dgrad = lambda g=gy, w=w: conv_grad3.conv3d_dgrad(g, w, stride,
                                                          shape)
        wgrad = lambda x=xin, g=gy: conv_grad3.conv3d_wgrad(x, g, k, stride)
        dx, (dw, db) = dgrad(), wgrad()
        torch.cuda.synchronize()
        pdx = conv_grad3.conv3d_dgrad_plain(gy, w, stride, shape)
        pdw, pdb = conv_grad3.conv3d_wgrad_plain(xin, gy, k, stride)
        d_err = check_bf16(f"dgrad3 {tag}", dx, pdx, N_BF16_OFF_SHARE)
        w_err = check_bf16(f"wgrad3 {tag}", dw, pdw, N_BF16_OFF_SHARE)
        check(f"wgrad3 bias {tag}", max_err([db], [pdb]), 0.0)
        check_repeat(f"dgrad3 {tag}", dgrad)
        check_repeat(f"wgrad3 {tag}", lambda: torch.cat(
            [t.float().flatten() for t in wgrad()]))
        dx_, w_, g_ = (dyadic3(gen, t.shape, 16, d, dev) for t, d in
                       ((xin, 8), (w, 64), (gy, 8)))
        check(f"dgrad3 exact sums {tag}", max_err(
            [conv_grad3.conv3d_dgrad(g_, w_, stride, shape).float()],
            [conv_grad3.conv3d_dgrad_plain(g_, w_, stride, shape).float()]),
            0.0)
        kw, kb = conv_grad3.conv3d_wgrad(dx_, g_, k, stride)
        pw, pb = conv_grad3.conv3d_wgrad_plain(dx_, g_, k, stride)
        check(f"wgrad3 exact sums {tag}", max_err([kw.float(), kb],
                                                  [pw.float(), pb]), 0.0)
        lib_d, lib_w = cudnn_grad3(xin, w, gy, stride)
        db_, do_, wb_, wo_ = grad3_work(xin, co, k, stride, so)
        r = dict(name=name, d_err=d_err, w_err=w_err, d_ms=graph_ms(dgrad),
                 w_ms=graph_ms(wgrad), d_lib=graph_ms(lib_d),
                 w_lib=graph_ms(lib_w),
                 d_plain=cuda_ms(lambda: conv_grad3.conv3d_dgrad_plain(
                     gy, w, stride, shape), 3, warmup=1),
                 w_plain=cuda_ms(lambda: conv_grad3.conv3d_wgrad_plain(
                     xin, gy, k, stride), 2, warmup=1),
                 d_bound=bound(db_, do_, BF16_OPS_PER_S),
                 w_bound=bound(wb_, wo_, BF16_OPS_PER_S))
        print(f"{tag}: dgrad {r['d_ms']:.4f} ms (cuDNN {r['d_lib']:.4f}, "
              f"plain {r['d_plain']:.3f}, bound {r['d_bound'][0]:.4f} "
              f"{r['d_bound'][1]}), wgrad {r['w_ms']:.4f} ms (cuDNN "
              f"{r['w_lib']:.4f}, plain {r['w_plain']:.3f}, bound "
              f"{r['w_bound'][0]:.4f} {r['w_bound'][1]})", flush=True)
        out.append(r)
    return out


def grad3_results(label, layers):
    """The kernels-line numbers of the input and weight gradients summed
    over one train step's calls (dgrad: every layer but the embed, whose
    input takes no gradient; wgrad: all nine)."""
    res = {}
    for key, pre, skip in (("dgrad3", "d", "embed"), ("wgrad3", "w", None)):
        rs = [r for r in layers if r["name"] != skip]
        b_ms = sum(r[f"{pre}_bound"][0] for r in rs)
        by = max(rs, key=lambda r: r[f"{pre}_bound"][0])[f"{pre}_bound"][1]
        res[f"{key} {label}"] = dict(
            err=max(r[f"{pre}_err"] for r in rs),
            ms=sum(r[f"{pre}_ms"] for r in rs),
            plain_ms=sum(r[f"{pre}_plain"] for r in rs), bound_ms=b_ms,
            bound_by=by, library_ms=sum(r[f"{pre}_lib"] for r in rs))
        print(f"{key} {label}, one train step's {len(rs)} calls: kernel "
              f"{res[f'{key} {label}']['ms']:.4f} ms, cuDNN "
              f"{res[f'{key} {label}']['library_ms']:.4f}, plain "
              f"{res[f'{key} {label}']['plain_ms']:.3f}, bound {b_ms:.4f} "
              f"({by})", flush=True)
    return res


def check_adjoint3(dev, results):
    """I's adjoint (fn_jacobi3_adjoint) bit for bit against its plain
    version: 8 damped sweeps on training's 32^3 batch-4 box, 16 damped and
    9 undamped on 64^3 batch 4 with 8% obstacles, 7 on an odd 33^3 box;
    timed at the p4 and p8 main paths' shapes beside the plain version and
    its bound (12 bytes a cell; 14 operations a cell a sweep); no PyTorch
    call computes it. I itself at batch 4: the 400 label sweeps bit for
    bit."""
    from fluidnet_cxx_tpu_torch.ops import ops3d
    from fluidnet_cxx_tpu_torch.ops.kernels import jacobi3

    gen = torch.Generator(device=dev).manual_seed(SEED + 35)

    def box(n, share, b=TRAIN3D_BSZ):
        f = ops3d.empty_domain3(b, n, n, n, device=dev).clone()
        f[(torch.rand(f.shape, generator=gen, device=dev) < share)
          & (f == 1)] = 2
        return f

    f32, f64, f33 = box(32, 0.0), box(64, 0.08), box(33, 0.1, 1)
    cases = {"32^3 batch 4, 8 damped": (f32, 8, 2.0 / 3.0, "I adjoint p4"),
             "64^3 batch 4, 16 damped": (f64, 16, 2.0 / 3.0,
                                         "I adjoint p8"),
             "64^3 batch 4, 9 undamped": (f64, 9, 1.0, None),
             "33^3, 7 damped": (f33, 7, 2.0 / 3.0, None)}
    for name, (f, it, w, key) in cases.items():
        g = torch.randn(f.shape, generator=gen, device=dev)
        run = lambda f=f, g=g, it=it, w=w: jacobi3.jacobi3_adjoint(f, g, it,
                                                                   w)
        got = run()
        torch.cuda.synchronize()
        check(f"I adjoint {name}", max_err(
            [got], [ops3d.jacobi_adjoint_fixed3(f, g, it, w)]), 0.0)
        check_repeat(f"I adjoint {name}", run)
        if key is None:
            continue
        ms, eager = device_and_eager(run)
        plain = cuda_ms(lambda: ops3d.jacobi_adjoint_fixed3(f, g, it, w), 3,
                        warmup=1)
        b_ms, b_by = bound(12 * f.numel(), 14.0 * it * f.numel())
        results[key] = dict(err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None)
        print(f"{key} ({name}): kernel {ms:.4f} ms device (eager "
              f"{eager:.4f}), plain {plain:.3f}, bound {b_ms:.4f} ({b_by}), "
              f"launches a call {launches_of(jacobi3.jacobi3_adjoint, run)}",
              flush=True)
    div = torch.randn(f32.shape, generator=gen, device=dev)
    check("I batch 4, 400 label sweeps at 32^3", max_err(
        [jacobi3.solve_jacobi3(f32, div, TRAIN3D_LABEL_ITERS)],
        [ops3d.solve_jacobi_fixed3(f32, div, TRAIN3D_LABEL_ITERS)]), 0.0)


def check_step3_card_vs_cpu(dev):
    """One bfloat16 train-step loss and its gradients (train3d.py's
    defaults at 32^3, batch 4, seed weights) on the card (kernels) against
    the port's plain step on the CPU, same batch: TRAIN3D_LOSS_TOL and
    TRAIN3D_GRAD_TOL."""
    from fluidnet_cxx_tpu_torch.data.synthetic3 import generate_batch3
    from fluidnet_cxx_tpu_torch.ops.kernels.punet3 import pack_weights3
    from fluidnet_cxx_tpu_torch.train.trainer import loss3

    with torch.no_grad():
        U, flags, _, _ = generate_batch3(torch.Generator().manual_seed(SEED),
                                         TRAIN3D_BSZ, 32, 32, 32, 60, "cpu")
    out = []
    for d in (dev, torch.device("cpu")):
        model = train3d_model(32, 4, 8, d)
        loss = loss3(model, pack_weights3(model.net), U.to(d), flags.to(d))
        loss.backward()
        out.append((float(loss.detach()), {n: p.grad.cpu() for n, p in
                                           model.net.named_parameters()}))
    (lc, gc), (lp, gp) = out
    check(f"train3d step loss card {lc:.7g} vs CPU {lp:.7g} (relative)",
          abs(lc - lp) / abs(lp), TRAIN3D_LOSS_TOL)
    gaps = {n: float((gc[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
            for n in gp}
    worst = max(gaps, key=gaps.get)
    print("train3d step gradients card vs CPU (relative L2): "
          f"{ {n: round(v, 5) for n, v in gaps.items()} }", flush=True)
    check(f"train3d step gradients card vs CPU, worst {worst} (relative "
          "L2)", gaps[worst], TRAIN3D_GRAD_TOL)


def train3d_main_path(name, dev):
    """One of TRAIN3D_PATHS through make_train_step3 as the twin CLI builds
    it: the counters set to 0, the plume frames collected (the mixed path),
    one warm-up step, the steps timed with CUDA events, each kernel of the
    path launched and the per-step launches held to the model; the loss at
    the first and the last chunk, and on a held-out batch before and after
    (finite; the 32^3 path's must fall: single batches' losses vary with
    their random amplitude); a profiler window of 2 steps. Returns the
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from fluidnet_cxx_tpu_torch.data.synthetic3 import generate_batch3
    from fluidnet_cxx_tpu_torch.ops.kernels import _build
    from fluidnet_cxx_tpu_torch.ops.kernels.punet3 import pack_weights3
    from fluidnet_cxx_tpu_torch.scripts import train3d
    from fluidnet_cxx_tpu_torch.train.trainer import loss3, make_train_step3

    res, patch, sweeps, n_frames, steps = TRAIN3D_PATHS[name]
    done = phase(f"main path ({name}, batch {TRAIN3D_BSZ}, {steps} steps)")
    model = train3d_model(res, patch, sweeps, dev)
    with torch.no_grad():
        held = generate_batch3(torch.Generator(device=dev).manual_seed(
            SEED + 41), TRAIN3D_BSZ, res, res, res, 60, dev)[:2]

    def held_loss():
        with torch.no_grad():
            return float(loss3(model, pack_weights3(model.net), *held))

    before = held_loss()
    counters = train3d_counters()
    for fn in counters.values():
        fn.launches = 0
    frames = flags = mask = None
    if n_frames:
        args = train3d.parse_args(["--res", str(res), "--plumeFrames",
                                   str(n_frames)])
        frames, flags, mask = train3d.rollout_frames(args, dev)
    step, _ = make_train_step3(model, TRAIN3D_LR, TRAIN3D_BSZ, res,
                               TRAIN3D_LABEL_ITERS, frames, flags, mask,
                               0.5, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    losses = [step(gen)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    losses += [step(gen) for _ in range(steps - 1)]
    e1.record()
    e1.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    ms = e0.elapsed_time(e1) / (steps - 1)
    vals = torch.stack(losses).cpu()
    first, last = float(vals[:5].mean()), float(vals[-5:].mean())
    after = held_loss()
    per_launch = _build.constant("fn_jacobi3_max_sweeps")
    forwards = 2 if n_frames else 1
    want = {"N": 9 * forwards, "Nf": 9 * forwards,
            "dgrad3": 8 * forwards, "wgrad3": 9 * forwards,
            "I adjoint": (1 + -(-sweeps // per_launch)) * forwards}
    if not n_frames:   # the labels' and the polish's solves
        want["I"] = (2 + -(-TRAIN3D_LABEL_ITERS // per_launch)
                     + -(-sweeps // per_launch))
    for k, v in want.items():
        if launches[k] != v * steps:
            raise SystemExit(f"{name}: {k} launched {launches[k]} times, "
                             f"not {v} a step over {steps}")
    missed = [k for k, v in launches.items() if v < 1 and
              (k != "L" or n_frames)]
    if missed:
        raise SystemExit(f"{name} missed kernels {missed}: {launches}")
    if not bool(torch.isfinite(vals).all()):
        raise SystemExit(f"{name}: a loss is not finite: {vals}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{name}: ms/step {ms:.2f} ({steps - 1} steps after one warm-up),"
          f" peak memory {peak:.2f} GiB, launches {launches} (per step "
          f"{ {k: round(v / steps, 2) for k, v in launches.items()} })",
          flush=True)
    print(f"{name}: loss mean of the first chunk {first:.6f}, of the last "
          f"{last:.6f}; on a held-out batch {before:.6f} before, {after:.6f} "
          f"after; every step {[round(v, 6) for v in vals.tolist()]}",
          flush=True)
    if not after == after or (not n_frames and res == 32
                              and not after < before):
        raise SystemExit(f"{name}: the held-out loss did not fall ({before} "
                         f"-> {after})")
    done()
    done = phase(f"profile ({name}, 2 steps)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 2
    print_profile(name, prof, 2, wall_ms)
    done()
    return launches


def train3d_cli_and_plume(dev):
    """The twin CLI (python -m fluidnet_cxx_tpu_torch.scripts.train3d, its
    main) for 10 steps at its defaults into a model dir under build/, then
    run_plume3d's learned case from that dir for 5 steps at 64^3: the
    trained weights load, the state is finite. The dir is removed after."""
    import math
    import shutil
    from pathlib import Path

    from fluidnet_cxx_tpu_torch.run_plume3d import run_plume3d
    from fluidnet_cxx_tpu_torch.scripts import train3d

    work = Path(__file__).resolve().parent / "build" / "train3d_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        done = phase("train3d twin CLI, 10 steps, then run_plume3d from its "
                     "model dir")
        res = train3d.main(["--steps", "10", "--modelDir", str(work)])
        if not (res["steps"] == 10 and all(math.isfinite(v)
                                           for v in res["losses"])):
            raise SystemExit(f"train3d CLI: {res}")
        run = run_plume3d(64, 5, dev, sim_method="convnet",
                          model_dir=str(work))
        st = run.pop("state")
        fin = all(bool(torch.isfinite(t).all())
                  for t in (st.U, st.p, st.density))
        print(f"run_plume3d from the trained dir: {run}, finite {fin}",
              flush=True)
        if not fin or run["weights"] != "trained":
            raise SystemExit("run_plume3d on the trained model dir failed")
        done()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_train3d(dev, results):
    """3-D training (A.5.2): N at batch 4 and the gradient kernels on
    every layer of the p4 and p8 nets; I's adjoint and I at batch 4; one
    step card against CPU; the three main paths; the twin CLI and
    run_plume3d from its model dir. Returns each main path's launches."""
    for label, (res, patch, sweeps) in TRAIN3D_NETS.items():
        done = phase(f"3-D gradient kernels, {label} at {res}^3, batch "
                     f"{TRAIN3D_BSZ}")
        model = train3d_model(res, patch, sweeps, dev)
        rows = record_grad3_layers(model, res, dev)
        results.update(grad3_results(label, check_grad3_layers(label, rows,
                                                               dev)))
        del model, rows
        torch.cuda.empty_cache()
        done()
    done = phase("I's adjoint (fn_jacobi3_adjoint) and I at batch 4")
    check_adjoint3(dev, results)
    done()
    done = phase("one bfloat16 train step, card vs CPU (32^3, batch 4)")
    check_step3_card_vs_cpu(dev)
    done()
    launches = {name: train3d_main_path(name, dev) for name in TRAIN3D_PATHS}
    train3d_cli_and_plume(dev)
    return launches


def train3d_rows(results, launches):
    """The kernels-line rows of the 3-D backward kernels: launches from the
    p4 and p8 main paths."""
    src = "fluidnet_cxx_tpu_torch/csrc/conv3d_grad.cu"
    meta = [("dgrad3 p4", "conv3d_dgrad_punet3_p4_b4", src, TRAIN3D_REPLACES,
             "train3d 32^3 p4", "dgrad3"),
            ("wgrad3 p4", "conv3d_wgrad_punet3_p4_b4", src, TRAIN3D_REPLACES,
             "train3d 32^3 p4", "wgrad3"),
            ("I adjoint p4", "jacobi3_adjoint_p4_b4",
             "fluidnet_cxx_tpu_torch/csrc/jacobi3.cu", ADJOINT3_REPLACES,
             "train3d 32^3 p4", "I adjoint"),
            ("dgrad3 p8", "conv3d_dgrad_punet3_p8_b4", src, TRAIN3D_REPLACES,
             "train3d 64^3 p8", "dgrad3"),
            ("wgrad3 p8", "conv3d_wgrad_punet3_p8_b4", src, TRAIN3D_REPLACES,
             "train3d 64^3 p8", "wgrad3"),
            ("I adjoint p8", "jacobi3_adjoint_p8_b4",
             "fluidnet_cxx_tpu_torch/csrc/jacobi3.cu", ADJOINT3_REPLACES,
             "train3d 64^3 p8", "I adjoint")]
    out = []
    for key, name, source, replaces, path, counter in meta:
        r = results[key]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": launches[path][counter],
                    "max_abs_err": r["err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    return out


def train3d_only(dev):
    """`python3 chip_smoke.py --train3d-only`: phase_train3d alone, then
    the kernels line of its six rows."""
    results = {}
    launches = phase_train3d(dev, results)
    print(json.dumps({"kernels": train3d_rows(results, launches)}))


# Training in bfloat16 on kernel B's bfloat16 route (ROADMAP A.5.3 and
# A.4.3): the nets whose every layer the bfloat16 gradient kernels are held
# on, label -> (model, side, batch): MGCoarseNet's PUNet on the 128^2 cut
# at batch 16 (scripts/train_mg_coarse.py's), and PUNetD2_128's
# architecture, the tower and ScaleNet in bfloat16 at training's 128^2,
# batch 64.
BF16_TRAIN_NETS = {"mg_coarse": ("MGCoarseNet", 128, 16),
                   "punet": ("PUNet", TRAIN_RES, TRAIN_BSZ),
                   "tower": ("FluidNet", TRAIN_RES, TRAIN_BSZ),
                   "scalenet": ("ScaleNet", TRAIN_RES, TRAIN_BSZ)}
# Steps of the bfloat16 trainer's main paths (make_on_device_train_step).
BF16_TRAIN_STEPS = {"PUNet": 5, "FluidNet": 5, "ScaleNet": 3}
# What the kernels stand in for: the JAX script's jax.value_and_grad of
# its loss (XLA's backward of flax nn.Conv(dtype="bfloat16")).
MGC_REPLACES = "scripts/train_mg_coarse.py:191"
# The twin at --res 512 (its default), a few frames and 20 steps.
MGC_ARGS = ["--res", "512", "--frames", "24", "--warmup", "20", "--steps",
            "20", "--evalEvery", "10"]


def bf16_counters():
    """{key: wrapper} of the kernels a bfloat16 2-D train step launches:
    B, the three bfloat16 gradient kernels, the float32 ones (which it
    must not launch), G (the twin's labels and eval), E and F (the
    trainer's rollout and labels)."""
    from fluidnet_cxx_tpu_torch.ops.kernels import (advect, conv_grad, jacobi,
                                                    mg, punet)
    return {"B": punet.conv2d_nhwc, "dgrad16": conv_grad.conv2d_dgrad_bf16,
            "wgrad16": conv_grad.conv2d_wgrad_bf16,
            "bias16": conv_grad.bias_grad, "dgrad": conv_grad.conv2d_dgrad,
            "wgrad": conv_grad.conv2d_wgrad, "G": mg.solve_mg,
            "E": advect.advect_velocity, "F": jacobi.solve_jacobi}


def bf16_cfg(model):
    """The ModelConfig of ``model`` trained in bfloat16 (PUNet:
    PUNetD2_128's architecture)."""
    from fluidnet_cxx_tpu_torch.config import ModelConfig

    return ModelConfig(model=model, compute_dtype="bfloat16",
                       **TRAIN_CFG.get(model, {}))


def bf16_net_and_input(label, dev, seed=1):
    """(the bfloat16 2-D net of ``label`` with flax's initialisation from
    ``seed``, its NHWC input at BF16_TRAIN_NETS' shape): MGCoarseNet's
    PUNet on a cut problem's normalised RHS and mask; the others on the
    trainer's assembled input of a synthetic batch."""
    from fluidnet_cxx_tpu_torch.models import mg_coarse
    from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                       random_flax_params)
    from fluidnet_cxx_tpu_torch.models.fluidnet import make_net

    model, side, bsz = BF16_TRAIN_NETS[label]
    if model != "MGCoarseNet":
        net = make_net(bf16_cfg(model))
        net.load_state_dict(flax_to_state_dict(random_flax_params(net.table,
                                                                  seed)))
        x = train_input(model, dev, bsz, side).contiguous()
        return net.to(dev), x
    net = mg_coarse.init_mg_coarse_params(mg_coarse.MGCoarseNet(),
                                          seed).punet.to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    flags = torch.ones((bsz, side, side), dtype=torch.int32, device=dev)
    flags[torch.rand(flags.shape, generator=gen, device=dev) < 0.05] = 2
    cont = mg_coarse._cont(flags)
    rhs = torch.randn(flags.shape, generator=gen, device=dev) * cont
    s = rhs.square().mean(dim=(1, 2), keepdim=True).sqrt() + 1e-8
    return net, torch.stack([rhs / s, cont], dim=-1)


def record_bf16_layers(net, x, dev):
    """Each conv call of one forward and backward of the bfloat16 ``net``
    on ``x`` through the autograd route (ConvNHWC on packed weights, the
    padded activations): (name, x, x2, packed weight and bias, stride,
    dilation, relu, the output, the output's gradient from a random
    upstream gradient at the net's output)."""
    from fluidnet_cxx_tpu_torch.ops.kernels import punet

    packed = punet.pack_weights(net)
    calls, grads = [], {}
    bf = torch.bfloat16

    def conv(name, h, x2=None, relu=True, in_scale=None, scale_mod=1):
        w, b = packed[name]
        _, stride, dil = net.geometry[name]
        h = h.to(bf)
        x2 = None if x2 is None else x2.to(bf)
        y = punet.conv2d_nhwc_autograd(h, w, b, stride, dil, relu, x2)
        y.register_hook(lambda g, i=len(calls): grads.__setitem__(i, g))
        calls.append((name, h.detach(), None if x2 is None else x2.detach(),
                      w.detach(), b.detach(), stride, dil, relu,
                      y.detach()))
        return y

    out = net(x.to(bf), conv=conv, width=punet.STAGE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    (out * torch.randn(out.shape, generator=gen, device=dev)).sum().backward()
    return [c + (grads[i],) for i, c in enumerate(calls)]


def cudnn_grad2(x, w_hwio, gy, stride, dil):
    """(input gradient, weight gradient and bias sum) of one layer by
    cuDNN's ``conv2d_input`` / ``conv2d_weight`` in bfloat16
    (channels_last) on the SAME-padded input, and torch's sum of dy, as
    closures: the library yardsticks."""
    from fluidnet_cxx_tpu_torch.ops.kernels.conv_grad import same_pads

    k = w_hwio.shape[0]
    lo, hi = same_pads(x.shape[1], k, stride, dil)
    cl = torch.channels_last
    w = w_hwio.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    g = gy.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    xn = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                 (lo, hi, lo, hi)).contiguous(
                                     memory_format=cl)
    size = tuple(xn.shape)

    def dgrad():
        return torch.nn.grad.conv2d_input(size, w, g, stride=stride,
                                          dilation=dil)

    def wgrad():
        return (torch.nn.grad.conv2d_weight(xn, tuple(w.shape), g,
                                            stride=stride, dilation=dil),
                gy.sum(dim=(0, 1, 2)))

    def bias():
        return gy.sum(dim=(0, 1, 2))
    return dgrad, wgrad, bias


def plain_ms(fn):
    """(result, device ms) of one call of a plain version (its bias chain
    takes one launch a cell of a window: one call, timed with CUDA
    events), with cuDNN off (``no_cudnn``)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = no_cudnn(fn)
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def no_cudnn(fn):
    """``fn()`` with cuDNN off: the plain versions' float32 sums then run
    PyTorch's own direct convolutions, each a sum of the exact products
    (cuDNN may pick an algorithm whose float32 result is no such sum:
    with it on an H100, 84 of the 36,864 values of MGCoarseNet's enc0_0
    weight gradient missed the exact sum rounded to bf16, against 9 for
    the kernel, and its dyadic sums were not exact)."""
    with torch.backends.cudnn.flags(enabled=False):
        return fn()


def check_bf16_sum(name, got, want, exact):
    """A bfloat16 gradient (a float32 sum rounded once) against its plain
    version: within one bf16 ulp of it (check_bf16's tolerance) with at
    most BF16_OFF_SHARE of its values off; or, where a long float32 sum
    lands more values on the other side of a rounding point (the plain
    version's float32 sum over a million cells is itself that far from
    the exact one), within one bf16 ulp of the exact sum rounded once
    (``exact()``: the plain version in float64) and with no more values
    off it than twice the plain float32 version's. Returns the largest
    absolute error against the plain version."""
    err, excess, off = bf16_gap(got, want)
    n = got.numel()
    print(f"{name}: max_abs_err {err:.3e}; largest excess over max(1 ulp, "
          f"1e-5 of the largest output) {excess:.3e}; {off} of {n} values "
          "off", flush=True)
    if excess <= 0 and off <= BF16_OFF_SHARE * n:
        return err
    ref = no_cudnn(exact).to(torch.bfloat16)
    _, mine_excess, mine = bf16_gap(got, ref)
    plain = int((want != ref).sum())
    print(f"{name}: against the exact sum rounded once: excess "
          f"{mine_excess:.3e}, the kernel {mine} values off, the plain "
          f"float32 version {plain}", flush=True)
    if not mine_excess <= 0 or mine > max(2 * plain, BF16_OFF_SHARE * n):
        raise SystemExit(f"{name} is further from the exact sum than its "
                         "plain version")
    return err


def check_bf16_grad_layers(label, net, rows, dev):
    """The bfloat16 gradient kernels on each recorded layer against their
    plain versions: fn_conv2d_bf16_dgrad (every layer whose input takes a
    gradient) and fn_conv2d_bf16_wgrad within one bf16 ulp
    (check_bf16_sum) on the layer's own inputs, fn_bias_grad_bf16 bit for
    bit; all three
    bit for bit on dyadic inputs whose sums are exact; repeats bit-equal;
    each timed (graph_ms) beside its plain version and cuDNN's bf16
    gradients, with its bound on the layer's real channels; and the
    layer's forward on B's bfloat16 route (5x5 taps and thin layers among
    them) within one bf16 ulp at each rounding point of its plain
    version. Returns per-layer dicts."""
    from fluidnet_cxx_tpu_torch.ops.kernels import conv_grad, punet

    gen = torch.Generator(device=dev).manual_seed(SEED + 55)
    out = []
    first = rows[0][0]
    for name, x1, x2, w, b, stride, dil, relu, y, gy in rows:
        k = w.shape[0]
        co_r, ci_r = net.convs[name].weight.shape[:2]
        xin = x1 if x2 is None else torch.cat([x1, x2], dim=-1).contiguous()
        hw = tuple(xin.shape[1:3])
        pads = conv_grad.same_pads(hw[0], k, stride, dil)
        tag = (f"{label} {name} {tuple(xin.shape)}->{w.shape[-1]} "
               f"({ci_r}->{co_r} real) k{k} s{stride} d{dil}")
        presum = punet.conv2d_nhwc_plain(
            xin.float(), w.float().permute(3, 2, 0, 1), torch.zeros_like(b),
            stride, dil)
        check_bf16(f"B bf16 forward {tag}", y, punet.conv2d_nhwc_plain(
            x1, w.permute(3, 2, 0, 1), b, stride, dil, relu, x2),
            presum=presum)
        gy = (torch.where(y > 0, gy, 0.0) if relu else gy).contiguous()
        dgrad = lambda g=gy, w=w: conv_grad.conv2d_dgrad_bf16(g, w, dil,
                                                              stride, hw)
        wgrad = lambda x=xin, g=gy: conv_grad.conv2d_wgrad_bf16(
            x, g, k, stride, dil, pads)
        bias = lambda g=gy: conv_grad.bias_grad(g)
        r = dict(name=name, first=name == first)
        lib_d, lib_w, lib_b = cudnn_grad2(xin, w, gy, stride, dil)
        cells_in, cells_out = xin[..., 0].numel(), gy[..., 0].numel()
        if name != first:
            dx = dgrad()
            torch.cuda.synchronize()
            pdx, r["d_plain"] = plain_ms(lambda: conv_grad.
                                         conv2d_dgrad_bf16_plain(
                                             gy, w, dil, stride, hw))
            r["d_err"] = check_bf16_sum(
                f"bf16 dgrad {tag}", dx, pdx,
                lambda: conv_grad.conv2d_dgrad_plain(gy.double(), w.double(),
                                                     dil, stride, hw))
            check_repeat(f"bf16 dgrad {tag}", dgrad)
            macs = sum(len(c.taps) * x1.shape[0] * c.hq * c.wq for c in
                       conv_grad.dgrad_classes(*hw, k, stride, dil))
            r["d_bound"] = bound(2 * (cells_out * co_r + cells_in * ci_r
                                      + k * k * ci_r * co_r),
                                 2.0 * macs * ci_r * co_r, BF16_OPS_PER_S)
            r["d_ms"], r["d_lib"] = graph_ms(dgrad), graph_ms(lib_d)
        dw, db = wgrad()
        torch.cuda.synchronize()
        (pdw, pdb), r["w_plain"] = plain_ms(
            lambda: conv_grad.conv2d_wgrad_bf16_plain(xin, gy, k, stride,
                                                      dil, pads))
        r["w_err"] = check_bf16_sum(
            f"bf16 wgrad {tag}", dw, pdw,
            lambda: conv_grad.conv2d_wgrad_plain(xin.double(), gy.double(),
                                                 k, stride, dil, pads)[0])
        check(f"bf16 bias {tag}", max_err([db], [pdb]), 0.0)
        r["b_err"] = 0.0
        _, r["b_plain"] = plain_ms(lambda: conv_grad.bias_grad_plain(gy))
        check_repeat(f"bf16 wgrad {tag}", lambda: torch.cat(
            [t.float().flatten() for t in wgrad()]))
        dx_, w_, g_ = (dyadic3(gen, t.shape, 16, d, dev) for t, d in
                       ((xin, 8), (w, 64), (gy, 8)))
        if name != first:
            check(f"bf16 dgrad exact sums {tag}", max_err(
                [conv_grad.conv2d_dgrad_bf16(g_, w_, dil, stride,
                                             hw).float()],
                [no_cudnn(lambda: conv_grad.conv2d_dgrad_bf16_plain(
                    g_, w_, dil, stride, hw)).float()]), 0.0)
        kw, kb = conv_grad.conv2d_wgrad_bf16(dx_, g_, k, stride, dil, pads)
        pw, pb = no_cudnn(lambda: conv_grad.conv2d_wgrad_bf16_plain(
            dx_, g_, k, stride, dil, pads))
        check(f"bf16 wgrad and bias exact sums {tag}",
              max_err([kw.float(), kb], [pw.float(), pb]), 0.0)
        r["w_bound"] = bound(2 * (cells_in * ci_r + cells_out * co_r
                                  + k * k * ci_r * co_r),
                             2.0 * cells_out * k * k * ci_r * co_r,
                             BF16_OPS_PER_S)
        r["b_bound"] = bound(2 * cells_out * co_r + 4 * co_r,
                             float(cells_out * co_r), BF16_OPS_PER_S)
        r["w_ms"], r["w_lib"] = graph_ms(wgrad), graph_ms(lib_w)
        r["b_ms"], r["b_lib"] = graph_ms(bias), graph_ms(lib_b)
        print(f"{tag}: dgrad "
              + (f"{r['d_ms']:.4f} ms (cuDNN {r['d_lib']:.4f}, plain "
                 f"{r['d_plain']:.3f}, bound {r['d_bound'][0]:.4f} "
                 f"{r['d_bound'][1]})" if name != first else "- (no input "
                 "gradient)")
              + f", wgrad+bias {r['w_ms']:.4f} ms (cuDNN {r['w_lib']:.4f}, "
              f"plain {r['w_plain']:.3f}, bound {r['w_bound'][0]:.4f} "
              f"{r['w_bound'][1]}), of it bias {r['b_ms']:.4f} ms (torch sum "
              f"{r['b_lib']:.4f}, plain {r['b_plain']:.3f}, windows "
              f"{conv_grad.bias_windows(tuple(gy.shape[:-1]))})",
              flush=True)
        out.append(r)
    return out


def bf16_grad_results(label, layers):
    """The kernels-line numbers of the three bfloat16 gradient kernels
    summed over one backward's calls (dgrad: every layer but the first,
    whose input takes no gradient)."""
    res = {}
    for key, pre in (("dgrad16", "d"), ("wgrad16", "w"), ("bias16", "b")):
        rs = [r for r in layers if key != "dgrad16" or not r["first"]]
        b_ms = sum(r[f"{pre}_bound"][0] for r in rs)
        by = max(rs, key=lambda r: r[f"{pre}_bound"][0])[f"{pre}_bound"][1]
        res[f"{key} {label}"] = dict(
            err=max(r[f"{pre}_err"] for r in rs),
            ms=sum(r[f"{pre}_ms"] for r in rs),
            plain_ms=sum(r[f"{pre}_plain"] for r in rs), bound_ms=b_ms,
            bound_by=by, library_ms=sum(r[f"{pre}_lib"] for r in rs))
        v = res[f"{key} {label}"]
        print(f"{key} {label}, one backward's {len(rs)} calls: kernel "
              f"{v['ms']:.4f} ms, library {v['library_ms']:.4f}, plain "
              f"{v['plain_ms']:.3f}, bound {b_ms:.4f} ({by})", flush=True)
    return res


def bf16_step_grads(model, dev, moved=False):
    """(loss, {name: gradient}) of one bfloat16 step on ``dev`` at 64^2,
    batch 4 (the others' loss with LT on and a fixed draw of 4 steps;
    MGCoarseNet's the twin's loss on 64^2 cut problems), seed weights;
    ``moved``: one value of the batch's input moved by one bf16 ulp."""
    from fluidnet_cxx_tpu_torch.config import SimConfig, TrainConfig
    from fluidnet_cxx_tpu_torch.data.synthetic import generate_batch
    from fluidnet_cxx_tpu_torch.models import mg_coarse
    from fluidnet_cxx_tpu_torch.models.convert import (flax_to_state_dict,
                                                       random_flax_params)
    from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet, make_net
    from fluidnet_cxx_tpu_torch.ops.kernels.punet import pack_weights
    from fluidnet_cxx_tpu_torch.scripts import train_mg_coarse as tmc
    from fluidnet_cxx_tpu_torch.train.trainer import (Batch, _sample_dyn,
                                                      make_loss_fn)

    cpu = torch.Generator().manual_seed(SEED)
    if model == "MGCoarseNet":
        net = mg_coarse.init_mg_coarse_params(mg_coarse.MGCoarseNet(), 1)
        flags = torch.ones((4, 64, 64), dtype=torch.int32)
        flags[torch.rand(flags.shape, generator=cpu) < 0.05] = 2
        rhs, e_star = torch.randn((2, 4, 64, 64), generator=cpu)
        if moved:
            rhs[0, 20, 30] *= 1 + 2.0 ** -7
        net = net.to(dev)
        loss = tmc.coarse_loss(net, pack_weights(net.punet), flags.to(dev),
                               rhs.to(dev), e_star.to(dev))
        loss.backward()
        return float(loss.detach()), {n: p.grad.cpu() for n, p in
                                      net.named_parameters()}
    tc, sc = TrainConfig(batch_size=4), SimConfig()
    with torch.no_grad():
        batch = Batch(*generate_batch(cpu, 4, 64, 64, 200, "cpu"))
    if moved:
        batch.U_div[0, 0, 20, 30] *= 1 + 2.0 ** -7
    dyn, _ = _sample_dyn(torch.Generator().manual_seed(SEED), sc, tc)
    net = make_net(bf16_cfg(model))
    net.load_state_dict(flax_to_state_dict(random_flax_params(net.table, 1)))
    net = net.to(dev)
    loss_fn = make_loss_fn(FluidNet(bf16_cfg(model), net), sc, tc)
    total, _ = loss_fn(Batch(*(t.to(dev) for t in batch[:7])),
                       draw=(dyn, 4))
    total.backward()
    return float(total.detach()), {n: p.grad.cpu() for n, p in
                                   net.named_parameters()}


def check_bf16_step_card_vs_cpu(model, dev):
    """One bfloat16 step's loss and gradients on the card (kernels)
    against the CPU's plain step (bf16_step_grads): the loss within
    TRAIN3D_LOSS_TOL of its value; the gradient (all parameters, relative
    L2) within TRAIN3D_GRAD_TOL of the CPU's, or within twice what the
    CPU's gradient moves when one input value moves by one bf16 ulp (ReLU
    masks that flip in bfloat16: ScaleNet's branches move 5-19% a tensor
    so in JAX itself, tests/test_torch_bf16_grad.py)."""
    (lc, gc), (lp, gp), (_, gm) = (bf16_step_grads(model, dev),
                                   bf16_step_grads(model, "cpu"),
                                   bf16_step_grads(model, "cpu", True))

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def whole(g):
        return torch.cat([g[n].flatten() for n in gp])

    check(f"bf16 {model} step loss card {lc:.7g} vs CPU {lp:.7g} "
          "(relative)", abs(lc - lp) / abs(lp), TRAIN3D_LOSS_TOL)
    pairs = {n: (round(rel(gc[n], gp[n]), 4), round(rel(gm[n], gp[n]), 4))
             for n in gp}
    print(f"bf16 {model} step gradients card vs CPU (relative L2) | CPU "
          f"moved by one ulp, per tensor: {pairs}", flush=True)
    check(f"bf16 {model} step gradient card vs CPU (relative L2 over all "
          "parameters)", rel(whole(gc), whole(gp)),
          max(TRAIN3D_GRAD_TOL, 2 * rel(whole(gm), whole(gp))))


def bf16_train_main_path(model, dev):
    """make_on_device_train_step on ``model`` in bfloat16 (TrainConfig():
    batch 64 at 128^2, LT on, 600 label sweeps): one warm-up step, then
    the counters set to 0 and BF16_TRAIN_STEPS - 1 steps timed; finite
    loss terms; the bfloat16 gradient kernels launched as TRAIN_BACKWARD
    says (the bias gradient with every weight gradient) and the float32
    ones never. Returns the launches."""
    from fluidnet_cxx_tpu_torch.config import SimConfig, TrainConfig
    from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_cxx_tpu_torch.train.trainer import (
        check_trainable, init_train_state, make_on_device_train_step)

    n = BF16_TRAIN_STEPS[model] - 1
    name = (f"train {model} bf16 {TRAIN_RES}^2 batch {TRAIN_BSZ}, {n + 1} "
            "steps")
    done = phase(f"main path ({name})")
    tc, sc = TrainConfig(batch_size=TRAIN_BSZ), SimConfig()
    check_trainable(bf16_cfg(model), dev)
    fnet = FluidNet(bf16_cfg(model)).to(dev)
    ts = init_train_state(fnet, tc, seed=0, steps_per_epoch=50)
    step = make_on_device_train_step(fnet, sc, tc, TRAIN_RES, TRAIN_RES,
                                     tc.batch_size, 600, dev)
    gen = torch.Generator(device=dev).manual_seed(4321)
    host_gen = torch.Generator().manual_seed(4321)
    ts, _ = step(ts, gen, host_gen)
    torch.cuda.synchronize()
    counters = bf16_counters()
    for fn in counters.values():
        fn.launches = 0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    terms = [step(ts, gen, host_gen)[1] for _ in range(n)]
    e1.record()
    e1.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    vals = torch.stack([torch.stack(list(t)) for t in terms]).cpu()
    if not bool(torch.isfinite(vals).all()):
        raise SystemExit(f"{name}: a loss term is not finite: {vals}")
    per = TRAIN_BACKWARD[model]
    want = {"wgrad16": per["wgrad"], "bias16": per["wgrad"],
            "dgrad16": per["dgrad"], "wgrad": 0, "dgrad": 0}
    if any(launches[k] != v * n for k, v in want.items()):
        raise SystemExit(f"{name}: launches {launches}, not {want} a step")
    print(f"{name}: ms/step {e0.elapsed_time(e1) / n:.2f} ({n} steps after "
          f"one warm-up), launches {launches}; loss terms per step (total, "
          f"pL2, divL2, pL1, divL1, divLT): "
          f"{[[round(v, 5) for v in row] for row in vals.tolist()]}",
          flush=True)
    done()
    return launches


def mg_coarse_main_path(dev):
    """The twin (python -m fluidnet_cxx_tpu_torch.scripts.train_mg_coarse,
    its main) with MGC_ARGS into a model dir under build/, the counters
    set to 0 just before: every step launches the bfloat16 gradient
    kernels on MGCoarseNet's 10 convs (9 input gradients), finite losses
    that fall (the mean of the last 5 under that of the first 5); then the
    run_plume twin under --simMethod mg_learned on that dir for 10 steps
    at 512^2: finite. The dir is removed after. Returns the launches."""
    import math
    import shutil
    from pathlib import Path

    from fluidnet_cxx_tpu_torch.scripts import run_plume as twin_plume
    from fluidnet_cxx_tpu_torch.scripts import train_mg_coarse as tmc

    work = Path(__file__).resolve().parent / "build" / "mg_coarse_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        done = phase("main path (train_mg_coarse twin --res 512, 20 steps)")
        counters = bf16_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = tmc.main(MGC_ARGS + ["--modelDir", str(work / "model")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        steps, losses = res["steps"], res["losses"]
        want = {"wgrad16": 10, "bias16": 10, "dgrad16": 9, "wgrad": 0,
                "dgrad": 0}
        if any(launches[k] != v * steps for k, v in want.items()):
            raise SystemExit(f"train_mg_coarse: launches {launches}, not "
                             f"{want} a step")
        if launches["G"] < 1:
            raise SystemExit("train_mg_coarse: no G launch")
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        print(f"train_mg_coarse twin: {wall:.1f} s in all, ms/step "
              f"{res['ms_per_step']:.2f}, launches {launches}; loss mean of "
              f"the first 5 steps {first:.5f}, of the last 5 {last:.5f}; "
              f"every step {[round(v, 5) for v in losses]}; evals "
              f"{res['evals']}", flush=True)
        if not all(math.isfinite(v) for v in losses) or not last < first:
            raise SystemExit("train_mg_coarse: the loss did not fall")
        done()
        done = phase("run_plume twin --simMethod mg_learned from its dir")
        conf = work / "plume.yaml"
        conf.write_text("realTimePlot: false\nstatIter: 10\n")
        run = twin_plume.main(["--simConf", str(conf), "--simMethod",
                               "mg_learned", "--modelDir",
                               str(work / "model"), "--resX", "512", "--resY",
                               "512", "--maxIter", "10", "--outputFolder",
                               str(work / "out")])
        run.pop("state")
        print(f"run_plume from the trained dir: {run}", flush=True)
        if not run["finite"]:
            raise SystemExit("run_plume on the trained MGCoarseNet failed")
        done()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def phase_train_bf16(dev, results):
    """bfloat16 training (A.5.3, A.4.3): the bfloat16 gradient kernels on
    every layer of BF16_TRAIN_NETS; one step of each net card against
    CPU; the three nets' bfloat16 trainer main paths; the twin and
    run_plume from its dir. Returns each main path's launches."""
    for label in BF16_TRAIN_NETS:
        model, side, bsz = BF16_TRAIN_NETS[label]
        done = phase(f"bfloat16 gradient kernels, {label} at {side}^2, "
                     f"batch {bsz}")
        net, x = bf16_net_and_input(label, dev)
        rows = record_bf16_layers(net, x, dev)
        results.update(bf16_grad_results(
            label, check_bf16_grad_layers(label, net, rows, dev)))
        del net, x, rows
        torch.cuda.empty_cache()
        done()
    done = phase("one bfloat16 train step, card vs CPU (64^2, batch 4)")
    for model, _, _ in BF16_TRAIN_NETS.values():
        check_bf16_step_card_vs_cpu(model, dev)
    done()
    launches = {"mg_coarse": mg_coarse_main_path(dev)}
    for label, (model, _, _) in BF16_TRAIN_NETS.items():
        if label != "mg_coarse":
            launches[label] = bf16_train_main_path(model, dev)
    return launches


def train_bf16_rows(results, launches):
    """The kernels-line rows of the bfloat16 gradient kernels: each net's
    launches from its own main path (the twin's for MGCoarseNet)."""
    src = "fluidnet_cxx_tpu_torch/csrc/conv2d_bf16_grad.cu"
    out = []
    for label, (_, side, bsz) in BF16_TRAIN_NETS.items():
        replaces = MGC_REPLACES if label == "mg_coarse" else TRAIN_REPLACES
        for key, kind in (("dgrad16", "conv2d_bf16_dgrad"),
                          ("wgrad16", "conv2d_bf16_wgrad"),
                          ("bias16", "bias_grad_bf16")):
            r = results[f"{key} {label}"]
            out.append({"name": f"{kind}_{label}_{side}_b{bsz}",
                        "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[label][key],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    return out


def mg_coarse_only(dev):
    """`python3 chip_smoke.py --mg-coarse-only`: phase_train_bf16 alone,
    then the kernels line of its rows."""
    results = {}
    launches = phase_train_bf16(dev, results)
    print(json.dumps({"kernels": train_bf16_rows(results, launches)}))


# The scene drivers' twins (python -m fluidnet_cxx_tpu_torch.scripts.*,
# ROADMAP A.3 and A.9) at the shipped configs' sizes. Each case: (twin,
# its flags, the changes to its shipped YAML (None: the cylinder, which
# has none), the kernels it must launch, its restart check). A restart
# check is (straight, cut, resumed): each a (maxIter, statIter) run, the
# resumed one with --restartSim from the cut's restart.npz and stepped
# singly to the stats grid first; its final p, U and density must equal
# the straight run's bit for bit. The plume and RT take statIter from the
# YAML, the cylinder from --statIter.
PLUME_RESTART = ((60, 20), (30, 15), (60, 20))
RT_RESTART = ((40, 10), (25, 25), (40, 10))
CYL_RESTART = ((20, 10), (15, 15), (20, 10))
DRIVER_CASES = {
    "plume 128^2 jacobi-200 (VTK)": (
        "run_plume", ["--simMethod", "jacobi"], {"saveVTK": True}, "AF",
        PLUME_RESTART),
    "plume 128^2 convnet PUNetD2_128 (flax path)": (
        "run_plume", ["--simMethod", "convnet", "--modelDir",
                      "trained_models/PUNetD2_128"], {"saveVTK": True},
        "ABF", PLUME_RESTART),
    "plume 128^2 multigrid": (
        "run_plume", ["--simMethod", "multigrid"], {"saveVTK": True}, "AH",
        PLUME_RESTART),
    # At 128^2 MGCoarse_128 has no level below the finest to take over
    # (ops/kernels/mg.py::plan_learned_cut): 256^2 puts the net at 128^2.
    "plume 256^2 mg_learned MGCoarse_128": (
        "run_plume", ["--simMethod", "mg_learned", "--modelDir",
                      "trained_models/MGCoarse_128", "--resX", "256",
                      "--resY", "256"], {"saveVTK": True},
        ("A", "B", LEARNED_G), PLUME_RESTART),
    f"RT {RT_W}x{RT_H} jacobi-200": (
        "run_rayleigh_taylor", [], {"simMethod": "jacobi"}, "AF",
        RT_RESTART),
    f"RT {RT_W}x{RT_H} multigrid": (
        "run_rayleigh_taylor", [], {"simMethod": "multigrid"}, "AG",
        RT_RESTART),
    f"cylinder {CYL_W}x{CYL_H} jacobi-34": (
        "run_cylinder", ["--simMethod", "jacobi"], None, "EF", CYL_RESTART),
    f"cylinder {CYL_W}x{CYL_H} multigrid": (
        "run_cylinder", ["--simMethod", "multigrid"], None, "EH",
        CYL_RESTART),
    f"cylinder {CYL_W}x{CYL_H} convnet PUNetD2_128 (flax path)": (
        "run_cylinder", ["--simMethod", "convnet"], None, "EBF",
        CYL_RESTART),
}
YAML_OF = {"run_plume": "plume.yaml",
           "run_rayleigh_taylor": "rayleighTaylor.yaml"}


def twin_argv(twin, flags, changes, work, run, out, restart=False):
    """The argv of one run of a twin: its shipped YAML with ``changes``,
    realTimePlot false and statIter from ``run``, written into ``work``;
    or, for the cylinder (``changes`` None), --statIter and --realTimePlot
    false."""
    from fluidnet_cxx_tpu_torch.config import dump_yaml, load_yaml

    max_iter, stat_iter = run
    # --fast: the kernels' path (A, D, E with the first-hit trace), which
    # each case's kernels name.
    argv = flags + ["--fast", "--maxIter", str(max_iter), "--outputFolder",
                    str(out)]
    argv += ["--restartSim"] if restart else []
    if changes is None:
        return argv + ["--statIter", str(stat_iter), "--realTimePlot",
                       "false"]
    conf = dict(load_yaml(f"configs/{YAML_OF[twin]}"), **changes,
                realTimePlot=False, statIter=stat_iter)
    path = work / f"{twin}_{stat_iter}.yaml"
    dump_yaml(conf, str(path))
    return ["--simConf", str(path)] + argv


def drive_twin(name, twin, argv, counters):
    """One run of a twin's main(argv) on the card with the counters set to
    0 just before and read just after; prints and returns (its result,
    the launches)."""
    import importlib

    main = importlib.import_module(
        f"fluidnet_cxx_tpu_torch.scripts.{twin}").main
    for fn in counters.values():
        fn.launches = 0
    res = main(argv)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if not res["finite"]:
        raise SystemExit(f"{name}: a field is not finite")
    n = max(res["steps"], 1)
    loop_ms = (res["ms_per_step"] * n - res["outputs_ms"]) / n
    print(f"{name} [{res['start_it']}->{res['it']}]: ms/step "
          f"{res['ms_per_step']:.4f} with outputs, {loop_ms:.4f} without "
          f"({res['outputs_ms']:.1f} ms of outputs); mean|div| "
          f"{res['mean_div']:.6g} max|div| {res['max_div']:.6g}; launches "
          f"per step {({k: v / n for k, v in launches.items()})}",
          flush=True)
    return res, launches


def check_driver_files(name, twin, out, run):
    """The files a twin wrote at every stats point of ``run`` (from 0):
    restart.npz at the last, and the plume's VTK (finite) or RT's
    distance.npy and avg_density.npy (a finite row a stats point)."""
    import numpy as np

    max_iter, stat_iter = run
    points = list(range(stat_iter, max_iter + 1, stat_iter))
    with np.load(out / "restart.npz") as z:
        if int(z["it"]) != points[-1]:
            raise SystemExit(f"{name}: restart.npz holds it={int(z['it'])}")
    if twin == "run_plume":
        for it in points:
            vtk = out / f"snap_{it:06d}.vtk"
            data = vtk.read_text().split("POINT_DATA", 1)[1]
            cells = int(data.split()[0])
            # The numbers below the SCALARS, LOOKUP_TABLE and VECTORS
            # lines ("nan" and "inf" included): 4 scalars and 3 vectors of
            # 3 components a cell.
            vals = [float(v) for line in data.splitlines()[1:]
                    if not line[:1].isupper() for v in line.split()]
            if len(vals) != 13 * cells or not np.isfinite(vals).all():
                raise SystemExit(f"{name}: {vtk.name} is empty or not "
                                 "finite")
        print(f"{name}: VTK at it {points}, finite", flush=True)
    if twin == "run_rayleigh_taylor":
        for f in ("distance.npy", "avg_density.npy"):
            rows = np.load(out / f)
            if rows.shape != (len(points), 2) or not np.isfinite(rows).all():
                raise SystemExit(f"{name}: {f} {rows}")
        print(f"{name}: distance.npy {np.load(out / 'distance.npy')[-1]}, "
              f"avg_density.npy {np.load(out / 'avg_density.npy')[-1]}",
              flush=True)


def phase_drivers():
    """The scene drivers' twins as users run them: each case of
    DRIVER_CASES straight, with its files checked, then cut and resumed
    with --restartSim (bit-equal to the straight run); then the training
    entry point with --trainConfig configs/train.yaml for two on-device
    steps (its configs printed, a finite loss). Works in build/
    drivers_smoke, removed after."""
    import shutil
    from pathlib import Path

    import numpy as np

    from fluidnet_cxx_tpu_torch.train.__main__ import main as train_main

    counters = launch_counters()
    work = Path(__file__).resolve().parent / "build" / "drivers_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        for name, (twin, flags, changes, kernels, runs) in \
                DRIVER_CASES.items():
            done = phase(f"driver {name}")
            straight, cut, resumed = runs
            a, b = work / "straight", work / "cut"
            res, launches = drive_twin(name, twin, twin_argv(
                twin, flags, changes, work, straight, a), counters)
            missed = [k for k in kernels if k not in launches]
            if missed:
                raise SystemExit(f"{name} missed kernels {missed}: "
                                 f"{launches}")
            check_driver_files(name, twin, a, straight)
            drive_twin(name, twin, twin_argv(twin, flags, changes, work, cut,
                                             b), counters)
            again, _ = drive_twin(name, twin, twin_argv(
                twin, flags, changes, work, resumed, b, restart=True),
                counters)
            if again["start_it"] != cut[0]:
                raise SystemExit(f"{name}: resumed at {again['start_it']}")
            for f in ("p", "U", "density"):
                if not torch.equal(getattr(again["state"], f),
                                   getattr(res["state"], f)):
                    raise SystemExit(f"{name}: {f} after the restart differs "
                                     "from the straight run")
            print(f"{name}: restarted at {cut[0]}, final p, U, density "
                  "bit-equal to the straight run", flush=True)
            del res, again
            shutil.rmtree(a)
            shutil.rmtree(b)
            done()
        done = phase("train --trainConfig configs/train.yaml --onDevice 2")
        tc = train_counters()
        for fn in tc.values():
            fn.launches = 0
        model_dir = work / "model"
        train_main(["--trainConfig", "configs/train.yaml", "--onDevice", "2",
                    "--bsz", "8", "--modelDir", str(model_dir)])
        torch.cuda.synchronize()
        rows = np.load(model_dir / "train_loss.npy")
        if rows.shape != (1, 7) or not np.isfinite(rows).all():
            raise SystemExit(f"--trainConfig: loss rows {rows}")
        print(f"--trainConfig: loss {rows[0, 1]:.6g} after 2 steps; "
              f"launches per step "
              f"{({k: fn.launches / 2 for k, fn in tc.items()})}",
              flush=True)
        done()
    finally:
        shutil.rmtree(work, ignore_errors=True)


# The step's advection engines on the torch side (ROADMAP A.6): name ->
# plume_config changes (use_pallas stays off, as in the JAX defaults) and
# the kernels a 512^2 path of it must launch (Jacobi-200 on F; the march
# advects the velocity on E, Euler and gather both fields on the torch
# engines).
ENGINES = {"march": ({}, "EF"),
           "euler": (dict(advection_method="eulerFluidNet"), "F"),
           "gather": (dict(advection_impl="gather"), "F")}
ENGINES_TOL = 1e-5


def engine_scene(res, device):
    """run_plume.plume_case's plume at ``res`` (the inlet at 0.8 cells a
    step at 512^2) with a disc of radius res/12 a third of the way up in
    its way, so the march and the clamps meet an obstacle."""
    from fluidnet_cxx_tpu_torch.sim.scenes import (add_cylinder,
                                                   create_plume_scene)
    state = create_plume_scene(res, res, density_val=0.1,
                               u_scale=2.0 * res / 128.0, rad=0.145,
                               device=device)
    return state._replace(flags=add_cylinder(state.flags, res / 2.0,
                                             res / 3.0, res / 12.0))


def drive_counted(counters, run):
    """``run()`` with every launch counter set to 0 just before and read
    just after; returns (its result, {kernel: launches})."""
    for fn in counters.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: fn.launches for k, fn in counters.items() if fn.launches}


def need(name, launches, kernels):
    missed = [k for k in kernels if k not in launches]
    if missed:
        raise SystemExit(f"{name} missed kernels {missed}: {launches}")


def phase_engines(counters):
    """Phase 10: the torch advection engines on the 512^2 plume, card
    against CPU, and the drivers that run on them (see the module's
    note)."""
    import shutil
    from pathlib import Path

    import numpy as np

    from fluidnet_cxx_tpu_torch import bench3d
    from fluidnet_cxx_tpu_torch.run_plume import quality
    from fluidnet_cxx_tpu_torch.scripts import (eval_parity, make_dataset,
                                                preprocess_data,
                                                quality_per_ms, run_blob3d)
    from fluidnet_cxx_tpu_torch.sim.scenes import plume_config
    from fluidnet_cxx_tpu_torch.sim.step import simulate_step
    from fluidnet_cxx_tpu_torch.sim.step3d import simulate_step3

    dev = torch.device("cuda")
    for name, (kw, kernels) in ENGINES.items():
        label = f"plume {RES}^2 {name}"
        done = phase(f"engine path ({label}, {STEPS} steps)")
        cfg = plume_config(**kw)

        def run(cfg=cfg):
            state = engine_scene(RES, dev)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            with torch.no_grad():
                e0.record()
                for _ in range(STEPS):
                    state = simulate_step(cfg, state)
                e1.record()
            e1.synchronize()
            return state, e0.elapsed_time(e1) / STEPS

        (state, ms), launches = drive_counted(counters, run)
        need(label, launches, kernels)
        if not all(bool(torch.isfinite(getattr(state, f)).all())
                   for f in ("U", "density", "p")):
            raise SystemExit(f"{label}: a field is not finite")
        print(f"{label}: ms/step {ms:.4f}; {quality(state)}; launches per "
              f"step {({k: v / STEPS for k, v in launches.items()})}",
              flush=True)
        done()
        phase_profile(label, lambda cfg=cfg: (cfg, engine_scene(RES, dev),
                                              None))

    done = phase("engines card vs CPU (64^2, 3 steps; blob 48^3, 2 steps)")
    blob_cfg = run_blob3d.blob_config(run_blob3d.parse_args([]))
    cases = {f"64^2 {name}": (lambda d: engine_scene(64, d),
                              plume_config(**kw), simulate_step, 3)
             for name, (kw, _) in ENGINES.items()}
    cases["48^3 blob"] = (lambda d: run_blob3d.blob_state(48, d), blob_cfg,
                          simulate_step3, 2)
    with torch.no_grad():
        for name, (scene, cfg, step, n) in cases.items():
            gpu, cpu = scene(dev), scene("cpu")
            for _ in range(n):
                gpu, cpu = step(cfg, gpu), step(cfg, cpu)
            for field in ("U", "density", "p"):
                g, c = getattr(gpu, field).cpu(), getattr(cpu, field)
                e = max_err([g], [c])
                check(f"{name} {field} card vs CPU ({e / scale_of([c]):.2e} "
                      "of its largest value)", e, ENGINES_TOL * scale_of([c]))
    done()

    work = Path(__file__).resolve().parent / "build" / "engines_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        done = phase("run_blob3d twin (48^3, --maxIter 50 --statIter 25)")
        out, launches = drive_counted(counters, lambda: run_blob3d.main([
            "--res", "48", "--maxIter", "50", "--statIter", "25",
            "--outputFolder", str(work / "blob")]))
        need("run_blob3d", launches, "IM")
        if not out["finite"]:
            raise SystemExit("run_blob3d: a field is not finite")
        print(f"run_blob3d: ms/step {out['ms_per_step']:.4f}, launches per "
              f"step {({k: v / out['steps'] for k, v in launches.items()})}",
              flush=True)
        done()

        done = phase(f"bench3d window (XLA) and gather rows ({RES3}^3)")
        args = bench3d.parse(["--res", str(RES3), "--steps", "5", "--reps",
                              "1", "--xla"])
        rows = bench3d.rows_of(args, dev)
        for case, kernels in (("window_xla", "KMI"), ("gather", "I")):
            rec = bench3d.run_row(case, *rows[case], dev, args)
            need(f"bench3d {case}", rec["launches_per_step"], kernels)
            if not np.isfinite([rec[c] for c in bench3d.LIMITS3]).all():
                raise SystemExit(f"bench3d {case}: {rec}")
            print(f"bench3d {case}: graph ms/step {rec['ms_per_step']}, "
                  f"eager ms/step {rec['eager_ms_per_step']:.4f}, launches "
                  f"per step {rec['launches_per_step']}", flush=True)
        del rows
        done()

        done = phase("eval_parity twin (--res 128 --iters 200 --statIter 50, "
                     "PUNetD2_128)")
        (summary, results), launches = drive_counted(
            counters, lambda: eval_parity.main([
                "--res", "128", "--iters", "200", "--statIter", "50",
                "--modelDir", "trained_models/PUNetD2_128",
                "--out", str(work / "parity")]))
        need("eval_parity", launches, "EFB")
        values = [v for r in summary.values() if isinstance(r, dict)
                  for v in r.values()]
        if len(summary) != 5 or not np.isfinite(values).all():
            raise SystemExit(f"eval_parity: {summary}")
        print("eval_parity: ms/step " + ", ".join(
            f"{r['name']} {r['ms_per_step']:.4f}" for r in results)
            + f"; launches {launches}", flush=True)
        del results
        done()

        done = phase("quality_per_ms twin (--res 512 --iters 100 --statIter "
                     "50 --jacobi 28,200 --mg 2 --polish 32)")
        recs, launches = drive_counted(counters, lambda: quality_per_ms.main([
            "--modelDir", "trained_models/PUNetD2_128", "--res", "512",
            "--iters", "100", "--statIter", "50", "--jacobi", "28,200",
            "--mg", "2", "--polish", "32", "--out",
            str(work / "qpm.json")]))
        need("quality_per_ms", launches, "AFHBG")
        if len(recs) != 4 or not np.isfinite(
                [r[k] for r in recs for k in r if k != "name"]).all():
            raise SystemExit(f"quality_per_ms: {recs}")
        print(f"quality_per_ms: launches {launches}", flush=True)
        done()

        done = phase("make_dataset twin (2+1 scenes at 128^2, 16 frames) "
                     "and preprocess_data")
        seconds, launches = drive_counted(counters, lambda: make_dataset.main([
            "--out", str(work / "ds"), "--scenesTr", "2", "--scenesTe", "1",
            "--res", "128", "--framesPerScene", "16"]))
        need("make_dataset", launches, "AH")
        preprocess_data.main(["--dataDir", str(work / "ds"), "--dataset",
                              "plume_mg", "--out", str(work / "pre"),
                              "--stepsPerScene", "16"])
        frames = sorted((work / "pre").rglob("*.npz"))
        if len(seconds) != 3 or len(frames) != 3 * 16:
            raise SystemExit(f"make_dataset: {len(seconds)} scenes, "
                             f"{len(frames)} frames")
        for f in frames:
            with np.load(f) as z:
                if not all(np.isfinite(z[k]).all() for k in z.files):
                    raise SystemExit(f"preprocess_data: {f} not finite")
        print(f"make_dataset: {len(seconds)} scenes in "
              f"{sum(seconds):.1f} s, launches {launches}; preprocess_data: "
              f"{len(frames)} frames, finite", flush=True)
        done()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def dgrad_only(dev):
    """`python3 chip_smoke.py --dgrad-only`: the input gradient alone on
    every conv call of the tower, ScaleNet and PUNetD2_128's architecture
    at 128^2, batch 64 (grad_layer_rows without wgrad), and its sums."""
    for model in TRAIN_MODELS.values():
        net = seeded_net(model, dev)
        backward_results(grad_layer_rows(model, net, train_input(model, dev),
                                         dev, with_wgrad=False), model)
        del net
        torch.cuda.empty_cache()


def train_only(dev):
    """`python3 chip_smoke.py --train-only`: phase_train alone, then the
    kernels line of its three rows."""
    results = {}
    launches = phase_train(dev, results)
    print(json.dumps({"kernels": train_rows(results, launches)}))


# The multi-device phase (ROADMAP A.8): its sizes.
MULTI = dict(cyl=(CYL_W, CYL_H), cyl_steps=5, res2=RES, res3=RES3,
             steps3=3, train_res=TRAIN_RES, train_bsz=TRAIN_BSZ,
             train_steps=3, plume_res=128, plume_steps=20)
# Sharded against single-process steps on the scenes, as a share of each
# field's largest value (at least 1). Each slab traces in its own
# coordinates (fluidnet_cxx_tpu_torch/parallel/step.py), so a back-traced
# position may round apart from the whole grid's, and the sample with it.
# The differences are deterministic: on an H100 this phase measures
# 3.219e-5 of the largest value on the cylinder, 2.146e-6 on the 512^2
# plume and 3.471e-6 on the 128^3 plume; each tolerance is about three
# times that.
MULTI_STEP_TOL = dict(cylinder=1e-4, plume=7e-6, plume3d=1e-5)
# The DP train step against the single-process step on the whole batch:
# the loss terms (share of each term) and the gradient (relative L2 over
# every parameter).
MULTI_LOSS_TOL, MULTI_GRAD_TOL = 1e-5, 1e-4
MULTI_TIMEOUT_S, MULTI_JOIN_S = 180.0, 420.0


def _multi_timed(fn, dev):
    """(result, ms) of ``fn()`` by CUDA events."""
    torch.cuda.synchronize(dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def _multi_held(name, got, want, tol):
    """Raise unless ``got`` and ``want`` (tuples of tensors) are equal to
    the bit (``tol`` None) or agree within ``tol`` of each one's largest
    value (at least 1); returns (max error, max error as that share,
    whether every field is equal to the bit, the share of values that
    differ)."""
    err, rel, equal, differ, total = 0.0, 0.0, True, 0, 0
    for g, w in zip(got, want):
        g = g.to(w.device)
        e = float((g - w).abs().max())
        r = e / max(float(w.abs().max()), 1.0)
        same = bool(torch.equal(g, w))
        if (not bool(torch.isfinite(g).all())
                or (not same if tol is None else r > tol)):
            raise SystemExit(
                f"{name}: {e:.3e} ({r:.3e} of its largest value) from the "
                "single-process run (" + ("bit for bit" if tol is None
                                          else f"tolerance {tol}") + ")")
        err, rel = max(err, e), max(rel, r)
        equal = equal and same
        differ += int((g != w).sum())
        total += w.numel()
    return err, rel, equal, differ / total


def multi_dyadic(state, seed, scale, obstacles=False):
    """``state`` with a random U of std ``scale`` in multiples of 1/8 and
    a random density in [0, 1) (at dt 1/4 without the line trace, every
    back-traced position is exact in any coordinates), and with 8% random
    obstacles inside the border when ``obstacles``."""
    from fluidnet_cxx_tpu_torch.celltype import OBSTACLE

    g = torch.Generator().manual_seed(seed)
    dev = state.U.device
    U = torch.round(torch.randn(state.U.shape, generator=g) * scale * 8) / 8
    rho = torch.rand(state.density.shape, generator=g)
    out = state._replace(U=U.to(dev), density=rho.to(dev))
    if obstacles:
        flags = state.flags.clone()
        inner = flags[:, 1:-1, 1:-1]
        hit = torch.rand(inner.shape, generator=g) < 0.08
        inner[hit.to(dev)] = OBSTACLE
        out = out._replace(flags=flags)
    return out


def multidevice_nccl_rank(card):
    """One rank under NCCL on the card: an all_reduce and the sharded
    Jacobi solve at dp = sx = 1, held to kernel F bit for bit."""
    import torch.distributed as dist

    from fluidnet_cxx_tpu_torch.ops.kernels.jacobi import solve_jacobi
    from fluidnet_cxx_tpu_torch.parallel import (make_mesh,
                                                 solve_jacobi_sharded)

    mesh = make_mesh(1, backend="nccl", device="cuda")
    t = torch.arange(8, dtype=torch.float32, device=mesh.device)
    dist.all_reduce(t)
    if not torch.equal(t, torch.arange(8, dtype=torch.float32,
                                       device=mesh.device)):
        raise SystemExit(f"one-rank NCCL all_reduce gave {t}")
    flags, _, _ = stress_inputs(torch.Generator().manual_seed(SEED),
                                mesh.device, RES)
    div = torch.randn(flags.shape, generator=torch.Generator().manual_seed(
        SEED + 1)).to(mesh.device)
    got = solve_jacobi_sharded(flags, div, 34, mesh)
    if not torch.equal(got, solve_jacobi(flags, div, 34)):
        raise SystemExit("NCCL dp = sx = 1 Jacobi differs from kernel F")
    print(f"multi [1/7] NCCL one rank on {mesh.device}: all_reduce exact, "
          f"solve_jacobi_sharded at dp = sx = 1 bit-equal to F ({RES}^2, "
          f"34 sweeps); {card}", flush=True)


def multidevice_ranks(card):
    """Two gloo ranks on one card: the sharded Jacobi at sx = 2 on the
    cylinder's flags, the sharded cylinder and plume steps (on the scenes
    and from dyadic velocities), and the DP train step, each held to the
    single-process run in the same call. Rank 0 prints."""
    import dataclasses

    import torch.distributed as dist

    from fluidnet_cxx_tpu_torch.config import SimConfig, TrainConfig
    from fluidnet_cxx_tpu_torch.data.synthetic import generate_batch
    from fluidnet_cxx_tpu_torch.models.fluidnet import FluidNet
    from fluidnet_cxx_tpu_torch.ops.kernels.jacobi import solve_jacobi
    from fluidnet_cxx_tpu_torch.ops.stencils import velocity_divergence
    from fluidnet_cxx_tpu_torch.parallel import (
        batch_sharding, gather_state, make_mesh, simulate_step3_sharded,
        simulate_step_sharded, solve_jacobi_sharded, state_sharding)
    from fluidnet_cxx_tpu_torch.run_cylinder import cylinder_case
    from fluidnet_cxx_tpu_torch.run_plume import plume_case
    from fluidnet_cxx_tpu_torch.run_plume3d import plume3d_case
    from fluidnet_cxx_tpu_torch.sim.step import simulate_step
    from fluidnet_cxx_tpu_torch.sim.step3d import simulate_step3
    from fluidnet_cxx_tpu_torch.train.trainer import (
        Batch, init_train_state, make_loss_fn, make_train_step)

    torch.set_num_threads(1)
    rank = dist.get_rank()
    sx_mesh = make_mesh(2, dp=1, sx=2, backend="gloo", device="cuda")
    dev = sx_mesh.device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = launch_counters()

    def say(line):
        if rank == 0:
            print(f"multi {line}; {card}", flush=True)

    def launches_of_run(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        return out, {k: c.launches for k, c in counters.items()
                     if c.launches}

    # [2/7] The sharded Jacobi on the cylinder's flags.
    w, h = MULTI["cyl"]
    cfg, state, _ = cylinder_case(w, h, dev)
    flags = state.flags
    div = velocity_divergence(state.U, flags)
    reps = 5

    def single_solve():
        for _ in range(reps):
            p = solve_jacobi(flags, div, 34)
        return p
    want, want_ms = None, 0.0
    if rank == 0:
        single_solve()
        want, want_ms = _multi_timed(single_solve, dev)
    dist.barrier()
    f_s, d_s = state_sharding(sx_mesh, flags), state_sharding(sx_mesh, div)
    solve_jacobi_sharded(f_s, d_s, 34, sx_mesh)
    sx_mesh.exchanges = sx_mesh.solver_calls = 0

    def sharded_solve():
        for _ in range(reps):
            p = solve_jacobi_sharded(f_s, d_s, 34, sx_mesh)
        return p
    p, ms = _multi_timed(sharded_solve, dev)
    counts = (sx_mesh.exchanges // reps, sx_mesh.solver_calls // reps)
    got = gather_state(sx_mesh, p)
    if rank == 0 and not torch.equal(got, want):
        raise SystemExit("solve_jacobi_sharded at sx = 2 differs from F on "
                         "the whole grid")
    say(f"[2/7] solve_jacobi_sharded sx = 2 on the {w}x{h} cylinder's "
        f"flags, 34 sweeps: bit-equal to F on the whole grid; "
        f"{counts[0]} exchanges and {counts[1]} F calls a solve; "
        f"{ms / reps:.3f} ms a solve (rank 0, both ranks on one card; "
        f"mean of {reps} after one) against F's {want_ms / reps:.3f} ms")

    def step_pair(label, n, step, sharded, cfg, state, fields, kernels,
                  tol):
        """n steps from ``state``, single-process on rank 0 and sharded,
        each timed after one warm-up step whose result is dropped, held
        within ``tol`` (None: bit for bit)."""
        ref, ref_ms = None, 0.0
        if rank == 0:
            def single():
                s = state
                for _ in range(n):
                    s = step(cfg, s)
                return s
            step(cfg, state)
            ref, ref_ms = _multi_timed(single, dev)
        dist.barrier()
        start = state_sharding(sx_mesh, state)

        def run():
            s = start
            for _ in range(n):
                s = sharded(cfg, s, sx_mesh)
            return s
        sharded(cfg, start, sx_mesh)
        (out, ms), launches = launches_of_run(lambda: _multi_timed(run, dev))
        missed = [k for k in kernels if k not in launches]
        if missed:
            raise SystemExit(f"{label}: the sharded step missed kernels "
                             f"{missed}: {launches}")
        got = gather_state(sx_mesh, out)
        if rank == 0:
            err, rel, equal, share = _multi_held(
                label, [getattr(got, f) for f in fields],
                [getattr(ref, f) for f in fields], tol)
            held = ("held bit for bit" if tol is None
                    else f"tolerance {tol:.3g} of the largest value")
            say(f"{label}: sx = 2, {n} steps, {ms / n:.3f} ms/step sharded "
                f"(rank 0) against {ref_ms / n:.3f} single-process; max "
                f"|sharded - single| {err:.3e}, {rel:.3e} of the largest "
                f"value ({'bit-equal' if equal else f'{share:.2e} of values differ'}"
                f"; {held}); launches a step on rank 0 "
                f"{ {k: v / n for k, v in launches.items()} }")

    # Each case on its scene (within MULTI_STEP_TOL), then one step from
    # a dyadic velocity at dt 1/4 without the line trace (bit for bit).
    dyadic = dict(dt=0.25, line_trace=False)
    with torch.no_grad():
        step_pair(f"[3/7] cylinder {w}x{h} jacobi-34", MULTI["cyl_steps"],
                  simulate_step, simulate_step_sharded, cfg, state,
                  ("p", "U"), "EF", MULTI_STEP_TOL["cylinder"])
        step_pair(f"[3/7] cylinder {w}x{h} jacobi-34, dyadic", 1,
                  simulate_step, simulate_step_sharded,
                  dataclasses.replace(cfg, **dyadic),
                  multi_dyadic(state, SEED + 6, 12.0),
                  ("p", "U"), "EF", None)
        del state, flags, div, f_s, d_s, p, got, want
        r2 = MULTI["res2"]
        cfg2, state2, _ = plume_case(r2, dev, sim_method="jacobi")
        step_pair(f"[3/7] plume {r2}^2 jacobi-200 (use_pallas: A, F)",
                  MULTI["cyl_steps"], simulate_step, simulate_step_sharded,
                  cfg2, state2, ("p", "U", "density"), "AF",
                  MULTI_STEP_TOL["plume"])
        step_pair(f"[3/7] plume {r2}^2 jacobi-200 (use_pallas: A, F), "
                  "dyadic with 8% obstacles and vorticity confinement", 1,
                  simulate_step, simulate_step_sharded,
                  dataclasses.replace(cfg2, vorticity_confinement=0.2,
                                      **dyadic),
                  multi_dyadic(state2, SEED + 4, 20.0, obstacles=True),
                  ("p", "U", "density"), "AF", None)
        del state2
        r3 = MULTI["res3"]
        for fused, kernels in ((True, "LI"), (False, "KMI")):
            cfg3, state3 = plume3d_case(r3, dev, fuse_advection=fused,
                                        line_trace=fused)
            label = (f"[4/7] plume3d {r3}^3 jacobi-60 "
                     f"{'merged with the trace' if fused else 'unfused'}"
                     f" ({', '.join(kernels)})")
            step_pair(label, MULTI["steps3"], simulate_step3,
                      simulate_step3_sharded, cfg3, state3,
                      ("p", "U", "density"), kernels,
                      MULTI_STEP_TOL["plume3d"])
            step_pair(label.replace(" with the trace", "") + ", dyadic "
                      "with vorticity confinement", 1, simulate_step3,
                      simulate_step3_sharded,
                      dataclasses.replace(cfg3, vorticity_confinement=0.2,
                                          **dyadic),
                      multi_dyadic(state3, SEED + 8, 6.0),
                      ("p", "U", "density"), kernels, None)
            del state3

    # [5/7] The DP train step: the tower at train_res^2, batch train_bsz.
    dp_mesh = make_mesh(2, dp=2, sx=1, backend="gloo", device="cuda")
    res, bsz = MULTI["train_res"], MULTI["train_bsz"]
    tc, sc = TrainConfig(), SimConfig()
    model = FluidNet(train_cfg("FluidNet")).to(dev)
    ts = init_train_state(model, tc, seed=0)
    train_step, _ = make_train_step(model, sc, tc, mesh=dp_mesh)
    gen = torch.Generator(device=dev).manual_seed(4321)
    with torch.no_grad():
        batch = Batch(*generate_batch(gen, bsz, res, res, 600, dev))
    shard = batch_sharding(dp_mesh, batch)
    host_gen = torch.Generator().manual_seed(4321)
    ref_model = FluidNet(train_cfg("FluidNet")).to(dev)
    ref_loss = make_loss_fn(ref_model, sc, tc)
    worst_loss = worst_grad = 0.0
    dp_ms = ref_ms = 0.0
    tcounters = train_counters()
    dp_launches = dict.fromkeys(tcounters, 0)
    for it in range(MULTI["train_steps"]):
        for c in tcounters.values():
            c.launches = 0
        before = {k: v.detach().clone()
                  for k, v in model.net.state_dict().items()}
        (_, terms), ms = _multi_timed(
            lambda: train_step(ts, shard, host_gen), dev)
        dp_ms += ms
        for k, c in tcounters.items():
            dp_launches[k] += c.launches
        grads = [p.grad.detach().clone() for p in model.net.parameters()]
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.net.parameters()])
        both = gather_state(dp_mesh, flat[None])
        if not torch.equal(both[0], both[1]):
            raise SystemExit(f"DP step {it}: the ranks' parameters differ")
        if rank == 0:
            ref_model.net.load_state_dict(before)
            ref_model.net.zero_grad(set_to_none=True)

            def single():
                total, t = ref_loss(batch, draw=train_step.last_draw)
                total.backward()
                return t
            want_terms, ms = _multi_timed(single, dev)
            ref_ms += ms
            for g, w_ in zip(terms, want_terms):
                w_ = w_.detach()
                e = float((g - w_).abs()) / max(float(w_.abs()), 1e-12)
                worst_loss = max(worst_loss, e if float(w_.abs()) > 0
                                 else float(g.abs()))
            # Over the whole gradient: some are rounding noise about 0
            # (convOut's bias), where a per-tensor ratio means nothing.
            g_dp = torch.cat([g.reshape(-1) for g in grads])
            g_ref = torch.cat([p.grad.reshape(-1)
                               for p in ref_model.net.parameters()])
            worst_grad = max(worst_grad, float(
                torch.linalg.vector_norm(g_dp - g_ref)
                / torch.linalg.vector_norm(g_ref)))
            if worst_loss > MULTI_LOSS_TOL or worst_grad > MULTI_GRAD_TOL:
                raise SystemExit(
                    f"DP step {it}: loss terms {worst_loss:.3e} (tolerance "
                    f"{MULTI_LOSS_TOL}), gradients {worst_grad:.3e} relative "
                    f"L2 (tolerance {MULTI_GRAD_TOL}) from the "
                    "single-process step on the whole batch")
        dist.barrier()
    n = MULTI["train_steps"]
    say(f"[5/7] DP train step, FluidNetTower {res}^2 batch {bsz} (dp = 2, "
        f"{bsz // 2} a rank), LT on, {n} steps: loss terms within "
        f"{worst_loss:.2e} of each term and gradients within "
        f"{worst_grad:.2e} relative L2 of the single-process step on the "
        f"whole batch, parameters bit-equal on both ranks; "
        f"{dp_ms / n:.2f} ms/step DP (rank 0, both ranks on one card) "
        f"against {ref_ms / n:.2f} ms for the single-process loss and "
        f"backward; launches a DP step on rank 0 "
        f"{ {k: v / n for k, v in dp_launches.items()} }")


# The sharded A.8.1 cases against the single-process step, as a share of
# each field's largest value (at least 1). The V-cycle's means and the
# learned projections' input scale sum in another order than one device's
# (the bfloat16 nets, MGCoarse_128 and PUNet3p8_64, round that difference
# up to a bf16 ulp here and there); the gather engine's slabs trace in
# their own coordinates, as the window engine's do. On an H100 this phase
# measures the readings beside each case; each tolerance is about three
# times its own case's reading.
MULTI_A81_TOL = dict(
    cyl_mg=1e-4,        # 3.405e-5
    cyl_punet=8e-5,     # 2.588e-5
    rt_mg=4e-5,         # 1.174e-5
    mg_learned=5e-3,    # 1.594e-3
    plume_punet=1e-5,   # 3.368e-6
    tower=5e-6,         # 1.553e-6
    gather=1e-5,        # 2.980e-6
    mg3=1e-5,           # 3.166e-6
    punet3=1e-3)        # 3.584e-4
MULTI_A81_STEPS = dict(two_d=3, three_d=2)


def reach_held(project, state):
    """The reach of a learned projection, held directly: the projection
    on rank 0's slab of sx = 2 with its halo and ``align`` more columns
    each side (taken around the grid), run again with every input column
    beyond the halo perturbed (p, U, density and 10% of the fluid cells
    made obstacles). Returns the largest change of the owned columns' p
    and of U's owned columns and OUT_HALO more: 0.0 when the halo covers
    what the owned outputs read. The scale is fixed at 1 (the sharded
    step hands in the global one); before the sharded "mg" polish the
    net's own output is compared."""
    from fluidnet_cxx_tpu_torch.parallel.project import (OUT_HALO,
                                                         sharding_of)

    sh = sharding_of(project)
    W = state.flags.shape[-1]
    wl, e, g = W // 2, sh.align, sh.halo
    dev = state.flags.device
    cols = torch.remainder(torch.arange(-g - e, wl + g + e), W).to(dev)
    sl = lambda t: t.index_select(-1, cols).contiguous()  # noqa: E731
    p, U, flags, density = (sl(t) for t in (state.p, state.U, state.flags,
                                            state.density))
    kw = dict(scale=torch.ones(p.shape[0], device=dev))
    if sh.kind == "fused3":
        kw["grid"] = tuple(state.flags.shape[1:])
    if sh.polish == "mg":
        kw["net_only"] = True
    gen = torch.Generator().manual_seed(SEED + 29)
    far = torch.ones(cols.numel(), dtype=torch.bool)
    far[e:e + 2 * g + wl] = False
    far = far.to(dev)

    def noise(t):
        return torch.randn(t.shape, generator=gen).to(dev)

    flip = (noise(flags) > 1.28) & (flags == 1) & far
    moved = (p + far * noise(p),
             U + far * noise(U) * max(float(U.abs().max()), 1.0),
             flags.masked_fill(flip, 2), density + far * noise(density))
    a, b = e + g, e + g + wl
    outs = [project(*args, **kw) for args in ((p, U, flags, density), moved)]
    if sh.polish == "mg":
        return float((outs[0] - outs[1])[..., a:b].abs().max())
    (p0, U0), (p1, U1) = outs
    return max(float((p0 - p1)[..., a:b].abs().max()),
               float((U0 - U1)[..., a - OUT_HALO:b + OUT_HALO].abs().max()))


def multidevice_a81_ranks(card, out_path):
    """Two gloo ranks on one card at sx = 2 (ROADMAP A.8.1): the 8000x800
    cylinder under multigrid (E, H's slab entries) and PUNetD2_128 (E, B,
    C); the 512^2 plume under mg_learned with MGCoarse_128 (A, G's slab
    entries, B's bfloat16 route), PUNetD2_128 fused (A, B, C) and
    DataTrain_128 on the flax path (A, B), and on the gather engine (F);
    the 128x512 Rayleigh-Taylor box under multigrid (A, G's slab entries);
    the 128^3 plume under solve_mg3 (L, I) and PUNet3p8_64 fused (K, M, N,
    J); each against the single-process step in the same call, with
    trained weights. Rank 0 prints, and writes the slab entries' launches
    in the run of the cylinder's sharded multigrid steps to
    ``out_path``."""
    import dataclasses
    import json
    from pathlib import Path

    import torch.distributed as dist

    from fluidnet_cxx_tpu_torch.parallel import (
        gather_state, make_mesh, simulate_step3_sharded,
        simulate_step_sharded, state_sharding, step_halo)
    from fluidnet_cxx_tpu_torch.parallel.project import (receptive_halo,
                                                         sharding_of)
    from fluidnet_cxx_tpu_torch.parallel.step import gather_disp
    from fluidnet_cxx_tpu_torch.run_cylinder import cylinder_case
    from fluidnet_cxx_tpu_torch.run_plume import plume_case
    from fluidnet_cxx_tpu_torch.run_plume3d import (learned3d_case,
                                                    plume3d_case)
    from fluidnet_cxx_tpu_torch.run_rayleigh_taylor import rt_case
    from fluidnet_cxx_tpu_torch.sim.step import simulate_step
    from fluidnet_cxx_tpu_torch.sim.step3d import simulate_step3

    torch.set_num_threads(1)
    rank = dist.get_rank()
    mesh = make_mesh(2, dp=1, sx=2, backend="gloo", device="cuda")
    dev = mesh.device
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {**launch_counters(), **slab_counters()}
    slab_launches = {}

    def say(line):
        if rank == 0:
            print(f"multi A.8.1 {line}; {card}", flush=True)

    def pair(label, n, three_d, cfg, state, project, kernels, tol):
        step = simulate_step3 if three_d else simulate_step
        sharded = simulate_step3_sharded if three_d else \
            simulate_step_sharded
        ref, ref_ms, moved = None, 0.0, None
        learned = project is not None and project.kind != "mg_learned"
        if rank == 0:
            if learned:
                moved = reach_held(project, state)
                if moved != 0.0:
                    raise SystemExit(
                        f"{label}: the owned columns moved by {moved:.3e} "
                        "when the inputs beyond the projection's halo "
                        "changed: the halo is short of its reach")
            def single():
                s = state
                for _ in range(n):
                    s = step(cfg, s, project)
                return s
            step(cfg, state, project)
            ref, ref_ms = _multi_timed(single, dev)
        dist.barrier()
        start = state_sharding(mesh, state)

        def run():
            s = start
            for _ in range(n):
                s = sharded(cfg, s, mesh, project)
            return s
        sharded(cfg, start, mesh, project)
        for c in counters.values():
            c.launches = 0
        mesh.exchanges = 0
        out, ms = _multi_timed(run, dev)
        totals = {k: c.launches for k, c in counters.items() if c.launches}
        launches = {k: v // n for k, v in totals.items()}
        exchanges = mesh.exchanges / n
        missed = [k for k in kernels if k not in launches]
        if missed:
            raise SystemExit(f"{label}: the sharded step missed kernels "
                             f"{missed}: {launches}")
        got = gather_state(mesh, out)
        if "Gd" in kernels and not slab_launches:
            slab_launches.update(totals)
        # Every rank: the gather engine's halo takes an all_reduce.
        halo = (step_halo(cfg, three_d, gather_disp(mesh, state.U, cfg.dt))
                if cfg.advection_impl == "gather"
                else step_halo(cfg, three_d))
        if rank == 0:
            fields = ("p", "U", "density") if cfg.advect_density else (
                "p", "U")
            err, rel, equal, share = _multi_held(
                label, [getattr(got, f) for f in fields],
                [getattr(ref, f) for f in fields], tol)
            extra = ""
            if project is not None:
                sh = sharding_of(project)
                extra = (f", mg_learned exchange {sh.halo}" if not learned
                         else f", projection halo {sh.halo} (reach "
                         f"{receptive_halo(project.net.table, getattr(project.net, 'patch', None))[0]}, "
                         f"alignment {sh.align}; inputs beyond it perturbed"
                         f": owned outputs moved {moved})")
            say(f"{label}: sx = 2, {n} steps, {ms / n:.3f} ms/step sharded "
                f"(rank 0, two ranks on one card: no scaling) against "
                f"{ref_ms / n:.3f} single-process; step halo {halo}"
                f"{' (the first step: D from its U)' if cfg.advection_impl == 'gather' else ''}"
                f"{extra}; "
                f"{exchanges:.0f} exchanges a step; max |sharded - single| "
                f"{err:.3e}, {rel:.3e} of the largest value "
                f"({'bit-equal' if equal else f'{share:.2e} of values differ'}"
                f"; tolerance {tol}); launches a step on rank 0 {launches}")

    n2, n3 = MULTI_A81_STEPS["two_d"], MULTI_A81_STEPS["three_d"]
    tol = MULTI_A81_TOL
    w, h = MULTI["cyl"]
    r2 = MULTI["res2"]
    with torch.no_grad():
        cfg, state, _ = cylinder_case(w, h, dev, sim_method="multigrid")
        pair(f"cylinder {w}x{h} multigrid (E, H's slab entries)", n2,
             False, cfg, state, None, ("E", "Gd", "Gu", "Ge", "Gt", "Gs"),
             tol["cyl_mg"])
        cfg, state, project = cylinder_case(w, h, dev, sim_method="convnet")
        pair(f"cylinder {w}x{h} PUNetD2_128 (E, B, C)", n2, False, cfg,
             state, project, "EBC", tol["cyl_punet"])
        del state
        cfg, state = rt_case(RT_W, RT_H, dev, sim_method="multigrid")
        pair(f"RT {RT_W}x{RT_H} multigrid (A, G's slab entries)", n2, False,
             cfg, state, None, ("A", "Gd", "Gu", "Ge", "Gt"),
             tol["rt_mg"])
        cfg, state, project = plume_case(r2, dev, sim_method="mg_learned")
        pair(f"plume {r2}^2 mg_learned MGCoarse_128 (A, G's slab entries, "
             "B bf16)", n2, False, cfg, state, project,
             ("A", "B", "Gd", "Gu", "Ge"), tol["mg_learned"])
        cfg, state, project = plume_case(r2, dev, sim_method="convnet")
        pair(f"plume {r2}^2 PUNetD2_128 fused (A, B, C)", n2, False, cfg,
             state, project, "ABC", tol["plume_punet"])
        cfg, state, project = plume_case(
            r2, dev, model_dir=Path("trained_models/DataTrain_128"))
        pair(f"plume {r2}^2 DataTrain_128 flax path (A, B)", n2, False, cfg,
             state, project, "AB", tol["tower"])
        cfg, state, _ = plume_case(r2, dev, sim_method="jacobi")
        cfg = dataclasses.replace(cfg, use_pallas=False,
                                  advection_impl="gather")
        pair(f"plume {r2}^2 gather engine jacobi-200 (F)", n2, False, cfg,
             state, None, "F", tol["gather"])
        del state
        r3 = MULTI["res3"]
        cfg, state = plume3d_case(r3, dev, fuse_advection=True,
                                  line_trace=True, sim_method="multigrid")
        pair(f"plume3d {r3}^3 solve_mg3 merged (L, I)", n3, True, cfg,
             state, None, "LI", tol["mg3"])
        cfg, state, project = learned3d_case(r3, dev, model_dir=MODEL_P8)
        pair(f"plume3d {r3}^3 PUNet3p8_64 fused (K, M, N, J)", n3, True,
             cfg, state, project, "KMNJ", tol["punet3"])
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(slab_launches, f)


def phase_multidevice(card):
    """Multi-device (ROADMAP A.8): [1/7] one NCCL rank on the card;
    [2/7]-[5/7] two gloo ranks sharing cuda:0 (NCCL refuses two ranks on
    one device; they load the built library, never rebuild):
    solve_jacobi_sharded at sx = 2 on the cylinder's flags bit for bit,
    the 8000x800 cylinder (E, F), the 512^2 plume under use_pallas (A, F)
    and the 128^3 plume3d merged (L, I) and unfused (K, M, I) sharded at
    sx = 2 against the single-process steps (on the scenes within
    MULTI_STEP_TOL, from dyadic velocities bit for bit), the DP train
    step against
    the single-process one; [6/7] the parallel.dryrun twin with --nproc 2 --backend gloo;
    [7/7] the plume twin without --fast (the march trace) at 128^2. Two
    ranks on one card measure no scaling: the times show the overhead of
    the exchanges, not a speed-up."""
    import tempfile
    from pathlib import Path

    from fluidnet_cxx_tpu_torch.parallel.launch import spawn

    done = phase("multi-device (A.8)")
    print(f"multi: two ranks share one card here, so no time below "
          f"measures scaling; {card}", flush=True)
    spawn(multidevice_nccl_rank, 1, (card,), backend="nccl",
          timeout_s=MULTI_TIMEOUT_S, join_s=MULTI_JOIN_S)
    spawn(multidevice_ranks, 2, (card,), backend="gloo",
          timeout_s=MULTI_TIMEOUT_S, join_s=MULTI_JOIN_S)
    with tempfile.TemporaryDirectory() as work:
        out_path = str(Path(work) / "slab_launches.json")
        spawn(multidevice_a81_ranks, 2, (card, out_path), backend="gloo",
              timeout_s=MULTI_TIMEOUT_S, join_s=MULTI_JOIN_S)
        with open(out_path) as f:
            slab_launches = json.load(f)

    cmd = [sys.executable, "-m", "fluidnet_cxx_tpu_torch.parallel.dryrun",
           "--nproc", "2", "--backend", "gloo", "--device", "cuda",
           "--timeout", str(MULTI_TIMEOUT_S)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=MULTI_JOIN_S)
    if out.returncode != 0 or "dryrun_multichip OK" not in out.stdout:
        raise SystemExit(f"parallel.dryrun failed ({out.returncode}):\n"
                         f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    print(out.stdout.strip(), flush=True)
    print(f"multi [6/7] parallel.dryrun --nproc 2 --backend gloo OK in "
          f"{time.perf_counter() - t0:.1f} s (spawn included); {card}",
          flush=True)

    from fluidnet_cxx_tpu_torch.config import dump_yaml, load_yaml
    from fluidnet_cxx_tpu_torch.scripts import run_plume as twin

    counters = launch_counters()
    with tempfile.TemporaryDirectory() as work:
        res, n = MULTI["plume_res"], MULTI["plume_steps"]
        conf = dict(load_yaml("configs/plume.yaml"), realTimePlot=False,
                    statIter=n)
        path = str(Path(work) / "plume.yaml")
        dump_yaml(conf, path)
        for c in counters.values():
            c.launches = 0
        r = twin.main(["--simConf", path, "--resX", str(res), "--resY",
                       str(res), "--maxIter", str(n), "--outputFolder",
                       str(Path(work) / "out"), "--device", "cuda"])
        launches = {k: c.launches / n for k, c in counters.items()
                    if c.launches}
    if not r["finite"] or "A" in launches or "E" not in launches:
        raise SystemExit(f"plume twin without --fast: finite {r['finite']},"
                         f" launches a step {launches}")
    print(f"multi [7/7] scripts.run_plume without --fast (the march trace "
          f"on the torch engines, the velocity on E), {res}^2, {n} steps: "
          f"{r['ms_per_step']:.3f} ms/step with outputs, mean|div| "
          f"{r['mean_div']:.4g}; launches a step {launches}; {card}",
          flush=True)
    done()
    return slab_launches


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)

    done = phase("card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    done()

    done = phase("build (nvcc)")
    from fluidnet_cxx_tpu_torch.ops.kernels import _build
    _build.build(ptxas_verbose=True)
    _build.library()
    # M's march takes its rings as dynamic shared memory, which -Xptxas -v
    # does not count (a checkout from before the march has no such query).
    if "fn_advect3_velocity_smem" in _build.QUERIES:
        for orig in (0, 1):
            print(f"M (vel3_march<D, true, {bool(orig)}>, the backward rings"
                  f"{' with orig' if orig else ''}) dynamic shared memory a "
                  "block: " + ", ".join(
                      f"D={d} "
                      f"{_build.query('fn_advect3_velocity_smem', d, orig)} B"
                      for d in range(1, _build.query(
                          "fn_advect3_velocity_max_disp", orig) + 1)),
                  flush=True)
    if "fn_advect_tile_smem" in _build.QUERIES:
        from fluidnet_cxx_tpu_torch.ops.kernels.advect import TILES
        print("E (advect_tile) dynamic shared memory a block: " + "; ".join(
            f"max_disp {D} " + ", ".join(
                f"{tw}x{th} {_build.query('fn_advect_tile_smem', tw, th, D)}"
                for tw, th in TILES)
            for D in (4, _build.constant("fn_advect_max_disp"))), flush=True)
    done()

    dev = torch.device("cuda")
    # The plain versions and the float32 library chains in full float32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:] == ["--mg-only"]:
        mg_only(dev)
        return
    if sys.argv[1:] == ["--3d-only"]:
        threed_only(dev)
        return
    if sys.argv[1:] == ["--adv-only"]:
        adv_only(dev)
        return
    if sys.argv[1:] == ["--tail-only"]:
        tail_only(dev)
        return
    if sys.argv[1:] == ["--learned-only"]:
        learned_only(dev)
        return
    if sys.argv[1:] == ["--nets-only"]:
        nets_only(dev)
        return
    if sys.argv[1:] == ["--train-only"]:
        train_only(dev)
        return
    if sys.argv[1:] == ["--dgrad-only"]:
        dgrad_only(dev)
        return
    if sys.argv[1:] == ["--drivers-only"]:
        phase_drivers()
        return
    if sys.argv[1:] == ["--train3d-only"]:
        train3d_only(dev)
        return
    if sys.argv[1:] == ["--mg-coarse-only"]:
        mg_coarse_only(dev)
        return
    if sys.argv[1:] == ["--engines-only"]:
        phase_engines(launch_counters())
        return
    if sys.argv[1:] == ["--multi-only"]:
        phase_slab_kernels(dev, {})
        phase_multidevice(card)
        return
    results = {}
    phase_kernels(dev, results)
    phase_solvers(dev, results)
    phase_mg(dev, results)
    phase_slab_kernels(dev, results)
    phase_mg_learned(dev, results)
    phase_nets(dev, results)
    phase_cylinder_kernels(dev, results)
    phase_kernels3d(dev, results)
    phase_learned3d(dev, results)
    phase_new3d(dev, results)
    phase_small_check()

    counters = launch_counters()
    seen = phase_main_paths(counters)
    paths = main_paths()
    for name, (_, case, _) in paths.items():
        phase_profile(name, case)
    phase_bench()
    train_launches = phase_train(dev, results)
    train3d_launches = phase_train3d(dev, results)
    bf16_launches = phase_train_bf16(dev, results)
    phase_drivers()
    phase_engines(counters)
    slab_launches = phase_multidevice(card)

    # Launches of each kernel on the first main path that must launch it.
    path_of = {k: next(name for name, (_, _, ks) in paths.items() if k in ks)
               for k in counters}
    meta = {
        "A": ("advect_all", "fluidnet_cxx_tpu_torch/csrc/advect_all.cu",
              "fluidnet_cxx_tpu/ops/pallas/advect_pallas.py:715"),
        "B": ("punet_conv2d", "fluidnet_cxx_tpu_torch/csrc/conv2d.cu",
              "fluidnet_cxx_tpu/ops/pallas/punet_pallas.py:366"),
        "C": ("project_tail", "fluidnet_cxx_tpu_torch/csrc/jacobi.cu",
              "fluidnet_cxx_tpu/ops/pallas/proj_tail_pallas.py:164"),
        "D": ("advect_scalar", "fluidnet_cxx_tpu_torch/csrc/advect_all.cu",
              "fluidnet_cxx_tpu/ops/pallas/advect_pallas.py:516"),
        "E": ("advect_velocity", "fluidnet_cxx_tpu_torch/csrc/advect_all.cu",
              "fluidnet_cxx_tpu/ops/pallas/advect_pallas.py:207"),
        "F": ("solve_jacobi", "fluidnet_cxx_tpu_torch/csrc/jacobi.cu",
              "fluidnet_cxx_tpu/ops/pallas/jacobi_pallas.py:68"),
        "G": ("solve_mg", "fluidnet_cxx_tpu_torch/csrc/mg.cu",
              "fluidnet_cxx_tpu/ops/pallas/mg_pallas.py:190"),
        "H": ("project_mg", "fluidnet_cxx_tpu_torch/csrc/mg.cu",
              "fluidnet_cxx_tpu/ops/pallas/mg_pallas.py:340"),
        "I": ("solve_jacobi3", "fluidnet_cxx_tpu_torch/csrc/jacobi3.cu",
              "fluidnet_cxx_tpu/ops/pallas/jacobi3_pallas.py:76"),
        "J": ("project_tail3", "fluidnet_cxx_tpu_torch/csrc/jacobi3.cu",
              "fluidnet_cxx_tpu/ops/pallas/proj_tail3_pallas.py:135"),
        "K": ("advect_scalar3", "fluidnet_cxx_tpu_torch/csrc/advect3.cu",
              "fluidnet_cxx_tpu/ops/pallas/advect3_pallas.py:285"),
        "L": ("advect_all3", "fluidnet_cxx_tpu_torch/csrc/advect3.cu",
              "fluidnet_cxx_tpu/ops/pallas/advect3_pallas.py:491"),
        "M": ("advect_velocity3", "fluidnet_cxx_tpu_torch/csrc/advect3.cu",
              "fluidnet_cxx_tpu/ops/pallas/advect3_pallas.py:693"),
        "N": ("punet3_conv3d", "fluidnet_cxx_tpu_torch/csrc/conv3d.cu",
              "fluidnet_cxx_tpu/ops/pallas/punet3_pallas.py:358"),
    }
    # Rows of this slice's shapes: (result, name, the kernel's row, its
    # counter, the main path that gives the launches).
    extra = [("G learned", "solve_mg_learned", "G", LEARNED_G,
              f"plume {RES}^2 mg_learned"),
             ("B mg_coarse", "punet_conv2d_bf16_mg_coarse_128", "B", "B",
              f"plume {RES}^2 mg_learned"),
             ("B cylinder", "punet_conv2d_1000x100", "B", "B",
              f"cylinder {CYL_W}x{CYL_H} convnet"),
             ("H cylinder", "project_mg_8000x800", "H", "H",
              f"cylinder {CYL_W}x{CYL_H} multigrid"),
             ("C cylinder", "project_tail_8000x800", "C", "C",
              f"cylinder {CYL_W}x{CYL_H} convnet"),
             ("B tower", "punet_conv2d_fluidnet_tower_512", "B", "B",
              f"plume {RES}^2 DataTrain_128"),
             ("B scalenet", "punet_conv2d_multiscalenet_512", "B", "B",
              f"plume {RES}^2 ScaleNet_jets_128"),
             ("M orig", "advect_velocity3_orig", "M", "Mo",
              f"cylinder3d {CYL3_D}x{CYL3_H}x{CYL3_W} jacobi-34"),
             ("N flax", "punet3_conv3d_flax_bf16", "N", "Nf",
              f"plume3d {RES3}^3 convnet flax p8")]
    rows = [(k, *meta[k], k, path_of[k]) for k in meta]
    rows += [(r, name, *meta[k][1:], c, path)
             for r, name, k, c, path in extra]
    kernels = []
    for key, name, source, replaces, counter, path in rows:
        r = results[key]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": seen[path][counter],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    for key, name, counter, row in SLAB_ROWS:
        r = results[key]
        kernels.append({"name": name, "route": "cuda",
                        "source": meta[row][1], "replaces": meta[row][2],
                        "launches": slab_launches[counter],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    kernels += train_rows(results, train_launches)
    kernels += train3d_rows(results, train3d_launches)
    kernels += train_bf16_rows(results, bf16_launches)
    print(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
