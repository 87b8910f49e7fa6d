// Kernel B: one NHWC 2-D convolution (any odd kernel: 1, 3 and 5 run;
// stride 1 or 2, dilation 1 or 2, flax SAME padding) with fused bias and
// ReLU, float32 products and sums. A net's forward launches it once per
// layer (ops/kernels/punet.py::net_forward): 14 times at PUNetD2_128's
// widths, 10 for FluidNetTower, 17 for MultiScaleNet, whose 1-16 channel
// layers reach it padded with zero channels to the 32-channel stage.
//
// Replaces fluidnet_cxx_tpu/ops/pallas/punet_pallas.py::punet_forward_pallas
// (body _punet_kernel), which computes every conv of the U-Net as MXU
// matmuls inside one kernel (float32 operands through `_mm`). Its plain
// version is the port's PUNet module (models/punet.py, F.conv2d per
// layer).
//
// What bounds it on an H100: operations. The 512^2 forward is 3.834 GFLOP
// of float32 multiply-adds, 57 us at 67 TFLOP/s without tensor cores, or
// 3 x 3.834 GFLOP at the 495 TFLOP/s TF32 tensor-core rate (23 us) in the
// 3xTF32 form below; its activations are at most 64x64x192 floats (3 MB)
// and its weights 1.6 MB. What sets its time in practice is filling 132
// SMs: the 16^2 level has 256 output pixels.
//
// Design (csrc/conv_mma.cuh, shared with kernel N): an implicit GEMM on
// the tile and split-K plan of ops/kernels/conv_plan.py, so every layer
// launches at least a wave of blocks (the 16^2 layers split K 18 ways and
// add the float32 partials in a fixed order), K staged 32 channels at a
// time through a 4-stage cp.async ring whose zero-fill copies stand for
// the SAME padding; the dilation is in the gather. The products run on the
// tensor cores in 3xTF32, which keeps float32 accuracy (plain TF32 keeps
// 11 significand bits, not this function): each operand x is split as it
// leaves shared memory into big = tf32(x) and small = tf32(x - big)
// (cvt.rna; x - big is exact, and -fmad=false keeps it so), and mma.sync
// m16n8k8 tf32 accumulates small*big + big*small + big*big in float32;
// the dropped small*small term is below 2^-21 of the product. The tensor
// cores sum each 32-channel chunk from zero and the chunk's sum joins the
// float32 accumulator by an ordinary add: summed in the tensor cores over
// all of K (1728 at the 64^2 concat) the layer missed the check at 1e-5
// of its largest output that it passes at 1e-6 this way. The input
// normalisation (in_scale on x1's channels c % scale_mod == 0) multiplies
// before the split, as the plain version multiplies before its conv. The
// skip concat is a second input pointer (channels [x1 | x2], as punet.py
// concatenates [upsampled, skip]).
//
// A second entry shares the gather and the epilogue: fn_conv2d_bf16 is
// B's bfloat16 route (MGCoarse_128 as flax runs it): conv_mma.cuh's
// tensor-core body conv_tc (kernel N's) with B's dilation, the epilogue
// rounding the float32 sum to bfloat16 before the bias add and again
// after it, as JAX does on the CPU. Bound on an H100 by operations (0.089
// GFLOP a 128^2 forward, 0.1 us at the dense bf16 rate); in practice by
// launches on 16^2 and 8^2 maps. The input gradient of this conv is
// conv2d_dgrad.cu's, the weight gradient conv2d_grad.cu's.
#include "conv_mma.cuh"

namespace {

using namespace fnk::conv;

// Shared-memory rows of one stage: an A row of kChunk floats + 16 bytes
// (36 floats: the fragment loads of a warp fall on 32 distinct banks), a
// weight row of bn floats + 32 bytes (bn + 8: likewise).
constexpr int kRowA = kChunk * 4 + 16;
__host__ __device__ constexpr int row_w(int bn) { return bn * 4 + 32; }
__host__ __device__ constexpr int stage_bytes(int bm, int bn) {
  return bm * kRowA + kChunk * row_w(bn);
}

__global__ void __launch_bounds__(kMaxThreads)
    conv2d_tf32x3(Args A, Plan P) {
  extern __shared__ __align__(16) char smem[];
  const Geom& g = A.g;
  const int bm = P.bm, bn = P.bn, rw = row_w(bn);
  const int stage = stage_bytes(bm, bn);
  int4* rows = reinterpret_cast<int4*>(smem + kStages * stage);
  float* rscale = reinterpret_cast<float*>(rows + bm);
  const int m0 = blockIdx.x * bm, n0 = blockIdx.y * bn, split = blockIdx.z;
  fill_rows(A, m0, bm, rows, rscale);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (bn / 32), wn = warp % (bn / 32);
  const int kb = P.kbeg[split];
  const int nk = (P.kbeg[split + 1] - kb) / kChunk;
  const WSlot wslot = w_slot<4>(bn);

  TapIter taps(g, kb);
  auto load = [&](int kc) {
    const int k0 = kb + kc * kChunk;
    char* st = smem + (kc % kStages) * stage;
    const Tap t = taps.next(g);  // chunks load in order
    if (t.c < g.c1)
      load_a<4>(g, rows, bm, A.x1, g.c1, t.c, t, st, kRowA);
    else
      load_a<4>(g, rows, bm, A.x2, g.c2, t.c - g.c1, t, st, kRowA);
    load_w<4>(A.wgt, g.co, k0, n0, wslot, st + bm * kRowA, rw);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  const int cin = g.c1 + g.c2;
  int c0 = kb % cin;  // the first channel of the chunk the warps multiply
  constexpr int kStrideA = kRowA / 4;
  const int stride_w = rw / 4;
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kc + kStages - 1 < nk) load(kc + kStages - 1);
    cp_async_commit();

    const float* af = reinterpret_cast<const float*>(
        smem + (kc % kStages) * stage);
    const float* wf = af + bm * kStrideA;
    // in_scale applies to x1's channels.
    const bool scaled = A.in_scale != nullptr && c0 < g.c1;
    // The tensor cores sum the chunk from zero; its sum joins acc by a
    // float32 add (their own accumulation over a long K is less exact).
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      const int kq = ks * 8 + lane % 4;
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + lane / 4;
        split_tf32(wf[kq * stride_w + col], bb[nt][0], bs[nt][0]);
        split_tf32(wf[(kq + 4) * stride_w + col], bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + lane / 4;
        float a[4] = {af[r * kStrideA + kq], af[(r + 8) * kStrideA + kq],
                      af[r * kStrideA + kq + 4],
                      af[(r + 8) * kStrideA + kq + 4]};
        if (scaled) {
          if ((c0 + kq) % A.scale_mod == 0) {
            a[0] = a[0] * rscale[r];
            a[1] = a[1] * rscale[r + 8];
          }
          if ((c0 + kq + 4) % A.scale_mod == 0) {
            a[2] = a[2] * rscale[r];
            a[3] = a[3] * rscale[r + 8];
          }
        }
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(part[mt][nt], as, bb[nt]);
          mma_tf32(part[mt][nt], ab, bs[nt]);
          mma_tf32(part[mt][nt], ab, bb[nt]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = acc[i][j][e] + part[i][j][e];
    c0 = c0 + kChunk == cin ? 0 : c0 + kChunk;
  }
  store_tile<float, 2, 4>(A, P.splits, split, m0 + wm * 32, n0 + wn * 32,
                          acc);
}

}  // namespace

// x2 and in_scale may be null. The plan (bm, bn, warp_m 32, splits, kbeg:
// splits + 1 K offsets, a host array) is ops/kernels/conv_plan.py's; `ws` is a
// (splits, M, co) float32 workspace when splits > 1, else null. Output
// (n, ho, wo, co) NHWC.
extern "C" int fn_conv2d_nhwc(const float* x1, const float* x2,
                              const float* wgt, const float* bias,
                              const float* in_scale, float* out, float* ws,
                              int c1, int c2, int scale_mod, int n, int hi,
                              int wi, int ho, int wo, int co, int k,
                              int stride, int dil, int pad, int relu, int bm,
                              int bn, int warp_m, int splits,
                              const int* kbeg, void* stream) {
  static int smem_set = 48 * 1024;
  Plan P;
  Geom g{n, 1, hi, wi, 1, ho, wo, co, 1, k, stride, dil, pad, 0, c1, c2};
  if (!read_plan(P, bm, bn, warp_m, splits, kbeg) ||
      (c2 > 0) != (x2 != nullptr) ||
      scale_mod < 1 || co < 1 || co % 4 || !plan_ok(g, P, kChunk, 0, false) ||
      (splits > 1) != (ws != nullptr) || !aligned16(x1) ||
      (x2 && !aligned16(x2)) || !aligned16(wgt) || (ws && !aligned16(ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args A{x1, x2, wgt, bias, in_scale, out, ws, g, relu, scale_mod};
  const int smem = kStages * stage_bytes(bm, bn) + bm * 20;
  return launch_plan<float>(conv2d_tf32x3, smem_set, A, P,
                            plan_threads(P), smem,
                            static_cast<cudaStream_t>(stream));
}

// B's bfloat16 route (flax nn.Conv with dtype bfloat16, MGCoarse_128's
// PUNet): bfloat16 x1 [| x2], weight (k, k, c1 + c2, co) and output, the
// bias float32 holding bfloat16 values. conv_mma.cuh's tensor-core body:
// mma.sync m16n8k16 bf16 with float32 sums (every product exact), the
// 32x32 or the wide warp tiles; the epilogue rounds as flax does on the
// CPU: the sum to bfloat16, then the bias add to bfloat16 (round_sum),
// then the ReLU. Stride 1 or 2, any dilation; no in_scale. The plan is
// conv_plan.py's on the "bf16" route.
template <int MT, int NT>
int launch_bf16(const Args& A, const Plan& P, cudaStream_t s) {
  static int smem_set = 48 * 1024;
  return launch_plan<__nv_bfloat16>(
      conv_tc<__nv_bfloat16, __nv_bfloat16, MT, NT, kStages>, smem_set, A,
      P, plan_threads(P),
      tc_smem_bytes<__nv_bfloat16>(P.bm, P.bn, kStages), s);
}

extern "C" int fn_conv2d_bf16(const void* x1, const void* x2,
                              const void* wgt, const float* bias, void* out,
                              float* ws, int c1, int c2, int n, int hi,
                              int wi, int ho, int wo, int co, int k,
                              int stride, int dil, int pad, int relu, int bm,
                              int bn, int warp_m, int splits,
                              const int* kbeg, void* stream) {
  Plan P;
  Geom g{n, 1, hi, wi, 1, ho, wo, co, 1, k, stride, dil, pad, 0, c1, c2};
  if (!read_plan(P, bm, bn, warp_m, splits, kbeg) ||
      (c2 > 0) != (x2 != nullptr) || co < 1 || co % 8 ||
      !plan_ok(g, P, kChunk, 0, true) || (splits > 1) != (ws != nullptr) ||
      !aligned16(x1) || (x2 && !aligned16(x2)) || !aligned16(wgt) ||
      (ws && !aligned16(ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args A{x1, x2, wgt, bias, nullptr, out, ws, g, relu, 1, 1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.warp_m == 32) return launch_bf16<2, 4>(A, P, s);
  switch (P.bn) {
    case 64:
      return launch_bf16<4, 4>(A, P, s);
    case 96:
      return launch_bf16<4, 6>(A, P, s);
    default:
      return launch_bf16<4, 8>(A, P, s);
  }
}
