// Kernel N: one NDHWC 3-D convolution (kernel 1 or 3, stride 1 or 2, flax
// SAME padding) with fused bias and ReLU. The PUNet3 forward launches it
// once per layer, 9 times (ops/kernels/punet3.py::punet3_forward).
//
// Replaces fluidnet_cxx_tpu/ops/pallas/punet3_pallas.py::
// punet3_forward_pallas (body _punet3_kernel), which computes the whole
// 3-D U-Net as MXU matmuls on VMEM-resident activations inside one kernel
// (27 masked row rotations per conv, s2d(2) phase blocks for the down
// conv, 8-phase interleaves for the up conv, 128-lane channel padding:
// TPU devices, not semantics, and not copied here). Its plain version is
// the port's PUNet3 module (models/punet3d.py, F.conv3d per layer).
//
// Rounding, as the TPU kernel's: each operand is float32 or bfloat16 as
// the wrapper says (`types`); every product is exact or rounded once in
// float32 and summed in float32; the bias is added in float32, then the
// ReLU, then the rounding to the output type (round to nearest even, as
// XLA's and torch's casts). The flax route (`round_sum`, the flax path's
// bfloat16 PUNet3: flax nn.Conv(dtype="bfloat16") as JAX computes it on
// the CPU) rounds the float32 sum to bfloat16 first, then adds the bias
// (which the wrapper rounds to bfloat16) and rounds again; every layer's
// output is bfloat16 there, the up conv's and the head's too, so the
// decoder's concat is bfloat16 on both halves and takes no bf16x3 split
// (conv_mma.cuh's epilogue and split-K reduce hold the two roundings, as
// for kernel B's bfloat16 route).
//
// What bounds it on an H100: operations. The p8 forward at 128^3 (g0 16)
// is 9.1 GFLOP, the p4 forward (g0 32) 64.5 GFLOP, over activations of at
// most 32^3 x 192 values: 9.2 and 65 us at the dense bf16 tensor-core rate
// (989 TFLOP/s). What sets its time in practice is filling 132 SMs (p8's
// 8^3 levels have 512 output cells), the issue rate of mma.sync and, in
// the concat, the three products its exact float32 half costs.
//
// Design (csrc/conv_mma.cuh, shared with kernel B; the tensor-core body
// conv_tc is there too, which B's bfloat16 route runs): an implicit GEMM on
// the tile and split-K plan of ops/kernels/conv_plan.py, about four
// blocks an SM on every layer of the main paths (the 8^3 layers split K
// 32 ways and add the float32 partials in a fixed order). The bf16 layers
// (bf16 input and weights) run on the tensor cores: mma.sync m16n8k16 bf16
// with float32 accumulators, fragments from shared memory by ldmatrix (the
// weight panel, K-major rows of the DHWIO layout, through ldmatrix.trans),
// K staged 32 channels (64 bytes of one NDHWC cell) at a time through a
// 4-stage cp.async ring whose zero-fill copies stand for the SAME padding.
// Warp tiles are 32x32, or 64 x bn/2 (the wide tile, four warps a block)
// on layers with many output cells. A product of two bf16 values is exact
// in float32. The decoder's concat has a float32 up half, whose products
// must stay float32 (the TPU kernel's _mm of an f32 operand): once a
// float32 chunk has landed in shared memory the block splits each value
// into hi + mid + lo, three bf16 values by round-to-nearest steps whose
// sum is the value exactly (conv_mma.cuh::split_bf16x3), and three MMAs on
// one accumulator take the three exact products (bf16 x bf16 has 16
// significand bits); rounding the up half to bf16 instead moved 994 cells
// of a 32^3 forward by more than 1e-3 of its largest output. The skip
// half is plain bf16. The all-float32 net (`types` 0, compute_dtype
// "float32", on no main path) keeps a SIMT body of fmaf on 64x64 tiles,
// with the same planner.
#include <cuda_bf16.h>

#include "conv_mma.cuh"

namespace {

using namespace fnk::conv;
using bf16 = __nv_bfloat16;

// Bits of `types`: which operands are bfloat16 (ops/kernels/punet3.py).
constexpr int kX1Bf16 = 1, kX2Bf16 = 2, kWBf16 = 4, kOutBf16 = 8;

// The all-float32 route: 256 threads on a 64x64 tile, K in chunks of 16
// staged through shared memory, 4x4 fmaf micro-tiles, over the plan's K
// range.
constexpr int kSimtTile = 64, kSimtK = 16, TM = 4, TN = 4;
constexpr int kSimtThreads = (kSimtTile / TM) * (kSimtTile / TN);  // 256

__global__ void __launch_bounds__(kSimtThreads)
    conv3d_simt(Args A, Plan P) {
  // +4 floats a row: the transposed A-tile stores spread over banks.
  __shared__ __align__(16) float As[kSimtK][kSimtTile + 4];
  __shared__ __align__(16) float Bs[kSimtK][kSimtTile];
  const Geom& g = A.g;
  const float* x1 = static_cast<const float*>(A.x1);
  const float* x2 = static_cast<const float*>(A.x2);
  const float* wgt = static_cast<const float*>(A.wgt);
  const int tid = threadIdx.x;
  const int tx = tid % (kSimtTile / TN), ty = tid / (kSimtTile / TN);
  const int m0 = blockIdx.x * kSimtTile, n0 = blockIdx.y * kSimtTile;
  const int split = blockIdx.z;
  const int M = cells(g);
  const int cin = g.c1 + g.c2;

  // The four A-tile rows this thread loads (fixed over the K loop): the
  // sample and the input corner (output cell * stride - pad) of each.
  const int a_kk = tid % kSimtK;
  int a_row[4], a_n[4], a_z[4], a_y[4], a_x[4];
  bool a_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int mm = tid / kSimtK + r * (kSimtThreads / kSimtK);
    int m = m0 + mm;
    a_row[r] = mm;
    a_ok[r] = m < M;
    int mc = a_ok[r] ? m : 0;
    a_x[r] = (mc % g.wo) * g.stride - g.pad;
    mc /= g.wo;
    a_y[r] = (mc % g.ho) * g.stride - g.pad;
    mc /= g.ho;
    a_z[r] = (mc % g.dout) * g.stride - g.pad;
    a_n[r] = mc / g.dout;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = P.kbeg[split]; k0 < P.kbeg[split + 1]; k0 += kSimtK) {
    // Chunk k0..k0+15 lies inside one tap and one input.
    const int tap = k0 / cin, c0 = k0 % cin;
    const int kz = tap / (g.k * g.k), ky = (tap / g.k) % g.k,
              kx = tap % g.k;
    const int c = c0 + a_kk;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float val = 0.f;
      const int iz = a_z[r] + kz, iy = a_y[r] + ky, ix = a_x[r] + kx;
      if (a_ok[r] && iz >= 0 && iz < g.di && iy >= 0 && iy < g.hi &&
          ix >= 0 && ix < g.wi) {
        size_t pix = (((size_t)a_n[r] * g.di + iz) * g.hi + iy) * g.wi + ix;
        val = c < g.c1 ? x1[pix * g.c1 + c] : x2[pix * g.c2 + (c - g.c1)];
      }
      As[a_kk][a_row[r]] = val;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int idx = tid + r * kSimtThreads;
      int kk = idx / kSimtTile, nn = idx % kSimtTile;
      int col = n0 + nn;
      Bs[kk][nn] = col < g.co ? wgt[(size_t)(k0 + kk) * g.co + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtK; ++kk) {
      float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      float a[TM] = {a4.x, a4.y, a4.z, a4.w};
      float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(A.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int col = n0 + tx * TN + j;
      if (col >= g.co) continue;
      if (P.splits > 1) {
        A.ws[((size_t)split * M + m) * g.co + col] = acc[i][j];
        continue;
      }
      float y = acc[i][j] + A.bias[col];
      if (A.relu) y = fmaxf(y, 0.f);
      out[(size_t)m * g.co + col] = y;
    }
  }
}

template <class T1, class TO, int MT, int NT, int STAGES>
int launch_tiles(const Args& A, const Plan& P, cudaStream_t s) {
  static int smem_set = 48 * 1024;
  return launch_plan<TO>(conv_tc<T1, TO, MT, NT, STAGES>, smem_set, A, P,
                         plan_threads(P), tc_smem_bytes<T1>(P.bm, P.bn, STAGES),
                         s);
}

// The 32x32 warp tiles, or the wide ones (3 stages with a float32 x1, so
// that two blocks of the ring and the bf16x3 tiles fit an SM).
template <class T1, class TO>
int launch_tc(const Args& A, const Plan& P, cudaStream_t s) {
  constexpr int kWideStages = f32_x1<T1>() ? 3 : kStages;
  if (P.warp_m == 32) return launch_tiles<T1, TO, 2, 4, kStages>(A, P, s);
  switch (P.bn) {
    case 64:
      return launch_tiles<T1, TO, 4, 4, kWideStages>(A, P, s);
    case 96:
      return launch_tiles<T1, TO, 4, 6, kWideStages>(A, P, s);
    default:
      return launch_tiles<T1, TO, 4, 8, kWideStages>(A, P, s);
  }
}

// The operand types the PUNet3 forwards use (ops/kernels/punet3.py): all
// float32 (the SIMT route); or bfloat16 weights with a bfloat16 input and
// a bfloat16 (ReLU layers) or float32 (the up conv, the head) output; or
// the decoder's concat, a float32 up half and a bfloat16 skip half; or, on
// the flax route, the concat with both halves bfloat16. Other `types`
// values are refused.
int launch_types(int types, const Args& A, const Plan& P, cudaStream_t s) {
  static int simt_smem = 48 * 1024;
  switch (types) {
    case 0:
      return launch_plan<float>(conv3d_simt, simt_smem, A, P, kSimtThreads,
                                0, s);
    case kX1Bf16 | kWBf16:
      return launch_tc<bf16, float>(A, P, s);
    case kX1Bf16 | kWBf16 | kOutBf16:
      return launch_tc<bf16, bf16>(A, P, s);
    case kX2Bf16 | kWBf16 | kOutBf16:
      return launch_tc<float, bf16>(A, P, s);
    case kX1Bf16 | kX2Bf16 | kWBf16 | kOutBf16:
      return launch_tc<bf16, bf16>(A, P, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x2 may be null (c2 0). `types` says which operands are bfloat16 (bits
// above, one of launch_types' cases); the rest are float32. `round_sum`
// (bfloat16 output only) rounds the sum before the bias add. The plan (bm,
// bn, warp_m, splits, kbeg: splits + 1 K offsets, a host array) is
// ops/kernels/conv_plan.py's; `ws` is a (splits, M, co) float32 workspace
// when splits > 1, else null. Output (n, dout, ho, wo, co) NDHWC.
extern "C" int fn_conv3d_ndhwc(const void* x1, const void* x2,
                               const void* wgt, const float* bias, void* out,
                               float* ws, int c1, int c2, int n, int di,
                               int hi, int wi, int dout, int ho, int wo,
                               int co, int k, int stride, int pad, int relu,
                               int types, int round_sum, int bm, int bn,
                               int warp_m,
                               int splits, const int* kbeg, void* stream) {
  const bool simt = types == 0;
  Plan P;
  Geom g{n, di, hi, wi, dout, ho, wo, co, k, k, stride, 1, pad, pad, c1, c2};
  if (!read_plan(P, bm, bn, warp_m, splits, kbeg) ||
      (c2 > 0) != (x2 != nullptr) ||
      (k != 1 && k != 3) || (stride != 1 && stride != 2) || co < 1 ||
      co % (simt ? 4 : 8) ||
      !plan_ok(g, P, simt ? kSimtK : kChunk, simt ? kSimtTile : 0, !simt) ||
      (splits > 1) != (ws != nullptr) || !aligned16(x1) ||
      (round_sum && !(types & kOutBf16)) ||
      (x2 && !aligned16(x2)) || !aligned16(wgt) || (ws && !aligned16(ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args A{x1, x2, wgt, bias, nullptr, out, ws, g, relu, 1, round_sum};
  return launch_types(types, A, P, static_cast<cudaStream_t>(stream));
}
