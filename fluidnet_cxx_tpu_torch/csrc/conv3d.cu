// Kernel N: one NDHWC 3-D convolution (kernel 1 or 3, stride 1 or 2, flax
// SAME padding) with fused bias and ReLU, float32 products and sums. The
// PUNet3 forward launches it once per layer, 9 times
// (ops/kernels/punet3.py::punet3_forward).
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
// the wrapper says (template parameters T1, T2 for the two inputs, TW
// for the weights, TO for the output); a bfloat16 value widens to float32
// exactly, so a product of two bfloat16 values is exact in float32 and
// the f32 x bf16 products of the decoder's up half round once (fmaf).
// The bias is added in float32, then the ReLU, then the rounding to TO
// (round to nearest even, as XLA's and torch's casts).
//
// What bounds it on an H100: operations. The p8 forward at 128^3 (g0 16)
// is 9.1 GFLOP, the p4 forward (g0 32) 64.5 GFLOP, over activations of at
// most 32^3 x 192 values; against the dense bf16 tensor-core rate (989
// TFLOP/s) that is 9.2 and 65 us, against the fp32 rate without tensor
// cores (67 TFLOP/s) 0.136 and 0.963 ms. Design (B's, csrc/conv2d.cu, in
// 3-D): an implicit GEMM, M = output cells, N = output channels, K = taps
// x input channels. Each 256-thread block owns a 64x64 output tile and
// walks K in chunks of 16 that lie inside one tap and one input (the
// wrapper checks the channel counts are multiples of 16): the input patch
// chunk (gathered with the padding mask, so no padded copy is made; the
// decoder's [up | skip] concat is a second input pointer) and the weight
// panel's chunk are widened to float32 in shared memory, and each thread
// accumulates a 4x4 micro-tile with fmaf on the CUDA cores. Tensor cores
// (mma/wgmma on bf16 tiles) are a later step.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

// Bits of `types`: which operands are bfloat16 (ops/kernels/punet3.py).
constexpr int kX1Bf16 = 1, kX2Bf16 = 2, kWBf16 = 4, kOutBf16 = 8;

struct Conv3dArgs {
  const void* x1;    // (n, di, hi, wi, c1)
  const void* x2;    // (n, di, hi, wi, c2) or null
  const void* wgt;   // (k^3 * (c1 + c2), co): DHWIO, flattened
  const float* bias; // (co)
  void* out;         // (n, do, ho, wo, co)
  int c1, c2;
  int n, di, hi, wi, dout, ho, wo, co;
  int k, stride, pad, relu;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <class T1, class T2, class TW, class TO>
__global__ void __launch_bounds__(kThreads) conv3d_ndhwc(Conv3dArgs A) {
  // +4 floats a row: the transposed A-tile stores spread over banks.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const T1* x1 = static_cast<const T1*>(A.x1);
  const T2* x2 = static_cast<const T2*>(A.x2);
  const TW* wgt = static_cast<const TW*>(A.wgt);
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = A.n * A.dout * A.ho * A.wo;
  const int cin = A.c1 + A.c2;
  const int Ktot = A.k * A.k * A.k * cin;

  // The four A-tile rows this thread loads (fixed over the K loop): the
  // sample and the input corner (output cell * stride - pad) of each.
  const int a_kk = tid % BK;
  int a_row[4], a_n[4], a_z[4], a_y[4], a_x[4];
  bool a_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int mm = tid / BK + r * (kThreads / BK);
    int m = m0 + mm;
    a_row[r] = mm;
    a_ok[r] = m < M;
    int mc = a_ok[r] ? m : 0;
    a_x[r] = (mc % A.wo) * A.stride - A.pad;
    mc /= A.wo;
    a_y[r] = (mc % A.ho) * A.stride - A.pad;
    mc /= A.ho;
    a_z[r] = (mc % A.dout) * A.stride - A.pad;
    a_n[r] = mc / A.dout;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Ktot; k0 += BK) {
    // Chunk k0..k0+15 lies inside one tap and one input.
    const int tap = k0 / cin, c0 = k0 % cin;
    const int kz = tap / (A.k * A.k), ky = (tap / A.k) % A.k,
              kx = tap % A.k;
    const int c = c0 + a_kk;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float val = 0.f;
      const int iz = a_z[r] + kz, iy = a_y[r] + ky, ix = a_x[r] + kx;
      if (a_ok[r] && iz >= 0 && iz < A.di && iy >= 0 && iy < A.hi &&
          ix >= 0 && ix < A.wi) {
        size_t pix = (((size_t)a_n[r] * A.di + iz) * A.hi + iy) * A.wi + ix;
        val = c < A.c1 ? widen(x1[pix * A.c1 + c])
                       : widen(x2[pix * A.c2 + (c - A.c1)]);
      }
      As[a_kk][a_row[r]] = val;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int idx = tid + r * kThreads;
      int kk = idx / BN, nn = idx % BN;
      int col = n0 + nn;
      Bs[kk][nn] =
          col < A.co ? widen(wgt[(size_t)(k0 + kk) * A.co + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
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

  TO* out = static_cast<TO*>(A.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int col = n0 + tx * TN + j;
      if (col >= A.co) continue;
      float y = acc[i][j] + A.bias[col];
      if (A.relu) y = fmaxf(y, 0.f);
      out[(size_t)m * A.co + col] = narrow<TO>(y);
    }
  }
}

using bf16 = __nv_bfloat16;

// The operand types the PUNet3 forward uses (ops/kernels/punet3.py): all
// float32; or bfloat16 weights with a bfloat16 input and a bfloat16 (ReLU
// layers) or float32 (the up conv, the head) output; or the decoder's
// concat, a float32 up half and a bfloat16 skip half. Other `types` values
// are refused.
template <class T1, class T2, class TW, class TO>
void launch(const Conv3dArgs& A, dim3 grid, cudaStream_t s) {
  conv3d_ndhwc<T1, T2, TW, TO><<<grid, kThreads, 0, s>>>(A);
}

bool launch_types(int types, const Conv3dArgs& A, dim3 grid,
                  cudaStream_t s) {
  switch (types) {
    case 0:
      launch<float, float, float, float>(A, grid, s);
      return true;
    case kX1Bf16 | kWBf16:
      launch<bf16, float, bf16, float>(A, grid, s);
      return true;
    case kX1Bf16 | kWBf16 | kOutBf16:
      launch<bf16, float, bf16, bf16>(A, grid, s);
      return true;
    case kX2Bf16 | kWBf16 | kOutBf16:
      launch<float, bf16, bf16, bf16>(A, grid, s);
      return true;
    default:
      return false;
  }
}

}  // namespace

// x2 may be null (c2 0). `types` says which operands are bfloat16 (bits
// above, one of launch_types' cases); the rest are float32. Output (n,
// dout, ho, wo, co) NDHWC.
extern "C" int fn_conv3d_ndhwc(const void* x1, const void* x2,
                               const void* wgt, const float* bias, void* out,
                               int c1, int c2, int n, int di, int hi, int wi,
                               int dout, int ho, int wo, int co, int k,
                               int stride, int pad, int relu, int types,
                               void* stream) {
  if (c1 % BK || c2 % BK || c1 < BK || (c2 > 0) != (x2 != nullptr) ||
      (k != 1 && k != 3) || (stride != 1 && stride != 2) || co < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Conv3dArgs A{x1, x2, wgt, bias, out, c1, c2, n, di, hi, wi,
               dout, ho, wo, co, k, stride, pad, relu};
  const long long M = (long long)n * dout * ho * wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (co + BN - 1) / BN);
  if (!launch_types(types, A, grid, (cudaStream_t)stream))
    return static_cast<int>(cudaErrorInvalidValue);
  return fnk::launch_status();
}
