// Kernel B: one NHWC 2-D convolution (kernel 1 or 3, stride 1 or 2,
// dilation 1 or 2, flax SAME padding) with fused bias and ReLU, fp32
// accumulate. The PUNet forward launches it once per layer
// (ops/kernels/punet.py::punet_forward).
//
// Replaces fluidnet_cxx_tpu/ops/pallas/punet_pallas.py::punet_forward_pallas
// (body _punet_kernel), which computes every conv of the U-Net as MXU
// matmuls inside one kernel. Its plain version is the port's PUNet module
// (models/punet.py, F.conv2d per layer).
//
// What bounds it on an H100: operations. The 512^2 forward is ~3.8 GFLOP
// of fp32 multiply-adds (~57 us at 67 TFLOP/s without tensor cores) over
// activations of at most 64x64x192 floats (3 MB) and 1.6 MB of weights.
// Design: an implicit GEMM, M = output pixels, N = output channels,
// K = taps x input channels. Each 256-thread block owns a 64x64 output
// tile and walks K in chunks of 16: the input patch chunk (gathered with
// the padding mask, so no padded copy is made) and a shared-memory tile
// of the weight panel are staged in shared memory, and each thread
// accumulates a 4x4 micro-tile with fmaf. The skip concat is a second
// input pointer (channels [x1 | x2], as punet.py concatenates
// [upsampled, skip]); the input normalisation multiplies x1's channels
// c % scale_mod == 0 by in_scale[n] as they are loaded.
// Tensor cores (TF32/bf16 wgmma) are a later step.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

struct ConvArgs {
  const float* x1;
  const float* x2;
  const float* wgt;   // (k*k*(c1+c2), co): HWIO, flattened
  const float* bias;  // (co)
  const float* in_scale;
  float* out;         // (n, ho, wo, co)
  int c1, c2, scale_mod;
  int n, hi, wi, ho, wo, co;
  int k, stride, dil, pad, relu;
};

__global__ void __launch_bounds__(kThreads)
conv2d_nhwc(ConvArgs A) {
  // +4 floats a row: the transposed A-tile stores spread over banks.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = A.n * A.ho * A.wo;
  const int cin = A.c1 + A.c2;
  const int Ktot = A.k * A.k * cin;

  // The four A-tile rows this thread loads (fixed over the K loop).
  int a_kk = tid % BK;
  int a_row[4], a_n[4], a_oy[4], a_ox[4];
  bool a_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int mm = tid / BK + r * (kThreads / BK);
    int m = m0 + mm;
    a_row[r] = mm;
    a_ok[r] = m < M;
    int mc = a_ok[r] ? m : 0;
    a_ox[r] = mc % A.wo;
    a_oy[r] = (mc / A.wo) % A.ho;
    a_n[r] = mc / (A.wo * A.ho);
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Ktot; k0 += BK) {
    // Chunk k0..k0+15 lies inside one tap and one input (c1, c2 and cin
    // are multiples of 16, checked by the wrapper).
    int tap = k0 / cin, c0 = k0 % cin;
    int ky = tap / A.k, kx = tap % A.k;
    int c = c0 + a_kk;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float val = 0.f;
      int iy = a_oy[r] * A.stride - A.pad + ky * A.dil;
      int ix = a_ox[r] * A.stride - A.pad + kx * A.dil;
      if (a_ok[r] && iy >= 0 && iy < A.hi && ix >= 0 && ix < A.wi) {
        size_t pix = ((size_t)a_n[r] * A.hi + iy) * A.wi + ix;
        if (c < A.c1) {
          val = A.x1[pix * A.c1 + c];
          if (A.in_scale && c % A.scale_mod == 0) val *= A.in_scale[a_n[r]];
        } else {
          val = A.x2[pix * A.c2 + (c - A.c1)];
        }
      }
      As[a_kk][a_row[r]] = val;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int idx = tid + r * kThreads;
      int kk = idx / BN, nn = idx % BN;
      int col = n0 + nn;
      Bs[kk][nn] = col < A.co ? A.wgt[(size_t)(k0 + kk) * A.co + col] : 0.f;
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int col = n0 + tx * TN + j;
      if (col >= A.co) continue;
      float y = acc[i][j] + A.bias[col];
      A.out[(size_t)m * A.co + col] = A.relu ? fmaxf(y, 0.f) : y;
    }
  }
}

}  // namespace

// x2 and in_scale may be null. Output (n, ho, wo, co) NHWC.
extern "C" int fn_conv2d_nhwc(const float* x1, const float* x2,
                              const float* wgt, const float* bias,
                              const float* in_scale, float* out, int c1,
                              int c2, int scale_mod, int n, int hi, int wi,
                              int ho, int wo, int co, int k, int stride,
                              int dil, int pad, int relu, void* stream) {
  ConvArgs A{x1, x2, wgt, bias, in_scale, out, c1, c2, scale_mod,
             n, hi, wi, ho, wo, co, k, stride, dil, pad, relu};
  int M = n * ho * wo;
  dim3 grid((co + BN - 1) / BN, (M + BM - 1) / BM);
  conv2d_nhwc<<<grid, kThreads, 0, (cudaStream_t)stream>>>(A);
  return fnk::launch_status();
}
