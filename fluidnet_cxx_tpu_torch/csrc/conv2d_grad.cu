// The weight gradient of kernel B's convolution: for an NHWC input x
// (n, hi, wi, ci) and the gradient dy (n, ho, wo, co) of its output,
//
//   dW[kh, kw, ci, co] = sum_{n, y, x} x[n, y*s + kh*d - pad,
//                                          x*s + kw*d - pad, ci] dy[n, y, x, co]
//   db[co]             = sum_{n, y, x} dy[n, y, x, co]
//
// (taps outside the input read 0: flax SAME padding, `pad` the top and
// left one), any odd k, stride and dilation. dW is HWIO, the layout kernel
// B takes. ops/kernels/conv_grad.py::conv2d_wgrad is its wrapper; the
// autograd function of ops/kernels/punet.py calls it in the backward of
// each conv of a training step.
//
// Replaces no TPU kernel: the JAX package trains through flax nn.Conv and
// lets XLA differentiate it (no Pallas kernel has a custom_vjp). It is
// here because every conv on the card runs on kernel B, which has no
// gradient of its own; B's input gradient is B itself on the flipped
// weights (ops/kernels/punet.py::conv2d_dgrad). Its plain version is
// torch.nn.grad.conv2d_weight and a sum over dy.
//
// What bounds it on an H100: operations. It is a GEMM of the im2col
// matrix's transpose (K = k*k*ci rows) by dy (co columns) over
// M = n*ho*wo pixels, 2*M*K*co operations: 19.3 GFLOP for a 3x3 32->32
// layer at 128^2, batch 64 (M = 1,048,576), 0.29 ms at 67 TFLOP/s without
// tensor cores; its bytes (x and dy read once) take 0.08 ms.
//
// Design: plain float32 on the CUDA cores (fmaf), simple and right first.
// A block owns a 64-row by 32-column tile of [dW; db] (db is one more row
// whose x is 1) and a contiguous range of M: the reduction over M, 2^20
// long, is split across blocks so that the card has ~4 blocks an SM, each
// block writing its partial tile to a workspace, and a second launch adds
// the splits in the order 0..S-1. Repeats are bit-equal; nothing is summed
// with atomics. A block stages 32 pixels at a time: the x values of its 64
// rows (the gather, coalesced along ci) and dy's 32 columns in shared
// memory; each thread sums a 4x2 piece of the tile over the chunk from
// zero and adds the chunk's sum to its accumulator, and the reduce adds
// the splits, both with Kahan's compensation (exact under -fmad=false): the
// rounding is then that of the 32-term chunk sums alone, as small as a
// pairwise sum's over all of M. With plain sums over the chunks and the
// splits (2^20 / 32 terms in all) the H100 read up to 2.4x the plain
// float32 version's distance from a float64 run.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;     // rows of [dW; db] a block
constexpr int kCols = 32;     // output channels a block
constexpr int kPix = 32;      // pixels a chunk
constexpr int kThreads = 256;
constexpr int kTargetBlocks = 4 * 132;  // ~4 blocks on each of 132 SMs
constexpr int kMinChunks = 32;          // chunks a split at least
constexpr int kMaxSplits = 1024;

// sum += v with Kahan's compensation c (the low-order part lost so far).
__device__ __forceinline__ void kahan_add(float& sum, float& c, float v) {
  const float y = v - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

struct WGeom {
  int n, hi, wi, ci, ho, wo, co, k, stride, dil, pad;
};

__global__ void __launch_bounds__(kThreads)
    wgrad_partial(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ ws, WGeom g, int rows, int chunks,
                  int splits) {
  __shared__ __align__(16) float As[kPix][kRows];
  __shared__ __align__(16) float Bs[kPix][kCols];
  __shared__ int pix_base[kPix];  // the pixel's image offset, or -1
  __shared__ int pix_y[kPix], pix_x[kPix];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows, n0 = blockIdx.y * kCols;
  const int split = blockIdx.z;
  const int m_pix = g.n * g.ho * g.wo;
  const int K = g.k * g.k * g.ci;

  // The A row this thread stages (its tap and channel, or the bias row).
  const int lr = tid % kRows;
  const int r = r0 + lr;
  const bool in_k = r < K, bias_row = r == K;
  int ch = 0, tap_y = 0, tap_x = 0;
  if (in_k) {
    const int tap = r / g.ci;
    ch = r - tap * g.ci;
    tap_y = (tap / g.k) * g.dil;
    tap_x = (tap % g.k) * g.dil;
  }
  // The dy column this thread stages.
  const int bc = tid % kCols;
  const bool col_ok = n0 + bc < g.co;
  // The 4x2 piece of the tile this thread sums.
  const int ty = tid / 16, tx = tid % 16;

  float acc[4][2], comp[4][2];  // Kahan sums and their compensations
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i][0] = acc[i][1] = comp[i][0] = comp[i][1] = 0.f;

  const int c_beg = (int)((long long)split * chunks / splits);
  const int c_end = (int)((long long)(split + 1) * chunks / splits);
  for (int c = c_beg; c < c_end; ++c) {
    const int m0 = c * kPix;
    __syncthreads();  // the previous chunk is consumed
    if (tid < kPix) {
      const int m = m0 + tid;
      if (m < m_pix) {
        const int xo = m % g.wo, t = m / g.wo;
        const int yo = t % g.ho, img = t / g.ho;
        pix_base[tid] = img * g.hi * g.wi;
        pix_y[tid] = yo * g.stride - g.pad;
        pix_x[tid] = xo * g.stride - g.pad;
      } else {
        pix_base[tid] = -1;
      }
    }
    __syncthreads();
    for (int p = tid / kRows; p < kPix; p += kThreads / kRows) {
      float a = 0.f;
      if (pix_base[p] >= 0) {
        if (in_k) {
          const int iy = pix_y[p] + tap_y, ix = pix_x[p] + tap_x;
          if (iy >= 0 && iy < g.hi && ix >= 0 && ix < g.wi)
            a = x[(pix_base[p] + iy * g.wi + ix) * g.ci + ch];
        } else if (bias_row) {
          a = 1.f;
        }
      }
      As[p][lr] = a;
    }
    for (int p = tid / kCols; p < kPix; p += kThreads / kCols) {
      const int m = m0 + p;
      Bs[p][bc] = (m < m_pix && col_ok) ? dy[m * g.co + n0 + bc] : 0.f;
    }
    __syncthreads();
    float part[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i][0] = part[i][1] = 0.f;
#pragma unroll 8
    for (int p = 0; p < kPix; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(&As[p][ty * 4]);
      const float2 b = *reinterpret_cast<const float2*>(&Bs[p][tx * 2]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[i][0] = fmaf(av[i], b.x, part[i][0]);
        part[i][1] = fmaf(av[i], b.y, part[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) kahan_add(acc[i][j], comp[i][j],
                                            part[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + tx * 2 + j;
      if (col < g.co)
        ws[((long long)split * rows + row) * g.co + col] = acc[i][j];
    }
  }
}

// [dW; db] = the sum of the splits' partial tiles, in the order 0..S-1
// (Kahan).
__global__ void wgrad_reduce(const float* __restrict__ ws,
                             float* __restrict__ dw, float* __restrict__ db,
                             int rows, int co, int splits) {
  const long long total = (long long)rows * co;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = ws[e], c = 0.f;
  for (int i = 1; i < splits; ++i)
    kahan_add(s, c, ws[(long long)i * total + e]);
  const long long kco = total - co;  // K * co: dW's elements
  if (e < kco)
    dw[e] = s;
  else
    db[e - kco] = s;
}

int tiles(int rows, int co) {
  return ((rows + kRows - 1) / kRows) * ((co + kCols - 1) / kCols);
}

int chunks_of(long long m) { return (int)((m + kPix - 1) / kPix); }

constexpr long long kMaxIndex = 0x7fffffff;

}  // namespace

// Splits of M for a layer with m output pixels, K = k*k*ci and co output
// channels: enough blocks for ~4 on each SM, at least kMinChunks chunks a
// split. Launches nothing; the wrapper sizes its workspace with it.
extern "C" int fn_conv2d_wgrad_splits(long long m, int kdim, int co) {
  const int t = tiles(kdim + 1, co);
  const int by_fill = (kTargetBlocks + t - 1) / t;
  const int by_len = chunks_of(m) / kMinChunks;
  int s = by_fill < by_len ? by_fill : by_len;
  if (s > kMaxSplits) s = kMaxSplits;
  return s < 1 ? 1 : s;
}

// x (n, hi, wi, ci) and dy (n, ho, wo, co) NHWC float32; dw (k, k, ci, co)
// and db (co,) are written; ws is a (splits, k*k*ci + 1, co) float32
// workspace. Two launches on `stream`: the partial tiles, then the reduce.
extern "C" int fn_conv2d_wgrad(const float* x, const float* dy, float* dw,
                               float* db, float* ws, int n, int hi, int wi,
                               int ci, int ho, int wo, int co, int k,
                               int stride, int dil, int pad, int splits,
                               void* stream) {
  if (!x || !dy || !dw || !db || !ws || n < 1 || hi < 1 || wi < 1 ||
      ci < 1 || ho < 1 || wo < 1 || co < 1 || k < 1 || stride < 1 ||
      dil < 1 || pad < 0 || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  // The partial kernel indexes x and dy with 32-bit ints.
  if ((long long)n * hi * wi * ci > kMaxIndex ||
      (long long)n * ho * wo * co > kMaxIndex)
    return static_cast<int>(cudaErrorInvalidValue);
  WGeom g{n, hi, wi, ci, ho, wo, co, k, stride, dil, pad};
  const int rows = k * k * ci + 1;
  const int chunks = chunks_of((long long)n * ho * wo);
  if (splits > chunks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((rows + kRows - 1) / kRows, (co + kCols - 1) / kCols, splits);
  wgrad_partial<<<grid, kThreads, 0, s>>>(x, dy, ws, g, rows, chunks,
                                          splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)rows * co;
  wgrad_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      ws, dw, db, rows, co, splits);
  return static_cast<int>(cudaGetLastError());
}
