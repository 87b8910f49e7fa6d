// The gradients of kernel B's bfloat16 route (fn_conv2d_bf16 in
// conv2d.cu), for training the 2-D nets in bfloat16 (MGCoarseNet, and
// PUNet, the tower and ScaleNet under computeDtype bfloat16): the input
// gradient fn_conv2d_bf16_dgrad and the weight gradient
// fn_conv2d_bf16_wgrad of one NHWC SAME conv (kernel 1, 3 or 5, stride 1
// or 2, dilation 1 or 2, flax SAME padding), from the bfloat16 gradient of
// its output (the ReLU mask already applied by the wrapper,
// ops/kernels/conv_grad.py); and the bias gradient fn_bias_grad_bf16 of
// any bfloat16 conv, 2-D or 3-D (conv3d_grad.cu's wrapper calls it too).
//
// They replace no TPU kernel: JAX differentiates flax
// nn.Conv(dtype="bfloat16") with XLA (scripts/train_mg_coarse.py's
// jax.value_and_grad), and the Pallas forward punet_forward_pallas has no
// custom_vjp. The port needs them because every conv of a bfloat16 2-D net
// on the card runs on kernel B's bfloat16 route. Rounding, as XLA's on the
// CPU: bfloat16 operands, every product exact in float32, the input and
// weight gradients summed in float32 and rounded to bfloat16 once. The
// bias gradient is XLA's reduce of the bfloat16 cotangent of the bias's
// broadcast, each add rounded to bfloat16, in the order XLA's tree
// reduction gives it: while every reduced axis (batch, [depth,] rows,
// columns) is at most 32 long, one chain over the cells in row-major
// order; otherwise windows of 32 along each longer axis (padded evenly on
// both sides to a multiple of 32; an axis of at most 32 is one window),
// a chain over each window's cells in row-major order, then a chain over
// the windows' sums in row-major order. Plain versions:
// conv2d_dgrad_bf16_plain, conv2d_wgrad_bf16_plain and bias_grad_plain in
// ops/kernels/conv_grad.py.
//
// What bounds them on an H100: at the 2-D nets' training shapes the input
// and weight gradients are GEMMs of 2*cells*k^2*ci*co operations, 0.16 ms
// at the dense bf16 rate (989 TFLOP/s) for ScaleNet's 3x3 64->128 layer at
// 128^2, batch 64, above the ~0.04 ms its bytes take at 3.35 TB/s. The
// bias gradient is bound by neither: each column of each window is one
// chain of dependent adds (32,768 of them at 128^2, batch 64), so its time
// is the chain's latency.
//
// Design. The input and weight gradients are conv3d_grad.cu's implicit
// GEMMs in two dimensions, with dilation: bf16 mma.sync m16n8k16 with
// float32 accumulators, 32x32 warp tiles, K staged 32 at a time through a
// 4-deep cp.async ring whose zero-fill copies stand for the SAME padding,
// the ragged edges and channels past the stored ones; conv_mma.cuh's
// loaders, ldmatrix and mma wrappers.
//  * dgrad: M = dx cells of one output-parity class, N = input channels,
//    K = the class's taps x output channels (the wrapper pads the weight
//    panel's output channels to a multiple of 32 with zero rows). A row
//    gathers dy at the class cell plus the tap's offset (zero off the
//    map); the panel is the HWIO weight with its channel axes swapped.
//    Stride 1: one class of all k^2 taps; stride 2: the 4 (y, x) parity
//    classes, each with only the taps of its parity (the table is
//    conv_grad.py's class_table, the same as fn_conv2d_dgrad's).
//  * wgrad: per tap, M = input channels, N = output channels, K = output
//    cells; x at each cell's tap-shifted (dilated) input cell, dy at the
//    cell, both reaching the MMA through ldmatrix.trans. Each chunk of 32
//    cells is summed from zero on the tensor cores and Kahan-added into
//    the running sum (K reaches a million cells at 128^2, batch 64).
//  * Both split their reduction over more blocks (the wrapper's
//    grad_splits) and add the float32 partials in a fixed order: repeats
//    are bit-equal, no atomics.
//  * bias: a block a window and 32 columns; its warps stage the window's
//    cells in shared memory, two tiles deep, while warp 0 runs the chain,
//    a column a lane; a second launch chains the windows' sums.
#include <cuda_bf16.h>

#include "conv_mma.cuh"

namespace {

using namespace fnk::conv;
using bf16 = __nv_bfloat16;

constexpr int kMaxClasses = 4;   // parity classes of a stride-2 2-D conv
constexpr int kMaxTaps = 25;     // a 5x5 kernel
constexpr int kGradStages = 4;   // depth of the cp.async ring
constexpr int MT = 2, NT = 4;    // warp tile: 2 m16 x 4 n8 (32 x 32)

// dgrad's block tile: 64 dx cells x 32 input channels, two warps.
constexpr int kDBM = 64, kDBN = 32;
constexpr int kDThreads = kDBM * kDBN / 32;
constexpr int kDRowW = kDBN * 2 + 16;  // bytes of a weight panel row
constexpr int kDStage = kDBM * kRowA16 + kChunk * kDRowW;

// wgrad's block tile: 64 input channels x 64 output channels, four warps.
constexpr int kWBM = 64, kWBN = 64;
constexpr int kWThreads = kWBM * kWBN / 32;
constexpr int kWRowA = kWBM * 2 + 16;  // bytes of an x row of a chunk
constexpr int kWRowB = kWBN * 2 + 16;  // bytes of a dy row of a chunk
constexpr int kWStage = kChunk * (kWRowA + kWRowB);

// One output-parity class of dx: its cells (y0 + s*qy, x0 + s*qx) for qy <
// hq, qx < wq, and its taps taps[tap0 .. tap0+ntaps), each (tap, oy, ox):
// class cell q reads dy at q + o through weight tap `tap`.
struct DClass {
  int y0, x0, hq, wq, tap0, ntaps;
};
struct DTable {
  int ncls;
  DClass cls[kMaxClasses];
  int3 taps[kMaxTaps];
};

struct DArgs {
  const bf16* dy;  // (n, ho, wo, ys)
  const bf16* wt;  // (k^2, cop, xs), cop = ys rounded up to kChunk
  bf16* dx;        // (n, hi, wi, xs)
  float* ws;       // (splits, n*hi*wi, xs) when splits > 1
  int n, hi, wi, xs, ho, wo, ys, cop, stride, splits;
};

struct WArgs {
  const bf16* x;   // (n, hi, wi, xs)
  const bf16* dy;  // (n, ho, wo, ys)
  bf16* dw;        // (k^2, xs, ys)
  float* ws;       // (splits, k^2 * xs, ys) when splits > 1
  int n, hi, wi, xs, ho, wo, ys, k, stride, dil, pad, splits;
};

// Chunks [first, last) of `total` that split `s` of `splits` takes.
__device__ __forceinline__ int2 split_range(int total, int s, int splits) {
  return make_int2((int)((long long)total * s / splits),
                   (int)((long long)total * (s + 1) / splits));
}

__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// B fragments of one k16 step from a K-major panel (rows `rb` bytes
// apart, the warp's columns from col0), as conv_tc reads its weights.
__device__ __forceinline__ void b_frags(uint32_t (&b)[NT][2], const char* p,
                                        int rb, int ks, int col0, int lane) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t r[4];
    ldsm_x4_t(r, p + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * rb +
                     (col0 + np * 16 + (lane >> 4) * 8) * 2);
    b[2 * np][0] = r[0];
    b[2 * np][1] = r[1];
    b[2 * np + 1][0] = r[2];
    b[2 * np + 1][1] = r[3];
  }
}

// The warp's value pair (row, col), (row, col + 1) of an accumulator
// tile: rows mt*16 + lane/4 (+8), columns nt*8 + 2*(lane%4).
template <class F>
__device__ __forceinline__ void each_pair(const float (&acc)[MT][NT][4],
                                          int lane, F&& f) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(mt * 16 + lane / 4 + h * 8, nt * 8 + 2 * (lane % 4),
          acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

__device__ __forceinline__ void store_pair(bf16* out, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
}

// Grid (m tiles of the largest class, xs tiles, classes x splits).
__global__ void __launch_bounds__(kDThreads)
    conv2d_bf16_dgrad_tc(DArgs A, DTable T) {
  __shared__ __align__(16) char smem[kGradStages][kDStage];
  __shared__ int3 rows[kDBM];  // dy cell of the class cell, qy, qx
  __shared__ int cell[kDBM];   // its dx cell
  const DClass C = T.cls[blockIdx.z / A.splits];
  const int split = blockIdx.z % A.splits;
  const int mc = A.n * C.hq * C.wq;
  const int m0 = blockIdx.x * kDBM, n0 = blockIdx.y * kDBN;
  if (m0 >= mc) return;  // the whole block, before any barrier
  for (int r = threadIdx.x; r < kDBM; r += blockDim.x) {
    int3 v = make_int3(0, kNoRow, kNoRow);
    int c = 0;
    if (m0 + r < mc) {
      int t = m0 + r;
      const int qx = t % C.wq;
      t /= C.wq;
      const int qy = t % C.hq, nn = t / C.hq;
      v = make_int3((nn * A.ho + qy) * A.wo + qx, qy, qx);
      c = (nn * A.hi + C.y0 + A.stride * qy) * A.wi + C.x0 +
          A.stride * qx;
    }
    rows[r] = v;
    cell[r] = c;
  }
  __syncthreads();

  const int per_tap = A.cop / kChunk;
  const int2 kr = split_range(C.ntaps * per_tap, split, A.splits);
  const int nk = kr.y - kr.x;
  const WSlot wslot = w_slot<2>(kDBN);
  auto load = [&](int i) {
    const int kc = kr.x + i;
    const int ti = kc / per_tap, c0 = (kc - ti * per_tap) * kChunk;
    const int3 tp = T.taps[C.tap0 + ti];
    char* st = smem[i % kGradStages];
    const int off = tp.y * A.wo + tp.z;
    for (int j = threadIdx.x; j < kDBM * 4; j += blockDim.x) {
      const int r = j >> 2, piece = j & 3;
      const int3 rw = rows[r];
      const int y = rw.y + tp.y, x = rw.z + tp.z;
      const int ch = c0 + piece * 8;
      const bool ok =
          y >= 0 && y < A.ho && x >= 0 && x < A.wo && ch < A.ys;
      const bf16* src = ok ? A.dy + (size_t)(rw.x + off) * A.ys + ch : A.dy;
      cp_async16(st + r * kRowA16 + piece * 16, src, ok);
    }
    load_w<2>(A.wt, A.xs, tp.x * A.cop + c0, n0, wslot, st + kDBM * kRowA16,
              kDRowW);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16 * MT;  // one warp column: kDBN == 8 * NT
  float acc[MT][NT][4];
  zero_acc(acc);
  for (int s = 0; s < kGradStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kGradStages - 2>();
    __syncthreads();
    if (i + kGradStages - 1 < nk) load(i + kGradStages - 1);
    cp_async_commit();
    const char* st = smem[i % kGradStages];
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t b[NT][2];
      b_frags(b, st + kDBM * kRowA16, kDRowW, ks, 0, lane);
      mma_a_tile<MT, NT>(acc, st, ks, row0, lane, b);
    }
  }
  cp_async_wait<0>();

  const size_t total = (size_t)A.n * A.hi * A.wi * A.xs;
  each_pair(acc, lane, [&](int r, int c, float v0, float v1) {
    const int col = n0 + c;
    r += row0;
    if (m0 + r >= mc || col >= A.xs) return;  // xs is a multiple of 8
    const size_t o = (size_t)cell[r] * A.xs + col;
    if (A.splits > 1)
      *reinterpret_cast<float2*>(A.ws + split * total + o) =
          make_float2(v0, v1);
    else
      store_pair(A.dx + o, v0, v1);
  });
}

// Grid (xs tiles, ys tiles, k^2 taps x splits).
__global__ void __launch_bounds__(kWThreads) conv2d_bf16_wgrad_tc(WArgs A) {
  __shared__ __align__(16) char smem[kGradStages][kWStage];
  const int tap = blockIdx.z / A.splits, split = blockIdx.z % A.splits;
  const int ky = tap / A.k, kx = tap % A.k;
  const int m0 = blockIdx.x * kWBM, n0 = blockIdx.y * kWBN;
  const int cells = A.n * A.ho * A.wo;
  const int2 kr = split_range((cells + kChunk - 1) / kChunk, split,
                              A.splits);
  const int nk = kr.y - kr.x;
  const int dy0 = ky * A.dil - A.pad, dx0 = kx * A.dil - A.pad;
  auto load = [&](int i) {
    const int c0 = (kr.x + i) * kChunk;
    char* st = smem[i % kGradStages];
    char* bt = st + kChunk * kWRowA;
    // x: kWBM / 8 pieces a row, at the tap-shifted input cell.
    for (int j = threadIdx.x; j < kChunk * (kWBM / 8); j += blockDim.x) {
      const int r = j / (kWBM / 8), piece = j % (kWBM / 8);
      const int m = c0 + r, ch = m0 + piece * 8;
      int t = m;
      const int ox = t % A.wo;
      t /= A.wo;
      const int oy = t % A.ho, nn = t / A.ho;
      const int iy = oy * A.stride + dy0, ix = ox * A.stride + dx0;
      const bool ok = m < cells && ch < A.xs && iy >= 0 && iy < A.hi &&
                      ix >= 0 && ix < A.wi;
      const bf16* src =
          ok ? A.x + (((size_t)nn * A.hi + iy) * A.wi + ix) * A.xs + ch
             : A.x;
      cp_async16(st + r * kWRowA + piece * 16, src, ok);
    }
    // dy: kWBN / 8 pieces a row.
    for (int j = threadIdx.x; j < kChunk * (kWBN / 8); j += blockDim.x) {
      const int r = j / (kWBN / 8), piece = j % (kWBN / 8);
      const int m = c0 + r, ch = n0 + piece * 8;
      const bool ok = m < cells && ch < A.ys;
      const bf16* src = ok ? A.dy + (size_t)m * A.ys + ch : A.dy;
      cp_async16(bt + r * kWRowB + piece * 16, src, ok);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarpsN = kWBN / (8 * NT);
  const int row0 = (warp / kWarpsN) * 16 * MT;
  const int col0 = (warp % kWarpsN) * 8 * NT;
  // A chunk's sum from zero on the tensor cores, then Kahan-added into
  // the block's running sum: over the ~10^4 chunks of a 128^2, batch-64
  // split the tensor cores' own running sum drifts past half a bf16 ulp
  // from the exact one where the products share a sign.
  float run[MT][NT][4], cmp[MT][NT][4];
  zero_acc(run);
  zero_acc(cmp);
  for (int s = 0; s < kGradStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kGradStages - 2>();
    __syncthreads();
    if (i + kGradStages - 1 < nk) load(i + kGradStages - 1);
    cp_async_commit();
    const char* st = smem[i % kGradStages];
    float acc[MT][NT][4];
    zero_acc(acc);
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t b[NT][2];
      b_frags(b, st + kChunk * kWRowA, kWRowB, ks, col0, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // A (channels x cells) from the cell-major x rows: transposed.
        uint32_t a[4];
        ldsm_x4_t(a, st + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * kWRowA +
                         (row0 + mt * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = acc[mt][nt][e] - cmp[mt][nt][e];
          const float t = run[mt][nt][e] + y;
          cmp[mt][nt][e] = (t - run[mt][nt][e]) - y;
          run[mt][nt][e] = t;
        }
  }
  cp_async_wait<0>();

  const size_t total = (size_t)A.k * A.k * A.xs * A.ys;
  each_pair(run, lane, [&](int r, int c, float v0, float v1) {
    const int ch = m0 + row0 + r, col = n0 + col0 + c;
    if (ch >= A.xs || col >= A.ys) return;  // ys is a multiple of 8
    const size_t o = ((size_t)tap * A.xs + ch) * A.ys + col;
    if (A.splits > 1)
      *reinterpret_cast<float2*>(A.ws + split * total + o) =
          make_float2(v0, v1);
    else
      store_pair(A.dw + o, v0, v1);
  });
}

// out = bf16((ws[0] + ws[1]) + ... + ws[S-1]), four values a thread
// (`total` is a multiple of 4).
__global__ void __launch_bounds__(256)
    grad_reduce(const float* __restrict__ ws, bf16* __restrict__ out,
                long long total, int splits) {
  const long long i =
      4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= total) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int k = 1; k < splits; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(ws + k * total + i);
    s.x = s.x + v.x;
    s.y = s.y + v.y;
    s.z = s.z + v.z;
    s.w = s.w + v.w;
  }
  store_pair(out + i, s.x, s.y);
  store_pair(out + i + 2, s.z, s.w);
}

int launch_reduce(const float* ws, bf16* out, long long total, int splits,
                  cudaStream_t s) {
  const long long blocks = (total / 4 + 255) / 256;
  grad_reduce<<<(unsigned)blocks, 256, 0, s>>>(ws, out, total, splits);
  return fnk::launch_status();
}

// ---- the bias gradient ----

// The reduced axes of dy (batch, [depth,] rows, columns; unused leading
// axes 1) and XLA's windows over them: window sizes, low pads and the
// window grid, each outermost first.
constexpr int kAxes = 4;
struct BiasWin {
  int dim[kAxes], win[kAxes], lo[kAxes], grid[kAxes];
};

__device__ __forceinline__ float add_bf16(float s, float v) {
  return __bfloat162float(__float2bfloat16_rn(s + v));
}

// part[w][c] (or db[c] with one window) = the chain s = bf16(s + dy[m][c])
// over window w's cells m in row-major order. A block owns a window and 32
// columns (co is a multiple of 8): warps 1.. stage the next kBiasTile cells
// (16-byte pieces, zero past co and in the pads: adding 0 leaves the chain
// as it is) while warp 0 chains the tile staged before, a column a lane.
constexpr int kBiasThreads = 256, kBiasTile = 256;
__global__ void __launch_bounds__(kBiasThreads)
    bias_windows(const bf16* __restrict__ dy, float* __restrict__ out,
                 BiasWin B, int co) {
  __shared__ __align__(16) bf16 tile[2][kBiasTile][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.y * 32;
  int g[kAxes];
  for (int a = kAxes - 1, w = blockIdx.x; a >= 0; --a) {
    g[a] = w % B.grid[a];
    w /= B.grid[a];
  }
  const int cells = B.win[0] * B.win[1] * B.win[2] * B.win[3];
  const int ntiles = (cells + kBiasTile - 1) / kBiasTile;
  // Stage tile t into buffer t % 2 with threads [t0, kBiasThreads).
  auto stage = [&](int t, int t0) {
    const int base = t * kBiasTile;
    for (int i = threadIdx.x - t0; i < kBiasTile * 4;
         i += kBiasThreads - t0) {
      const int r = i >> 2, piece = i & 3;
      bool ok = base + r < cells && c0 + piece * 8 < co;
      // The window's cell base + r: its coordinates, then its index,
      // row-major over the reduced axes.
      int coord[kAxes];
      for (int a = kAxes - 1, m = base + r; a >= 0; --a) {
        coord[a] = g[a] * B.win[a] + m % B.win[a] - B.lo[a];
        m /= B.win[a];
        ok = ok && coord[a] >= 0 && coord[a] < B.dim[a];
      }
      long long idx = 0;
      for (int a = 0; a < kAxes; ++a) idx = idx * B.dim[a] + coord[a];
      uint4 v = make_uint4(0, 0, 0, 0);
      if (ok)
        v = *reinterpret_cast<const uint4*>(dy + idx * co + c0 + piece * 8);
      *reinterpret_cast<uint4*>(&tile[t & 1][r][piece * 8]) = v;
    }
  };
  stage(0, 0);
  __syncthreads();
  float s = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    if (warp == 0) {
      const int n = min(kBiasTile, cells - t * kBiasTile);
      const bf16* col = &tile[t & 1][0][lane];
#pragma unroll 8
      for (int m = 0; m < n; ++m)
        s = add_bf16(s, __bfloat162float(col[m * 32]));
    } else if (t + 1 < ntiles) {
      stage(t + 1, 32);
    }
    __syncthreads();
  }
  if (warp == 0 && c0 + lane < co)
    out[(size_t)blockIdx.x * co + c0 + lane] = s;
}

// db[c] = the chain over the windows' sums part[w][c] in row-major order.
__global__ void __launch_bounds__(256)
    bias_final(const float* __restrict__ part, float* __restrict__ db,
               int nwin, int co) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= co) return;
  float s = 0.f;
  for (int w = 0; w < nwin; ++w) s = add_bf16(s, part[(size_t)w * co + c]);
  db[c] = s;
}

// The class table from the wrapper's flat ints (class_table's layout): the
// class count; then each class's y0, x0, hq, wq, tap count and its taps
// (tap, oy, ox). False if it is malformed.
bool read_table(DTable& T, const int* t, int k) {
  if (t == nullptr || t[0] < 1 || t[0] > kMaxClasses) return false;
  T.ncls = t[0];
  int taps = 0, at = 1;
  for (int c = 0; c < T.ncls; ++c) {
    const int* v = t + at;
    if (v[2] < 1 || v[3] < 1 || v[4] < 0 || taps + v[4] > kMaxTaps)
      return false;
    T.cls[c] = DClass{v[0], v[1], v[2], v[3], taps, v[4]};
    for (int i = 0; i < v[4]; ++i) {
      const int* tp = v + 5 + 3 * i;
      if (tp[0] < 0 || tp[0] >= k * k) return false;
      T.taps[taps + i] = make_int3(tp[0], tp[1], tp[2]);
    }
    taps += v[4];
    at += 5 + 3 * v[4];
  }
  return taps <= k * k;
}

}  // namespace

// Input gradient dx (n, hi, wi, xs) bf16 of a SAME conv of stride `stride`
// whose HWIO weight, with its channel axes swapped and its output channels
// padded with zero rows to `cop` (a multiple of 32), is `wt` (k^2, cop, xs)
// bf16, from dy (n, ho, wo, ys) bf16; `table` the wrapper's class table
// (host ints, conv_grad.py::class_table); `ws` a (splits, n*hi*wi, xs)
// float32 workspace when splits > 1, else null. Issues 1 launch, 2 with
// splits, on `stream`; returns the first launch error, or
// cudaErrorInvalidValue for bad arguments.
extern "C" int fn_conv2d_bf16_dgrad(const void* dy, const void* wt, void* dx,
                                    float* ws, const int* table, int n,
                                    int hi, int wi, int xs, int ho, int wo,
                                    int ys, int cop, int k, int stride,
                                    int splits, void* stream) {
  DTable T;
  if (!read_table(T, table, k) || (k != 1 && k != 3 && k != 5) ||
      (stride != 1 && stride != 2) || n < 1 || ys < 8 || ys % 8 ||
      cop < ys || cop % kChunk || xs < 8 || xs % 8 || splits < 1 ||
      splits > kMaxSplits || (splits > 1) != (ws != nullptr) ||
      !aligned16(dy) || !aligned16(wt) || !aligned16(dx) ||
      (ws && !aligned16(ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  int tiles = 1;
  for (int c = 0; c < T.ncls; ++c) {
    const DClass& C = T.cls[c];
    tiles = max(tiles, (n * C.hq * C.wq + kDBM - 1) / kDBM);
  }
  DArgs A{static_cast<const bf16*>(dy), static_cast<const bf16*>(wt),
          static_cast<bf16*>(dx), ws, n, hi, wi, xs, ho, wo, ys, cop, stride,
          splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(tiles, (xs + kDBN - 1) / kDBN, T.ncls * splits);
  conv2d_bf16_dgrad_tc<<<grid, kDThreads, 0, s>>>(A, T);
  int status = fnk::launch_status();
  if (status || splits == 1) return status;
  return launch_reduce(ws, A.dx, (long long)n * hi * wi * xs, splits, s);
}

// Weight gradient dw (k^2, xs, ys) bf16 (HWIO) of a SAME conv of NHWC x
// (n, hi, wi, xs) bf16 with stride `stride`, dilation `dil` and low pad
// `pad`, from dy (n, ho, wo, ys) bf16; `ws` a (splits, k^2*xs, ys) float32
// workspace when splits > 1, else null. Issues 1 launch, 2 with splits,
// on `stream`; returns the first launch error, or cudaErrorInvalidValue
// for bad arguments.
extern "C" int fn_conv2d_bf16_wgrad(const void* x, const void* dy, void* dw,
                                    float* ws, int n, int hi, int wi, int xs,
                                    int ho, int wo, int ys, int k,
                                    int stride, int dil, int pad, int splits,
                                    void* stream) {
  if ((k != 1 && k != 3 && k != 5) || (stride != 1 && stride != 2) ||
      (dil != 1 && dil != 2) || n < 1 || xs < 8 || xs % 8 || ys < 8 ||
      ys % 8 || pad < 0 || splits < 1 || splits > kMaxSplits ||
      (splits > 1) != (ws != nullptr) || !aligned16(x) || !aligned16(dy) ||
      !aligned16(dw) || (ws && !aligned16(ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  WArgs A{static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
          static_cast<bf16*>(dw), ws, n, hi, wi, xs, ho, wo, ys, k, stride,
          dil, pad, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((xs + kWBM - 1) / kWBM, (ys + kWBN - 1) / kWBN, k * k * splits);
  conv2d_bf16_wgrad_tc<<<grid, kWThreads, 0, s>>>(A);
  int status = fnk::launch_status();
  if (status || splits == 1) return status;
  return launch_reduce(ws, A.dw, (long long)k * k * xs * ys, splits, s);
}

// Bias gradient db (co) float32 (bf16 values) of a bfloat16 conv from its
// output gradient dy (cells, co) bf16, the cells being the row-major
// product of the reduced axes; `win` the wrapper's 16 host ints (the four
// axes' lengths, window sizes, low pads and window counts, outermost
// first; conv_grad.py::bias_windows); `part` a (windows, co) float32
// workspace when there is more than one window, else null. Issues 1
// launch, 2 with windows, on `stream`; returns the first launch error, or
// cudaErrorInvalidValue for bad arguments.
extern "C" int fn_bias_grad_bf16(const void* dy, float* db, float* part,
                                 const int* win, int co, void* stream) {
  if (win == nullptr || co < 8 || co % 8 || !aligned16(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  BiasWin B;
  long long nwin = 1;
  for (int a = 0; a < kAxes; ++a) {
    B.dim[a] = win[a];
    B.win[a] = win[kAxes + a];
    B.lo[a] = win[2 * kAxes + a];
    B.grid[a] = win[3 * kAxes + a];
    if (B.dim[a] < 1 || B.win[a] < 1 || B.lo[a] < 0 || B.grid[a] < 1 ||
        (long long)B.win[a] * B.grid[a] < B.dim[a] + B.lo[a])
      return static_cast<int>(cudaErrorInvalidValue);
    nwin *= B.grid[a];
  }
  if ((nwin > 1) != (part != nullptr) || nwin > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)nwin, (co + 31) / 32);
  bias_windows<<<grid, kBiasThreads, 0, s>>>(static_cast<const bf16*>(dy),
                                             nwin > 1 ? part : db, B, co);
  int status = fnk::launch_status();
  if (status || nwin == 1) return status;
  bias_final<<<(co + 255) / 256, 256, 0, s>>>(part, db, (int)nwin, co);
  return fnk::launch_status();
}
