// The gradients of kernel N's convolution on the flax route, for training
// FluidNet3: the input gradient fn_conv3d_dgrad and the weight gradient
// fn_conv3d_wgrad of one NDHWC 3-D conv (kernel 1 or 3, stride 1
// or 2, flax SAME padding), from the bfloat16 gradient of its output (the
// ReLU mask already applied by the wrapper, ops/kernels/conv_grad3.py).
//
// They replace no TPU kernel: JAX differentiates flax
// nn.Conv(dtype="bfloat16") with XLA (scripts/train3d.py's
// jax.value_and_grad), and the Pallas forward punet3_forward_pallas has no
// custom_vjp. The port needs them because every conv of FluidNet3 on the
// card runs on kernel N (csrc/conv3d.cu). Rounding, as XLA's on the CPU:
// bfloat16 operands, every product exact in float32, the input and weight
// gradients summed in float32 and rounded to bfloat16 once. The bias
// gradient (XLA's reduce of the bfloat16 cotangent of the bias's
// broadcast, each add rounded, in the order of XLA's tree reduction) is
// conv2d_bf16_grad.cu's fn_bias_grad_bf16, which the 2-D and 3-D
// wrappers share. Plain versions: conv3d_dgrad_plain and
// conv3d_wgrad_plain in conv_grad3.py.
//
// What bounds them on an H100: at 3-D training's shapes (8^3 and 4^3
// latent maps at batch 4, 96-1024 channels) a layer's gradient moves at
// most ~4 MB and does at most ~2 GFLOP, ~1.3 us at 3.35 TB/s and ~2 us at
// the dense bf16 rate (989 TFLOP/s). What sets their time is the latency
// of a block's chain of chunks and filling 132 SMs with a few thousand
// output values, so both split their reduction over more blocks and add
// the float32 partials in a fixed order (repeats are bit-equal; no
// atomics).
//
// Design. Both are implicit GEMMs in bf16 mma.sync m16n8k16 with float32
// accumulators, 32x32 warp tiles, K staged 32 at a time through a 4-deep
// cp.async ring whose zero-fill copies stand for the SAME padding and the
// ragged edges, as N's forward body conv_tc (conv_mma.cuh), whose
// loaders, ldmatrix and mma wrappers they share.
//  * dgrad: M = dx cells of one output-parity class, N = input channels,
//    K = the class's taps x output channels. A row gathers dy at the
//    class cell plus the tap's offset (zero off the map); the weight panel
//    is the DHWIO weight with its channel axes swapped (k^3, co, ci), made
//    by the wrapper, read like N's. At stride 1 one class holds every
//    dx cell and all k^3 taps; at stride 2 the 8 classes of (z, y, x)
//    parities each take only the taps that land on their cells (27 taps
//    in all, not 27 a class). The class table comes from the wrapper.
//  * wgrad: per tap, M = input channels, N = output channels, K = output
//    cells. A chunk stages x at 32 output cells' tap-shifted input cells
//    (rows of channels) and dy at those cells; both operands reach the
//    MMA through ldmatrix.trans.
#include <cuda_bf16.h>

#include "conv_mma.cuh"

namespace {

using namespace fnk::conv;
using bf16 = __nv_bfloat16;

constexpr int kMaxClasses = 8;   // parity classes of a stride-2 3-D conv
constexpr int kMaxTaps = 27;     // a 3x3x3 kernel
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

// One output-parity class of dx: its cells (z0 + s*qz, y0 + s*qy, x0 +
// s*qx) for qz < dq, qy < hq, qx < wq, and its taps taps[tap0 ..
// tap0+ntaps), each (tap, oz, oy, ox): class cell q reads dy at q + o
// through weight tap `tap`.
struct DClass {
  int z0, y0, x0, dq, hq, wq, tap0, ntaps;
};
struct DTable {
  int ncls;
  DClass cls[kMaxClasses];
  int4 taps[kMaxTaps];
};

struct DArgs {
  const bf16* dy;  // (n, dout, ho, wo, co)
  const bf16* wt;  // (k^3, co, ci)
  bf16* dx;        // (n, di, hi, wi, ci)
  float* ws;       // (splits, n*di*hi*wi, ci) when splits > 1
  int n, di, hi, wi, ci, dout, ho, wo, co, stride, splits;
};

struct WArgs {
  const bf16* x;   // (n, di, hi, wi, ci)
  const bf16* dy;  // (n, dout, ho, wo, co)
  bf16* dw;        // (k^3, ci, co)
  float* ws;       // (splits, k^3 * ci, co) when splits > 1
  int n, di, hi, wi, ci, dout, ho, wo, co, k, stride, pad, splits;
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

// Grid (m tiles of the largest class, ci tiles, classes x splits).
__global__ void __launch_bounds__(kDThreads)
    conv3d_dgrad_tc(DArgs A, DTable T) {
  __shared__ __align__(16) char smem[kGradStages][kDStage];
  __shared__ int4 rows[kDBM];  // dy cell of the class cell, qz, qy, qx
  __shared__ int cell[kDBM];   // its dx cell
  const DClass C = T.cls[blockIdx.z / A.splits];
  const int split = blockIdx.z % A.splits;
  const int mc = A.n * C.dq * C.hq * C.wq;
  const int m0 = blockIdx.x * kDBM, n0 = blockIdx.y * kDBN;
  if (m0 >= mc) return;  // the whole block, before any barrier
  for (int r = threadIdx.x; r < kDBM; r += blockDim.x) {
    int4 v = make_int4(0, kNoRow, kNoRow, kNoRow);
    int c = 0;
    if (m0 + r < mc) {
      int t = m0 + r;
      const int qx = t % C.wq;
      t /= C.wq;
      const int qy = t % C.hq;
      t /= C.hq;
      const int qz = t % C.dq, nn = t / C.dq;
      v = make_int4(((nn * A.dout + qz) * A.ho + qy) * A.wo + qx, qz, qy,
                    qx);
      c = ((nn * A.di + C.z0 + A.stride * qz) * A.hi + C.y0 +
           A.stride * qy) * A.wi + C.x0 + A.stride * qx;
    }
    rows[r] = v;
    cell[r] = c;
  }
  __syncthreads();

  const int per_tap = A.co / kChunk;
  const int2 kr = split_range(C.ntaps * per_tap, split, A.splits);
  const int nk = kr.y - kr.x;
  const WSlot wslot = w_slot<2>(kDBN);
  auto load = [&](int i) {
    const int kc = kr.x + i;
    const int ti = kc / per_tap, c0 = (kc - ti * per_tap) * kChunk;
    const int4 tp = T.taps[C.tap0 + ti];
    char* st = smem[i % kGradStages];
    const int off = (tp.y * A.ho + tp.z) * A.wo + tp.w;
    for (int j = threadIdx.x; j < kDBM * 4; j += blockDim.x) {
      const int r = j >> 2, piece = j & 3;
      const int4 rw = rows[r];
      const int z = rw.y + tp.y, y = rw.z + tp.z, x = rw.w + tp.w;
      const bool ok = z >= 0 && z < A.dout && y >= 0 && y < A.ho && x >= 0 &&
                      x < A.wo;
      const bf16* src =
          ok ? A.dy + (size_t)(rw.x + off) * A.co + c0 + piece * 8 : A.dy;
      cp_async16(st + r * kRowA16 + piece * 16, src, ok);
    }
    load_w<2>(A.wt, A.ci, tp.x * A.co + c0, n0, wslot, st + kDBM * kRowA16,
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

  const size_t total = (size_t)A.n * A.di * A.hi * A.wi * A.ci;
  each_pair(acc, lane, [&](int r, int c, float v0, float v1) {
    const int col = n0 + c;
    r += row0;
    if (m0 + r >= mc || col >= A.ci) return;  // ci is a multiple of 8
    const size_t o = (size_t)cell[r] * A.ci + col;
    if (A.splits > 1)
      *reinterpret_cast<float2*>(A.ws + split * total + o) =
          make_float2(v0, v1);
    else
      store_pair(A.dx + o, v0, v1);
  });
}

// Grid (ci tiles, co tiles, k^3 taps x splits).
__global__ void __launch_bounds__(kWThreads) conv3d_wgrad_tc(WArgs A) {
  __shared__ __align__(16) char smem[kGradStages][kWStage];
  const int tap = blockIdx.z / A.splits, split = blockIdx.z % A.splits;
  const int kz = tap / (A.k * A.k), ky = (tap / A.k) % A.k, kx = tap % A.k;
  const int m0 = blockIdx.x * kWBM, n0 = blockIdx.y * kWBN;
  const int cells = A.n * A.dout * A.ho * A.wo;
  const int2 kr = split_range((cells + kChunk - 1) / kChunk, split,
                              A.splits);
  const int nk = kr.y - kr.x;
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
      const int oy = t % A.ho;
      t /= A.ho;
      const int oz = t % A.dout, nn = t / A.dout;
      const int iz = oz * A.stride - A.pad + kz,
                iy = oy * A.stride - A.pad + ky,
                ix = ox * A.stride - A.pad + kx;
      const bool ok = m < cells && ch < A.ci && iz >= 0 && iz < A.di &&
                      iy >= 0 && iy < A.hi && ix >= 0 && ix < A.wi;
      const bf16* src =
          ok ? A.x + ((((size_t)nn * A.di + iz) * A.hi + iy) * A.wi + ix) *
                             A.ci + ch
             : A.x;
      cp_async16(st + r * kWRowA + piece * 16, src, ok);
    }
    // dy: kWBN / 8 pieces a row.
    for (int j = threadIdx.x; j < kChunk * (kWBN / 8); j += blockDim.x) {
      const int r = j / (kWBN / 8), piece = j % (kWBN / 8);
      const int m = c0 + r, ch = n0 + piece * 8;
      const bool ok = m < cells && ch < A.co;
      const bf16* src = ok ? A.dy + (size_t)m * A.co + ch : A.dy;
      cp_async16(bt + r * kWRowB + piece * 16, src, ok);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarpsN = kWBN / (8 * NT);
  const int row0 = (warp / kWarpsN) * 16 * MT;
  const int col0 = (warp % kWarpsN) * 8 * NT;
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
  }
  cp_async_wait<0>();

  const size_t total = (size_t)A.k * A.k * A.k * A.ci * A.co;
  each_pair(acc, lane, [&](int r, int c, float v0, float v1) {
    const int ch = m0 + row0 + r, col = n0 + col0 + c;
    if (ch >= A.ci || col >= A.co) return;  // co is a multiple of 8
    const size_t o = ((size_t)tap * A.ci + ch) * A.co + col;
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

// The class table from the wrapper's flat ints: the class count; each
// class's z0, y0, x0, dq, hq, wq, tap count; then every class's taps
// (tap, oz, oy, ox) in class order. False if it is malformed.
bool read_table(DTable& T, const int* t, int k) {
  if (t == nullptr || t[0] < 1 || t[0] > kMaxClasses) return false;
  T.ncls = t[0];
  int taps = 0;
  for (int c = 0; c < T.ncls; ++c) {
    const int* v = t + 1 + 7 * c;
    T.cls[c] = DClass{v[0], v[1], v[2], v[3], v[4], v[5], taps, v[6]};
    if (v[3] < 1 || v[4] < 1 || v[5] < 1 || v[6] < 0) return false;
    taps += v[6];
  }
  if (taps > k * k * k) return false;
  const int* tp = t + 1 + 7 * T.ncls;
  for (int i = 0; i < taps; ++i) {
    T.taps[i] = make_int4(tp[4 * i], tp[4 * i + 1], tp[4 * i + 2],
                          tp[4 * i + 3]);
    if (T.taps[i].x < 0 || T.taps[i].x >= k * k * k) return false;
  }
  return true;
}

}  // namespace

// Input gradient dx (n, di, hi, wi, ci) bf16 of a SAME conv of stride
// `stride` whose DHWIO weight, with its channel axes swapped, is `wt` (k^3,
// co, ci) bf16, from dy (n, dout, ho, wo, co) bf16; `table` the wrapper's
// class table (host ints, read_table's layout); `ws` a (splits, n*di*hi*wi,
// ci) float32 workspace when splits > 1, else null. Issues 1 launch, 2
// with splits, on `stream`; returns the first launch error, or
// cudaErrorInvalidValue for bad arguments.
extern "C" int fn_conv3d_dgrad(const void* dy, const void* wt, void* dx,
                               float* ws, const int* table, int n, int di,
                               int hi, int wi, int ci, int dout, int ho,
                               int wo, int co, int k, int stride, int splits,
                               void* stream) {
  DTable T;
  if (!read_table(T, table, k) || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) || n < 1 || co < kChunk ||
      co % kChunk || ci < 8 || ci % 8 || splits < 1 ||
      splits > kMaxSplits || (splits > 1) != (ws != nullptr) ||
      !aligned16(dy) || !aligned16(wt) || !aligned16(dx) ||
      (ws && !aligned16(ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  int tiles = 1;
  for (int c = 0; c < T.ncls; ++c) {
    const DClass& C = T.cls[c];
    tiles = max(tiles, (n * C.dq * C.hq * C.wq + kDBM - 1) / kDBM);
  }
  DArgs A{static_cast<const bf16*>(dy), static_cast<const bf16*>(wt),
          static_cast<bf16*>(dx), ws, n, di, hi, wi, ci, dout, ho, wo, co,
          stride, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(tiles, (ci + kDBN - 1) / kDBN, T.ncls * splits);
  conv3d_dgrad_tc<<<grid, kDThreads, 0, s>>>(A, T);
  int status = fnk::launch_status();
  if (status || splits == 1) return status;
  return launch_reduce(ws, A.dx, (long long)n * di * hi * wi * ci, splits,
                       s);
}

// Weight gradient dw (k^3, ci, co) bf16 (DHWIO) of a SAME conv of NDHWC x
// (n, di, hi, wi, ci) bf16 with stride `stride` and low pad `pad`, from dy
// (n, dout, ho, wo, co) bf16; `ws` a (splits, k^3*ci, co) float32
// workspace when splits > 1, else null. Issues 1 launch, 2 with splits, on
// `stream`; returns the first launch error, or cudaErrorInvalidValue for
// bad arguments. The bias gradient is conv2d_bf16_grad.cu's
// fn_bias_grad_bf16.
extern "C" int fn_conv3d_wgrad(const void* x, const void* dy, void* dw,
                               float* ws, int n, int di, int hi, int wi,
                               int ci, int dout, int ho, int wo, int co,
                               int k, int stride, int pad, int splits,
                               void* stream) {
  if ((k != 1 && k != 3) || (stride != 1 && stride != 2) || n < 1 ||
      ci < 8 || ci % 8 || co < 8 || co % 8 || pad < 0 || splits < 1 ||
      splits > kMaxSplits || (splits > 1) != (ws != nullptr) ||
      !aligned16(x) || !aligned16(dy) || !aligned16(dw) ||
      (ws && !aligned16(ws)))
    return static_cast<int>(cudaErrorInvalidValue);
  WArgs A{static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
          static_cast<bf16*>(dw), ws, n, di, hi, wi, ci, dout, ho, wo, co,
          k, stride, pad, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((ci + kWBM - 1) / kWBM, (co + kWBN - 1) / kWBN,
            k * k * k * splits);
  conv3d_wgrad_tc<<<grid, kWThreads, 0, s>>>(A);
  int status = fnk::launch_status();
  if (status || splits == 1) return status;
  return launch_reduce(ws, A.dw, (long long)k * k * k * ci * co, splits, s);
}
