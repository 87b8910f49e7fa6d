// Shared pieces of the two convolution kernels, B (conv2d.cu: 3xTF32) and
// N (conv3d.cu: bf16): the layer geometry and the planner's decision, the
// per-block table of output cells, the cp.async stage loaders with
// zero-fill for SAME padding and ragged edges, the ldmatrix/mma.sync
// wrappers, the fixed-order split-K reduce and the host-side launch.
//
// Implicit GEMM: M = output cells, N = output channels, K = taps x input
// channels (the concat's [x1 | x2]). A block owns a bm x bn output tile of
// 32x32 warp tiles and walks its split's K range in chunks of kChunk
// channels, each inside one tap and one input (the channel counts are
// multiples of kChunk): a kStages-deep ring of cp.async copies, 16 bytes
// each, stages the gathered input rows and the weight panel's rows in
// shared memory while the warps multiply the chunk that has arrived. The
// tile and the K ranges of the splits come from the planner
// (ops/kernels/conv_plan.py); plan_ok() refuses a plan the kernels cannot
// run. With one split the epilogue adds the bias, applies the ReLU and
// rounds to the output type; with more, each split writes its float32
// partial tile to a workspace and splitk_reduce adds the splits in order
// 0..S-1, then the bias, then the ReLU, then rounds: repeats are bit-equal
// and no sum uses atomics.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace fnk {
namespace conv {

constexpr int kChunk = 32;      // K channels a stage (tensor-core routes)
constexpr int kStages = 4;      // depth of the cp.async ring (default)
constexpr int kMaxSplits = 64;  // ops/kernels/conv_plan.py::MAX_SPLITS
constexpr int kMaxTile = 8192;  // bm * bn: at most 8 warps of 32x32
constexpr int kMaxThreads = kMaxTile / 32;
constexpr int kMaxSmem = 227 * 1024;

// One layer: NDHWC input (n, di, hi, wi, c1 [+ c2]) -> (n, dout, ho, wo,
// co); a 2-D layer is depth 1 (di = dout = kd = 1, pad_d 0). Taps kd x k x
// k, dilation dil, the input corner of output cell o is o * stride - pad.
struct Geom {
  int n, di, hi, wi, dout, ho, wo, co;
  int kd, k, stride, dil, pad, pad_d;
  int c1, c2;
};

// The planner's decision: block tile bm x bn of warp tiles 32 x 32 (warp_m
// 32) or 64 x bn/2 (warp_m 64, "wide"); split s covers K offsets kbeg[s]
// .. kbeg[s+1] (elements).
struct Plan {
  int bm, bn, warp_m, splits;
  int kbeg[kMaxSplits + 1];
};

// Threads of a block of the plan's warp tiles.
inline int plan_threads(const Plan& p) {
  return p.warp_m == 64 ? 2 * 32 * (p.bm / 64) : p.bm * p.bn / 32;
}

struct Args {
  const void* x1;
  const void* x2;          // null when c2 is 0
  const void* wgt;         // (kd*k*k*(c1+c2), co) row-major
  const float* bias;       // (co)
  const float* in_scale;   // (n) or null: scales x1 channels c % mod == 0
  void* out;               // (M, co)
  float* ws;               // (splits, M, co) when splits > 1
  Geom g;
  int relu, scale_mod;
  // Round the float32 sum to the output type before the bias is added
  // (flax nn.Conv in bfloat16: the conv's result is bfloat16, then the
  // bias add rounds again); 0: the bias joins the float32 sum.
  int round_sum = 0;
};

__host__ __device__ inline int cells(const Geom& g) {
  return g.n * g.dout * g.ho * g.wo;
}
__host__ __device__ inline int ktot(const Geom& g) {
  return g.kd * g.k * g.k * (g.c1 + g.c2);
}

// Host side: the checks the kernels need of a plan; `chunk` is the route's
// stage width, `fixed_tile` the SIMT route's 64x64 tile or 0, `wide`
// whether the route has the 64 x bn/2 warp tile (bn 64, 96 or 128).
inline bool plan_ok(const Geom& g, const Plan& p, int chunk, int fixed_tile,
                    bool wide) {
  if (p.splits < 1 || p.splits > kMaxSplits) return false;
  if (fixed_tile) {
    if (p.bm != fixed_tile || p.bn != fixed_tile || p.warp_m != 32)
      return false;
  } else if (p.warp_m == 64) {
    if (!wide || (p.bm != 64 && p.bm != 128) ||
        (p.bn != 64 && p.bn != 96 && p.bn != 128))
      return false;
  } else if (p.warp_m != 32 || p.bm < 32 || p.bm > 128 || p.bm % 32 ||
             p.bn < 32 || p.bn > 256 || p.bn % 32 || p.bm * p.bn > kMaxTile) {
    return false;
  }
  if (g.c1 < chunk || g.c1 % chunk || g.c2 % chunk) return false;
  if (p.kbeg[0] != 0 || p.kbeg[p.splits] != ktot(g)) return false;
  for (int s = 0; s < p.splits; ++s)
    if (p.kbeg[s + 1] <= p.kbeg[s] || p.kbeg[s] % chunk) return false;
  return true;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- device primitives ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; writes zeros (source size 0) when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small with big = tf32(x) rounded to nearest (ties away), small
// = tf32(x - big); x - big is exact in float32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Split two float32 values (one bf16x2 fragment register) into three
// bf16x2 registers by round-to-nearest steps: hi = bf16(x), mid =
// bf16(x - hi), lo = x - hi - mid. Each difference is exact in float32 and
// lo is a bf16 value, so hi + mid + lo == x for |x| from 2^-100 to 2^100
// (far below that lo falls into bf16's subnormals and loses bits), and
// each piece times a bf16 weight is exact in float32. Packed conversions
// (cvt.rn.bf16x2.f32): one instruction a pair.
__device__ __forceinline__ void split_bf16x3(float2 v, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(v.x - hf.x, v.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(r.x - mf.x, r.y - mf.y));
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
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---- block set-up and stage loaders ----

// Rows past the last output cell: an input corner no tap reaches.
constexpr int kNoRow = -(1 << 28);

// rows[r] = (input cell index of the corner, z, y, x of the corner) of
// output cell m0 + r, the corner being o * stride - pad (kNoRow past the
// last cell); rscale[r] = in_scale[sample] (1 without it).
__device__ __forceinline__ void fill_rows(const Args& A, int m0, int bm,
                                          int4* rows, float* rscale) {
  const Geom& g = A.g;
  const int M = cells(g);
  for (int r = threadIdx.x; r < bm; r += blockDim.x) {
    int4 v = make_int4(0, kNoRow, kNoRow, kNoRow);
    float s = 1.f;
    if (m0 + r < M) {
      int mc = m0 + r;
      const int x = mc % g.wo * g.stride - g.pad;
      mc /= g.wo;
      const int y = mc % g.ho * g.stride - g.pad;
      mc /= g.ho;
      const int z = mc % g.dout * g.stride - g.pad_d;
      const int nn = mc / g.dout;
      v = make_int4(((nn * g.di + z) * g.hi + y) * g.wi + x, z, y, x);
      if (A.in_scale) s = A.in_scale[nn];
    }
    rows[r] = v;
    rscale[r] = s;
  }
}

// Where the chunks of a K range lie, one chunk after another: the tap's
// input offsets (dz, dy, dx), its cell offset `off` and the chunk's first
// channel in [x1 | x2]. Divides once, at the range's start.
struct Tap {
  int dz, dy, dx, off, c;
};
struct TapIter {
  int c, kx, ky, kz;
  __device__ __forceinline__ TapIter(const Geom& g, int k0) {
    const int cin = g.c1 + g.c2, tap = k0 / cin, kk = g.k * g.k;
    c = k0 - tap * cin;
    kz = tap / kk;
    ky = (tap % kk) / g.k;
    kx = tap % g.k;
  }
  __device__ __forceinline__ Tap next(const Geom& g) {
    const int dz = kz * g.dil, dy = ky * g.dil, dx = kx * g.dil;
    const Tap t{dz, dy, dx, (dz * g.hi + dy) * g.wi + dx, c};
    c += kChunk;
    if (c == g.c1 + g.c2) {
      c = 0;
      if (++kx == g.k) {
        kx = 0;
        if (++ky == g.k) {
          ky = 0;
          ++kz;
        }
      }
    }
    return t;
  }
};

// One stage's A tile: kChunk channels (from `cc` of an input with `cx`
// channels of ES bytes) of each of the bm gathered rows, rows `row_bytes`
// apart; out-of-range cells are zero-filled.
template <int ES>
__device__ __forceinline__ void load_a(const Geom& g, const int4* rows,
                                       int bm, const void* src, int cx,
                                       int cc, const Tap& t, char* dst,
                                       int row_bytes) {
  constexpr int kCopies = kChunk * ES / 16;
  const char* base = static_cast<const char*>(src) + (size_t)cc * ES;
  for (int i = threadIdx.x; i < bm * kCopies; i += blockDim.x) {
    const int r = i / kCopies, piece = i % kCopies;
    const int4 rw = rows[r];
    const int iz = rw.y + t.dz, iy = rw.z + t.dy, ix = rw.w + t.dx;
    const bool ok = iz >= 0 && iz < g.di && iy >= 0 && iy < g.hi &&
                    ix >= 0 && ix < g.wi;
    const char* p =
        ok ? base + (size_t)(rw.x + t.off) * cx * ES + piece * 16 : base;
    cp_async16(dst + r * row_bytes + piece * 16, p, ok);
  }
}

// A thread's share of the weight tile, fixed over the K loop: the 16-byte
// piece `piece` of rows kk0, kk0 + kstep, ... (threads past the last
// whole set of a row's pieces copy nothing).
struct WSlot {
  int piece, kk0, kstep;
};
template <int ES>
__device__ __forceinline__ WSlot w_slot(int bn) {
  const int per_row = bn * ES / 16;
  const int kstep = (int)blockDim.x / per_row;
  const int kk0 = (int)threadIdx.x / per_row;
  return WSlot{(int)threadIdx.x % per_row, kk0 < kstep ? kk0 : kChunk,
               kstep};
}

// One stage's weight tile: rows k0 .. k0+kChunk-1, columns n0 .. n0+bn-1
// (zero past co, which is a multiple of 16 / ES), rows `row_bytes` apart.
template <int ES>
__device__ __forceinline__ void load_w(const void* wgt, int co, int k0,
                                       int n0, const WSlot& ws, char* dst,
                                       int row_bytes) {
  const int col = n0 + ws.piece * (16 / ES);
  const bool ok = col < co;
  const char* base = static_cast<const char*>(wgt);
  const char* src = base + ((size_t)k0 * co + col) * ES;
  for (int kk = ws.kk0; kk < kChunk; kk += ws.kstep)
    cp_async16(dst + kk * row_bytes + ws.piece * 16,
               ok ? src + (size_t)kk * co * ES : base, ok);
}

// ---- epilogue and the split-K reduce ----

// A warp's (16 MT) x (8 NT) accumulator tile (acc[mt][nt]: rows mt*16 +
// lane/4 (+8), columns nt*8 + 2*(lane%4) (+1)) at (row0, col0) of the
// output: with one split bias, ReLU and rounding to TO; else the raw
// partial sums into the split's slice of the workspace.
template <class TO, int MT, int NT>
__device__ __forceinline__ void store_tile(const Args& A, int splits,
                                           int split, int row0, int col0,
                                           const float (&acc)[MT][NT][4]) {
  const int M = cells(A.g), co = A.g.co;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + mt * 16 + lane / 4 + h * 8;
        const int col = col0 + nt * 8 + 2 * (lane % 4);
        if (m >= M || col >= co) continue;  // co is even
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (splits > 1) {
          *reinterpret_cast<float2*>(
              A.ws + ((size_t)split * M + m) * co + col) = make_float2(v0, v1);
          continue;
        }
        if (A.round_sum) {
          v0 = to_float(narrow<TO>(v0));
          v1 = to_float(narrow<TO>(v1));
        }
        v0 = v0 + A.bias[col];
        v1 = v1 + A.bias[col + 1];
        if (A.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        TO* out = static_cast<TO*>(A.out) + (size_t)m * co + col;
        out[0] = narrow<TO>(v0);
        out[1] = narrow<TO>(v1);
      }
}

// out = round(relu(((ws[0] + ws[1]) + ... + ws[S-1]) + bias)), four
// values a thread (co is a multiple of 4); with round_sum the sum is
// rounded to TO before the bias is added.
template <class TO>
__global__ void __launch_bounds__(256)
    splitk_reduce(const float* __restrict__ ws, const float* bias, TO* out,
                  long long total, int co, int splits, int relu,
                  int round_sum) {
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
  const int col = static_cast<int>(i % co);
  float y[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (round_sum) y[j] = to_float(narrow<TO>(y[j]));
    y[j] = y[j] + bias[col + j];
    if (relu) y[j] = fmaxf(y[j], 0.f);
    out[i + j] = narrow<TO>(y[j]);
  }
}

// ---- the bf16 tensor-core body (kernel N; kernel B's bfloat16 route) ----

// Shared-memory rows of one stage: a bf16 A row of kChunk channels is 64
// bytes + 16 of padding (ldmatrix's eight rows then fall on distinct
// banks), a float32 one 128 + 16; a weight row is bn bf16 values + 16
// bytes. With a float32 x1 the block also holds the chunk's bf16x3 split:
// three bf16 A tiles (hi, mid, lo) after the stages.
constexpr int kRowA16 = kChunk * 2 + 16;
constexpr int kRowA32 = kChunk * 4 + 16;

template <class T1>
__host__ __device__ constexpr bool f32_x1() {
  return std::is_same<T1, float>::value;
}
template <class T1>
__host__ __device__ constexpr int row_a() {
  return f32_x1<T1>() ? kRowA32 : kRowA16;
}
__host__ __device__ constexpr int row_w16(int bn) { return bn * 2 + 16; }
template <class T1>
__host__ __device__ constexpr int tc_stage_bytes(int bm, int bn) {
  return bm * row_a<T1>() + kChunk * row_w16(bn);
}
template <class T1>
__host__ __device__ constexpr int tc_smem_bytes(int bm, int bn, int stages) {
  return stages * tc_stage_bytes<T1>(bm, bn) +
         (f32_x1<T1>() ? 3 * bm * kRowA16 : 0) + bm * (16 + 4);
}

// acc += A (bf16, from `a_tile`, kRowA16 rows, the warp's rows from
// `row0`) x B fragments of one k16 step.
template <int MT, int NT>
__device__ __forceinline__ void mma_a_tile(float (&acc)[MT][NT][4],
                                           const char* a_tile, int ks,
                                           int row0, int lane,
                                           const uint32_t (&b)[NT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t a[4];
    ldsm_x4(a, a_tile + (row0 + mt * 16 + (lane & 15)) * kRowA16 +
                   (ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
  }
}

// A block of warps with (16 MT) x (8 NT) warp tiles over a bm x bn tile
// (MT 2, NT 4: 32x32; MT 4, NT bn/16: the wide 64 x bn/2), K through a
// STAGES-deep ring.
template <class T1, class TO, int MT, int NT, int STAGES>
__global__ void __launch_bounds__(kMaxThreads)
    conv_tc(Args A, Plan P) {
  extern __shared__ __align__(16) char smem[];
  constexpr bool kF32 = f32_x1<T1>();
  const Geom& g = A.g;
  const int bm = P.bm, bn = P.bn, rw = row_w16(bn);
  const int stage = tc_stage_bytes<T1>(bm, bn);
  char* x3 = smem + STAGES * stage;  // the bf16x3 tiles (float32 x1)
  int4* rows = reinterpret_cast<int4*>(x3 + (kF32 ? 3 * bm * kRowA16 : 0));
  float* rscale = reinterpret_cast<float*>(rows + bm);
  const int m0 = blockIdx.x * bm, n0 = blockIdx.y * bn, split = blockIdx.z;
  fill_rows(A, m0, bm, rows, rscale);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps_n = bn / (8 * NT);
  const int row0 = (warp / warps_n) * 16 * MT;
  const int col0 = (warp % warps_n) * 8 * NT;
  const int kb = P.kbeg[split];
  const int nk = (P.kbeg[split + 1] - kb) / kChunk;
  const WSlot wslot = w_slot<2>(bn);

  TapIter taps(g, kb);
  auto load = [&](int kc) {
    const int k0 = kb + kc * kChunk;
    char* st = smem + (kc % STAGES) * stage;
    const Tap t = taps.next(g);  // chunks load in order
    if (t.c < g.c1)
      load_a<(int)sizeof(T1)>(g, rows, bm, A.x1, g.c1, t.c, t, st,
                              row_a<T1>());
    else
      load_a<2>(g, rows, bm, A.x2, g.c2, t.c - g.c1, t, st, kRowA16);
    load_w<2>(A.wgt, g.co, k0, n0, wslot, st + bm * row_a<T1>(), rw);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  const int cin = g.c1 + g.c2;
  int c_mma = kb % cin;  // the first channel of the chunk the warps multiply
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kc + STAGES - 1 < nk) load(kc + STAGES - 1);
    cp_async_commit();

    const char* st = smem + (kc % STAGES) * stage;
    const char* wt = st + bm * row_a<T1>();
    const bool f32_chunk = kF32 && c_mma < g.c1;
    c_mma = c_mma + kChunk == cin ? 0 : c_mma + kChunk;
    if (f32_chunk) {
      // Split the float32 tile once for the block: hi, mid, lo tiles.
      for (int i = threadIdx.x; i < bm * (kChunk / 4); i += blockDim.x) {
        const int r = i / (kChunk / 4), q = i % (kChunk / 4);
        const float4 v =
            *reinterpret_cast<const float4*>(st + r * kRowA32 + q * 16);
        uint2 hi, mid, lo;
        split_bf16x3(make_float2(v.x, v.y), hi.x, mid.x, lo.x);
        split_bf16x3(make_float2(v.z, v.w), hi.y, mid.y, lo.y);
        char* d = x3 + r * kRowA16 + q * 8;
        *reinterpret_cast<uint2*>(d) = hi;
        *reinterpret_cast<uint2*>(d + bm * kRowA16) = mid;
        *reinterpret_cast<uint2*>(d + 2 * bm * kRowA16) = lo;
      }
      __syncthreads();
    }
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t b[NT][2];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, wt + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * rw +
                         (col0 + np * 16 + (lane >> 4) * 8) * 2);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
      if (f32_chunk) {  // lo, mid, hi: three exact products
        mma_a_tile<MT, NT>(acc, x3 + 2 * bm * kRowA16, ks, row0, lane, b);
        mma_a_tile<MT, NT>(acc, x3 + bm * kRowA16, ks, row0, lane, b);
        mma_a_tile<MT, NT>(acc, x3, ks, row0, lane, b);
      } else {
        mma_a_tile<MT, NT>(acc, st, ks, row0, lane, b);
      }
    }
  }
  store_tile<TO, MT, NT>(A, P.splits, split, m0 + row0, n0 + col0, acc);
}

// ---- host launch ----

// Launch `kern` on the plan's grid (m tiles, n tiles, splits) with `smem`
// bytes of dynamic shared memory, then the reduce when there are splits.
template <class TO, class Kernel>
int launch_plan(Kernel kern, int& smem_set, const Args& A, const Plan& P,
                int threads, int smem, cudaStream_t s) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const int M = cells(A.g);
  dim3 grid((M + P.bm - 1) / P.bm, (A.g.co + P.bn - 1) / P.bn, P.splits);
  kern<<<grid, threads, smem, s>>>(A, P);
  if (P.splits > 1) {
    const long long total = (long long)M * A.g.co;
    const long long blocks = (total / 4 + 255) / 256;
    splitk_reduce<TO><<<(unsigned)blocks, 256, 0, s>>>(
        A.ws, A.bias, static_cast<TO*>(A.out), total, A.g.co, P.splits,
        A.relu, A.round_sum);
  }
  return fnk::launch_status();
}

// The plan from the planner's arguments; false if it is malformed.
inline bool read_plan(Plan& P, int bm, int bn, int warp_m, int splits,
                      const int* kbeg) {
  if (splits < 1 || splits > kMaxSplits || kbeg == nullptr) return false;
  P.bm = bm;
  P.bn = bn;
  P.warp_m = warp_m;
  P.splits = splits;
  for (int s = 0; s <= splits; ++s) P.kbeg[s] = kbeg[s];
  return true;
}

}  // namespace conv
}  // namespace fnk
