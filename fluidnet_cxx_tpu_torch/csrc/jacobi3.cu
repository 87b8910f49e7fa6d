// Kernels I and J: the 3-D Jacobi pressure sweeps (6 neighbours) with the
// obstacle-Neumann substitution folded into cnt * p_c, pressure pinned to
// 0 on the border shell and in obstacles, optional warm start p0 and
// weighted-Jacobi damping; J wraps the same sweeps in the learned 3-D
// projection's tail.
//
//   I  replaces fluidnet_cxx_tpu/ops/pallas/jacobi3_pallas.py::
//      solve_jacobi3_pallas (body _jacobi3_kernel); plain version
//      ops/ops3d.py::solve_jacobi_fixed3.
//   J  replaces fluidnet_cxx_tpu/ops/pallas/proj_tail3_pallas.py::
//      project_tail3_pallas (body _tail3_kernel): the divergence RHS, warm
//      damped sweeps, the pressure-gradient velocity update (border faces
//      untouched) and the free-slip wall BCs; plain version
//      ops/kernels/proj_tail3.py::project_tail3_plain, the unfused chain
//      of ops/ops3d.py.
//
// fn_jacobi3_adjoint, I's backward for the learned projection's polish in
// training, replaces no TPU kernel: JAX differentiates the "xla" polish
// (ops/ops3d.py::solve_jacobi_fixed3's fori_loop) with XLA. It runs the
// transposed damped sweeps of the upstream gradient on I's z-march (plain
// version ops/ops3d.py::jacobi_adjoint_fixed3, in its float32 order, so
// bit for bit), bound like I by its operations.
//
// Both TPU kernels keep the whole volume in VMEM and loop every sweep
// inside one kernel (J falls back to the unfused chain above its VMEM
// budget; this port runs at every size). Each sweep here is the plain
// version's float32 order (-fmad=false): acc = div + cnt * p_c, then
// + x-1, + x+1, + y-1, + y+1, + z-1, + z+1, times float32(1/6), then the
// weighted-Jacobi blend; I and J run the same march, so one sweep body
// carries that order, and both agree with their plain versions bit for
// bit.
//
// What bounds them on an H100. I: operations. It reads flags and the RHS
// once and writes p once (12 bytes a cell: 25 MB, ~7.5 us at 3.35 TB/s for
// 128^3), but does 14 operations per cell per sweep: 60 sweeps at 128^3
// are ~1.76 GFLOP, ~26 us at the 67 TFLOP/s fp32 rate. J: bytes. It reads
// flags, U and p0 once and writes p and U' once (36 bytes a cell: 75 MB,
// ~22 us at 128^3); its 16 sweeps are ~0.47 GFLOP, ~7 us.
//
// Design. No block waits on another, and one launch per sweep costs a
// pass over p, p', the RHS and the mask (~27 MB, in the 50 MB L2) plus a
// launch gap each. So a launch runs up to kMaxSweeps3 sweeps by 2.5-D
// temporal blocking: a block of kTX x kTY threads owns one (x, y) column
// each of an output tile plus a kMaxSweeps3-cell halo, and marches along
// z over its segment of kSegZ output planes plus k planes at each end. At
// the step that loads plane t, sweep s computes plane t - s from sweep
// s-1's planes t-s-1, t-s (held in registers) and t-s+1 (computed a
// moment before in the same step), with its x and y neighbours read from
// a shared-memory copy of sweep s-1's plane t-s written at the previous
// step (two copies, one barrier a step). The exact region shrinks by one
// cell a sweep in x and y and by one plane at each segment end; only
// exact cells of the output tile are written. Each cell's p, RHS and mask
// are read once a launch (two planes ahead of their use) and the RHS and
// mask kept in registers for the k sweeps that use them; a warp skips the
// sweeps whose exact band its row has left. No index is divided at run
// time inside the march.
//
// Around the marches: I's first launch builds a byte per cell (bit 0: the
// sweep updates the cell; bits 1-3: cnt, the number of obstacle
// neighbours) and zeroes a warm start on obstacles (the cnt * p_c
// identity needs p == 0 there); J's prologue does the same and adds the
// divergence RHS of U, and J's epilogue applies the velocity update and
// the walls from the final p. One C call issues all of a solve's launches:
// I 1 + ceil(iters / kMaxSweeps3) (fn_jacobi3_solve), J 2 + ceil(iters /
// kMaxSweeps3) (fn_tail3).
#include <stdint.h>

#include "common.cuh"

namespace {
using namespace fnk;

// The mask, prologue and epilogue launches: threads x fastest, one z-slice
// of one sample per blockIdx.z; cell indices are size_t.
const dim3 kBlock3(32, 8);

struct Dims {
  int d, h, w;
};

inline dim3 grid3(int b, const Dims& D) {
  return dim3((D.w + kBlock3.x - 1) / kBlock3.x,
              (D.h + kBlock3.y - 1) / kBlock3.y, b * D.d);
}

// Cell (x, y, z, b) of this thread, or false past the grid's edge.
__device__ __forceinline__ bool cell_of(const Dims& D, int* x, int* y,
                                        int* z, size_t* base) {
  *x = blockIdx.x * blockDim.x + threadIdx.x;
  *y = blockIdx.y * blockDim.y + threadIdx.y;
  *z = blockIdx.z % D.d;
  size_t b = blockIdx.z / D.d;
  *base = b * (size_t)D.d * D.h * D.w;
  return *x < D.w && *y < D.h;
}

__device__ __forceinline__ bool interior3(int x, int y, int z,
                                          const Dims& D) {
  return x >= 1 && x <= D.w - 2 && y >= 1 && y <= D.h - 2 && z >= 1 &&
         z <= D.d - 2;
}

// Mask byte of cell i = (x, y, z): bit 0 the sweep updates it (interior,
// not obstacle); bits 1-3 cnt, the number of obstacle neighbours.
__device__ __forceinline__ uint8_t mask_byte3(const int* __restrict__ flags,
                                              int x, int y, int z, size_t i,
                                              const Dims& D) {
  if (!interior3(x, y, z, D) || flags[i] == kObstacle) return 0;
  const size_t hw = (size_t)D.h * D.w;
  int cnt = (flags[i - 1] == kObstacle) + (flags[i + 1] == kObstacle) +
            (flags[i - D.w] == kObstacle) + (flags[i + D.w] == kObstacle) +
            (flags[i - hw] == kObstacle) + (flags[i + hw] == kObstacle);
  return (uint8_t)(1 | (cnt << 1));
}

// The march's tile, the sweeps a launch and the z segment: the fastest settings
// measured at 128^3 (PERF.md).
constexpr int kTX = 32;                       // tile columns: one warp a row
constexpr int kTY = 16;                       // tile rows, one thread each
constexpr int kMaxSweeps3 = 3;                // sweeps a launch, the halo
constexpr int kSegZ = 32;                     // output planes a block
constexpr int kPre3 = 2;                      // planes loaded ahead
constexpr int kOutX = kTX - 2 * kMaxSweeps3;
constexpr int kOutY = kTY - 2 * kMaxSweeps3;
// One plane of the tile with a row and a cell of padding at each end, so
// that the tile's edge cells read in bounds (values that are never exact).
constexpr int kPad3 = kTX + 1;
constexpr int kPlane3 = kTX * kTY + 2 * kPad3;
static_assert(kOutX > 0 && kOutY > 0, "the halo leaves no output tile");

__global__ void jacobi3_mask(const int* __restrict__ flags,
                             const float* __restrict__ p0,
                             uint8_t* __restrict__ mask,
                             float* __restrict__ p_init, Dims D) {
  int x, y, z;
  size_t base;
  if (!cell_of(D, &x, &y, &z, &base)) return;
  const size_t i = base + z * (size_t)D.h * D.w + (size_t)y * D.w + x;
  if (p0) p_init[i] = flags[i] == kObstacle ? 0.f : p0[i];
  mask[i] = mask_byte3(flags, x, y, z, i, D);
}

// One column's p, RHS and mask byte at a plane (zeros off the grid).
struct Cell {
  float p, rhs;
  uint8_t m;
};

// K (1..kMaxSweeps3) sweeps from p_in (null: zeros) into p_out (a
// distinct buffer). Grid: x and y tiles, b * segs z segments; thread
// (tx, ty) owns column (tx, ty) of the tile.
template <int K, bool kDamped>
__global__ void __launch_bounds__(kTX * kTY)
    jacobi3_march(const float* __restrict__ p_in,
                  const float* __restrict__ div,
                  const uint8_t* __restrict__ mask,
                  float* __restrict__ p_out, Dims D, int segs, float keep,
                  float damping) {
  constexpr int M = kMaxSweeps3;
  __shared__ float sh[2][K][kPlane3];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int li = kPad3 + ty * kTX + tx;
  const int x = blockIdx.x * kOutX - M + tx;
  const int y = blockIdx.y * kOutY - M + ty;
  const int seg = blockIdx.z % segs;
  const size_t b = blockIdx.z / segs;
  const int z0 = seg * kSegZ, z1 = min(z0 + kSegZ, D.d);
  const size_t hw = (size_t)D.h * D.w;
  const bool in_xy = x >= 0 && x < D.w && y >= 0 && y < D.h;
  const bool writes = in_xy && tx >= M && tx < kTX - M && ty >= M &&
                      ty < kTY - M;
  const size_t col = b * D.d * hw + (in_xy ? (size_t)y * D.w + x : 0);
  const float* pc_in = p_in ? p_in + col : nullptr;
  const float* rhs_in = div + col;
  const uint8_t* m_in = mask + col;
  float* out = p_out + col;
  const float sixth = (float)(1.0 / 6.0);
  // Sweep s computes row ty only within the halo's shrinking band (the
  // warp's row: a uniform branch).
  bool band[K + 1];
#pragma unroll
  for (int s = 1; s <= K; ++s)
    band[s] = ty >= M - K + s && ty < kTY - M + K - s;

  auto load = [&](int z) {
    Cell c{0.f, 0.f, 0};
    if (in_xy && (unsigned)z < (unsigned)D.d) {
      const size_t o = (size_t)z * hw;
      c.p = pc_in ? pc_in[o] : 0.f;
      c.rhs = rhs_in[o];
      c.m = m_in[o];
    }
    return c;
  };

  // Sweep j's (0: the input) planes t-j-2 (zm) and t-j-1 (zc) at the
  // start of the step that loads plane t; the RHS and cm of plane t-j-1,
  // cm being cnt as a float where the sweep updates the cell and -1 where
  // it pins it to 0. Planes a sweep computes before its inputs are exact
  // (the first 2s steps) are never read by an exact cell.
  float zm[K], zc[K], rr[K], cm[K];
#pragma unroll
  for (int j = 0; j < K; ++j) zm[j] = zc[j] = rr[j] = 0.f, cm[j] = -1.f;

  const int t0 = z0 - K, t_end = z1 + K;
  // Plane t + kPre3's loads are issued kPre3 steps before their first use.
  Cell q[kPre3];
#pragma unroll
  for (int i = 0; i < kPre3; ++i) q[i] = load(t0 + i);
  int buf = 0;
  // Two steps unrolled: the register rings then rotate by renaming
  // instead of moves.
#pragma unroll 2
  for (int t = t0; t < t_end; ++t) {
    const Cell c = q[0];
#pragma unroll
    for (int i = 0; i + 1 < kPre3; ++i) q[i] = q[i + 1];
    q[kPre3 - 1] = load(t + kPre3);
    float nv[K + 1];
    nv[0] = c.p;
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const int j = s - 1;
      float v = 0.f;
      if (band[s]) {
        const float* P = sh[buf][j];
        const float pc = zc[j];
        float acc = rr[j] + cm[j] * pc;
        acc = acc + P[li - 1];
        acc = acc + P[li + 1];
        acc = acc + P[li - kTX];
        acc = acc + P[li + kTX];
        acc = acc + zm[j];
        acc = acc + nv[j];
        const float upd = acc * sixth;
        v = kDamped ? keep * pc + damping * upd : upd;
        v = cm[j] >= 0.f ? v : 0.f;
      }
      nv[s] = v;
    }
    const int zk = t - K;
    if (writes && zk >= z0 && zk < z1) out[(size_t)zk * hw] = nv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      sh[buf ^ 1][j][li] = nv[j];
      zm[j] = zc[j];
      zc[j] = nv[j];
    }
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      rr[j] = rr[j - 1];
      cm[j] = cm[j - 1];
    }
    rr[0] = c.rhs;
    cm[0] = (c.m & 1) ? (float)(c.m >> 1) : -1.f;
    buf ^= 1;
    __syncthreads();
  }
}

// The adjoint's mask byte: mask_byte3's, and bit 4 where the cell is in
// the grid and not an obstacle (the transposed sweep writes 0 elsewhere).
constexpr uint8_t kOpen3 = 16;

__global__ void adjoint3_mask(const int* __restrict__ flags,
                              uint8_t* __restrict__ mask, Dims D) {
  int x, y, z;
  size_t base;
  if (!cell_of(D, &x, &y, &z, &base)) return;
  const size_t i = base + z * (size_t)D.h * D.w + (size_t)y * D.w + x;
  mask[i] = (uint8_t)(mask_byte3(flags, x, y, z, i, D) |
                      (flags[i] == kObstacle ? 0 : kOpen3));
}

// K (1..kMaxSweeps3) transposed sweeps of g_in into g_out (a distinct
// buffer), on jacobi3_march's tile, halo and z-march. With a = g where the
// sweep updates the cell (else 0) and c = (damping * a) * (1/6), a sweep
// gives keep * a + cnt * c + c[x-1] + c[x+1] + c[y-1] + c[y+1] + c[z-1] +
// c[z+1] on cells that are not obstacles (0 there), the plain version's
// order. The rings hold each sweep's c (shared memory and zm/zc), its a
// at the centre plane (za) and the mask byte of the plane it updates.
template <int K, bool kDamped>
__global__ void __launch_bounds__(kTX * kTY)
    jacobi3_adjoint_march(const float* __restrict__ g_in,
                          const uint8_t* __restrict__ mask,
                          float* __restrict__ g_out, Dims D, int segs,
                          float keep, float damping) {
  constexpr int M = kMaxSweeps3;
  __shared__ float sh[2][K][kPlane3];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int li = kPad3 + ty * kTX + tx;
  const int x = blockIdx.x * kOutX - M + tx;
  const int y = blockIdx.y * kOutY - M + ty;
  const int seg = blockIdx.z % segs;
  const size_t b = blockIdx.z / segs;
  const int z0 = seg * kSegZ, z1 = min(z0 + kSegZ, D.d);
  const size_t hw = (size_t)D.h * D.w;
  const bool in_xy = x >= 0 && x < D.w && y >= 0 && y < D.h;
  const bool writes = in_xy && tx >= M && tx < kTX - M && ty >= M &&
                      ty < kTY - M;
  const size_t col = b * D.d * hw + (in_xy ? (size_t)y * D.w + x : 0);
  const float* g_col = g_in + col;
  const uint8_t* m_in = mask + col;
  float* out = g_out + col;
  const float sixth = (float)(1.0 / 6.0);
  bool band[K + 1];
#pragma unroll
  for (int s = 1; s <= K; ++s)
    band[s] = ty >= M - K + s && ty < kTY - M + K - s;

  auto load = [&](int z) {
    Cell c{0.f, 0.f, 0};
    if (in_xy && (unsigned)z < (unsigned)D.d) {
      const size_t o = (size_t)z * hw;
      c.p = g_col[o];
      c.m = m_in[o];
    }
    return c;
  };

  // Sweep j's (0: the input) c at planes t-j-2 (zm) and t-j-1 (zc), its a
  // at plane t-j-1 (za), and plane t-j-1's mask byte (mk), at the start of
  // the step that loads plane t.
  float zm[K], zc[K], za[K];
  uint8_t mk[K];
#pragma unroll
  for (int j = 0; j < K; ++j) zm[j] = zc[j] = za[j] = 0.f, mk[j] = 0;

  const int t0 = z0 - K, t_end = z1 + K;
  Cell q[kPre3];
#pragma unroll
  for (int i = 0; i < kPre3; ++i) q[i] = load(t0 + i);
  int buf = 0;
#pragma unroll 2
  for (int t = t0; t < t_end; ++t) {
    const Cell c = q[0];
#pragma unroll
    for (int i = 0; i + 1 < kPre3; ++i) q[i] = q[i + 1];
    q[kPre3 - 1] = load(t + kPre3);
    float nv[K + 1], na[K + 1], nc[K + 1];
    nv[0] = c.p;
    na[0] = (c.m & 1) ? c.p : 0.f;
    nc[0] = (damping * na[0]) * sixth;
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const int j = s - 1;
      const uint8_t m = mk[j];
      float v = 0.f;
      if (band[s]) {
        const float* P = sh[buf][j];
        float acc = (float)((m >> 1) & 7) * zc[j];
        if (kDamped) acc = keep * za[j] + acc;
        acc = acc + P[li - 1];
        acc = acc + P[li + 1];
        acc = acc + P[li - kTX];
        acc = acc + P[li + kTX];
        acc = acc + zm[j];
        acc = acc + nc[j];
        v = (m & kOpen3) ? acc : 0.f;
      }
      nv[s] = v;
      na[s] = (m & 1) ? v : 0.f;
      nc[s] = (damping * na[s]) * sixth;
    }
    const int zk = t - K;
    if (writes && zk >= z0 && zk < z1) out[(size_t)zk * hw] = nv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      sh[buf ^ 1][j][li] = nc[j];
      zm[j] = zc[j];
      zc[j] = nc[j];
      za[j] = na[j];
    }
#pragma unroll
    for (int j = K - 1; j > 0; --j) mk[j] = mk[j - 1];
    mk[0] = c.m;
    buf ^= 1;
    __syncthreads();
  }
}

template <int K>
int launch_adjoint_march(const float* src, const uint8_t* mask, float* dst,
                         int b, const Dims& D, int damped, float keep,
                         float damping, cudaStream_t s) {
  const int segs = (D.d + kSegZ - 1) / kSegZ;
  dim3 grid((D.w + kOutX - 1) / kOutX, (D.h + kOutY - 1) / kOutY, b * segs);
  dim3 block(kTX, kTY);
  if (damped)
    jacobi3_adjoint_march<K, true><<<grid, block, 0, s>>>(
        src, mask, dst, D, segs, keep, damping);
  else
    jacobi3_adjoint_march<K, false><<<grid, block, 0, s>>>(
        src, mask, dst, D, segs, keep, damping);
  return fnk::launch_status();
}

// Launches the adjoint march instance of k sweeps (k <= K).
template <int K>
int launch_adjoint3(int k, const float* src, const uint8_t* mask,
                    float* dst, int b, const Dims& D, int damped, float keep,
                    float damping, cudaStream_t s) {
  if constexpr (K > 0) {
    if (k == K)
      return launch_adjoint_march<K>(src, mask, dst, b, D, damped, keep,
                                     damping, s);
    return launch_adjoint3<K - 1>(k, src, mask, dst, b, D, damped, keep,
                                  damping, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int K>
int launch_march(const float* src, const float* div, const uint8_t* mask,
                 float* dst, int b, const Dims& D, int damped, float keep,
                 float damping, cudaStream_t s) {
  const int segs = (D.d + kSegZ - 1) / kSegZ;
  dim3 grid((D.w + kOutX - 1) / kOutX, (D.h + kOutY - 1) / kOutY, b * segs);
  dim3 block(kTX, kTY);
  if (damped)
    jacobi3_march<K, true><<<grid, block, 0, s>>>(src, div, mask, dst, D,
                                                  segs, keep, damping);
  else
    jacobi3_march<K, false><<<grid, block, 0, s>>>(src, div, mask, dst, D,
                                                   segs, keep, damping);
  return fnk::launch_status();
}

// Launches the march instance of k sweeps (k <= K).
template <int K>
int launch_sweeps3(int k, const float* src, const float* div,
                   const uint8_t* mask, float* dst, int b, const Dims& D,
                   int damped, float keep, float damping, cudaStream_t s) {
  if constexpr (K > 0) {
    if (k == K)
      return launch_march<K>(src, div, mask, dst, b, D, damped, keep,
                             damping, s);
    return launch_sweeps3<K - 1>(k, src, div, mask, dst, b, D, damped, keep,
                                 damping, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}


// The buffer a warm start goes into so that the last of `launches`
// ping-ponging launches lands in p_out: an odd count starts writing p_out,
// an even one tmp.
inline float* warm_buffer3(int launches, float* tmp, float* p_out) {
  return (launches % 2) ? tmp : p_out;
}

inline int march_launches(int iters) {
  return (iters + kMaxSweeps3 - 1) / kMaxSweeps3;
}

// `iters` sweeps in march_launches(iters) launches from src (null: zeros;
// else warm_buffer3's buffer), ping-ponging tmp and p_out; the result
// lands in p_out.
inline int jacobi3_marches(const float* src, const float* div,
                           const uint8_t* mask, float* tmp, float* p_out,
                           int b, const Dims& D, int iters, int damped,
                           float keep, float damping, cudaStream_t s) {
  float* dst = (march_launches(iters) % 2) ? p_out : tmp;
  for (int done = 0; done < iters;) {
    const int k = min(kMaxSweeps3, iters - done);
    const int status = launch_sweeps3<kMaxSweeps3>(
        k, src, div, mask, dst, b, D, damped, keep, damping, s);
    if (status) return status;
    done += k;
    src = dst;
    dst = (dst == p_out) ? tmp : p_out;
  }
  return 0;
}

// Arguments every 3-D solve entry checks: sizes, a distinct scratch
// buffer, and b*d slices within the grid's z limit.
inline bool bad_args3(int b, int d, int h, int w, int iters, const float* tmp,
                      const float* p_out) {
  return iters < 0 || b < 1 || d < 3 || h < 3 || w < 3 || tmp == p_out ||
         (size_t)b * d > 65535;
}

// J's prologue: the RHS of U, the mask byte and the warm start zeroed on
// obstacles.
__global__ void tail3_prologue(const int* __restrict__ flags,
                               const float* __restrict__ U,
                               const float* __restrict__ p0,
                               float* __restrict__ rhs,
                               uint8_t* __restrict__ mask,
                               float* __restrict__ p_init, Dims D) {
  int x, y, z;
  size_t base;
  if (!cell_of(D, &x, &y, &z, &base)) return;
  const size_t hw = (size_t)D.h * D.w, n = D.d * hw;
  const size_t cell = z * hw + (size_t)y * D.w + x;
  const size_t i = base + cell;
  const bool ob = flags[i] == kObstacle;
  p_init[i] = ob ? 0.f : p0[i];
  mask[i] = mask_byte3(flags, x, y, z, i, D);
  float r = 0.f;
  if (interior3(x, y, z, D) && !ob) {
    // ops3d.velocity_divergence3: (u - u[x+1]) + (v - v[y+1]) + (w - w[z+1])
    const float* u = U + 3 * base + cell;
    const float* v = u + n;
    const float* wz = v + n;
    r = ((u[0] - u[1]) + (v[0] - v[D.w])) + (wz[0] - wz[hw]);
  }
  rhs[i] = r;
}

// J's epilogue: the velocity update from the final p and the walls.
__global__ void tail3_epilogue(const int* __restrict__ flags,
                               const float* __restrict__ U,
                               const float* __restrict__ p,
                               float* __restrict__ U_out, Dims D) {
  int x, y, z;
  size_t base;
  if (!cell_of(D, &x, &y, &z, &base)) return;
  const size_t hw = (size_t)D.h * D.w, n = D.d * hw;
  const size_t cell = z * hw + (size_t)y * D.w + x;
  const size_t i = base + cell;
  const int f = flags[i];
  const bool fl = f == kFluid, em = f == kEmpty, ob = f == kObstacle;
  const bool in = interior3(x, y, z, D);
  const size_t stride[3] = {1, (size_t)D.w, hw};
  const int idx[3] = {x, y, z};
  const float pc = p[i];
  for (int c = 0; c < 3; ++c) {
    const size_t ui = 3 * base + c * n + cell;
    const float vel = U[ui];
    // ops3d.velocity_update3; border faces keep their velocity.
    float val = vel;
    if (in) {
      const size_t j = i - stride[c];
      const int fm = flags[j];
      const float pm = p[j];
      val = (fl && fm == kFluid)   ? vel - (pc - pm)
            : (fl && fm == kEmpty) ? vel - pc
            : (em && fm == kFluid) ? vel + pm
                                   : 0.f;
    }
    // ops3d.set_wall_bcs3, the lower neighbour's index clamped at 0.
    const int fb = idx[c] > 0 ? flags[i - stride[c]] : f;
    const bool kill =
        (fl || ob) && (fb == kObstacle || (ob && fb == kFluid));
    U_out[ui] = kill ? 0.f : val;
  }
}

}  // namespace

// Sweeps one march launch runs. Launches nothing.
extern "C" int fn_jacobi3_max_sweeps() { return kMaxSweeps3; }

// Kernel I: iters (>= 1) sweeps; the result lands in p_out. p0 may be null
// (a cold start from p = 0); `mask` holds b*d*h*w bytes and `tmp`
// b*d*h*w floats of scratch. Issues 1 + ceil(iters / kMaxSweeps3)
// launches on `stream`, ping-ponging tmp and p_out; returns the first
// launch error, or cudaErrorInvalidValue for bad arguments.
extern "C" int fn_jacobi3_solve(const int* flags, const float* div,
                                const float* p0, uint8_t* mask, float* tmp,
                                float* p_out, int b, int d, int h, int w,
                                int iters, int damped, float keep,
                                float damping, void* stream) {
  if (iters < 1 || bad_args3(b, d, h, w, iters, tmp, p_out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  Dims D{d, h, w};
  float* init = warm_buffer3(march_launches(iters), tmp, p_out);
  jacobi3_mask<<<grid3(b, D), kBlock3, 0, s>>>(flags, p0, mask, init, D);
  const int status = fnk::launch_status();
  if (status) return status;
  return jacobi3_marches(p0 ? init : nullptr, div, mask, tmp, p_out, b, D,
                         iters, damped, keep, damping, s);
}

// Kernel J, the tail of one projection: RHS of U, `iters` (>= 0) warm
// sweeps from p0 (zeroed on obstacles) with the weighted-Jacobi blend, U'
// from the final p. `rhs` and `tmp` are b*d*h*w floats and `mask`
// b*d*h*w bytes of scratch; p lands in p_out, U' in U_out. Issues 2 +
// ceil(iters / kMaxSweeps3) launches on `stream`; returns the first
// launch error, or cudaErrorInvalidValue for bad arguments.
extern "C" int fn_tail3(const int* flags, const float* U, const float* p0,
                        float* rhs, uint8_t* mask, float* tmp, float* p_out,
                        float* U_out, int b, int d, int h, int w, int iters,
                        int damped, float keep, float damping,
                        void* stream) {
  if (bad_args3(b, d, h, w, iters, tmp, p_out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  Dims D{d, h, w};
  float* init = warm_buffer3(march_launches(iters), tmp, p_out);
  tail3_prologue<<<grid3(b, D), kBlock3, 0, s>>>(flags, U, p0, rhs, mask,
                                                 init, D);
  int status = fnk::launch_status();
  if (status) return status;
  status = jacobi3_marches(init, rhs, mask, tmp, p_out, b, D, iters, damped,
                           keep, damping, s);
  if (status) return status;
  tail3_epilogue<<<grid3(b, D), kBlock3, 0, s>>>(flags, U, p_out, U_out, D);
  return fnk::launch_status();
}

// I's adjoint: iters (>= 1) transposed damped sweeps of g (the gradient of
// I's output) into g_out, the gradient of its warm start p0. `mask` holds
// b*d*h*w bytes and `tmp` b*d*h*w floats of scratch. Issues 1 +
// ceil(iters / kMaxSweeps3) launches on `stream` (a mask launch, then the
// marches ping-ponging tmp and g_out from g); returns the first launch
// error, or cudaErrorInvalidValue for bad arguments.
extern "C" int fn_jacobi3_adjoint(const int* flags, const float* g,
                                  uint8_t* mask, float* tmp, float* g_out,
                                  int b, int d, int h, int w, int iters,
                                  int damped, float keep, float damping,
                                  void* stream) {
  if (iters < 1 || bad_args3(b, d, h, w, iters, tmp, g_out) || g == tmp ||
      g == g_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  Dims D{d, h, w};
  adjoint3_mask<<<grid3(b, D), kBlock3, 0, s>>>(flags, mask, D);
  int status = fnk::launch_status();
  if (status) return status;
  const float* src = g;
  float* dst = (march_launches(iters) % 2) ? g_out : tmp;
  for (int done = 0; done < iters;) {
    const int k = min(kMaxSweeps3, iters - done);
    status = launch_adjoint3<kMaxSweeps3>(k, src, mask, dst, b, D, damped,
                                          keep, damping, s);
    if (status) return status;
    done += k;
    src = dst;
    dst = (dst == g_out) ? tmp : g_out;
  }
  return 0;
}
