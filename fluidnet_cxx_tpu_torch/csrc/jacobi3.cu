// Kernel I: fixed-count 3-D Jacobi pressure sweeps (6 neighbours) with the
// obstacle-Neumann substitution folded into cnt * p_c, pressure pinned to
// 0 on the border shell and in obstacles, optional warm start p0 and
// weighted-Jacobi damping.
//
// Replaces fluidnet_cxx_tpu/ops/pallas/jacobi3_pallas.py::
// solve_jacobi3_pallas (body _jacobi3_kernel), whose TPU version keeps the
// whole volume in VMEM and loops every sweep inside one kernel. Its plain
// version is ops/ops3d.py::solve_jacobi_fixed3, in the same float32 order:
// acc = div + cnt * p_c, then + x-1, + x+1, + y-1, + y+1, + z-1, + z+1,
// times float32(1/6).
//
// What bounds it on an H100: operations. The function reads flags and the
// RHS once and writes p once (12 bytes a cell: 25 MB, ~7.5 us at 3.35 TB/s
// for 128^3), but does 14 operations per cell per sweep: 60 sweeps at
// 128^3 are ~1.76 GFLOP, ~26 us at the 67 TFLOP/s fp32 rate. No block
// waits on another, and one launch per sweep costs a pass over p, p', the
// RHS and the mask (~27 MB, in the 50 MB L2) plus a launch gap each. So a
// launch runs up to kMaxSweeps3 sweeps by 2.5-D temporal blocking: a block
// of kTX x kTY threads owns one (x, y) column each of an output tile plus
// a kMaxSweeps3-cell halo, and marches along z over its segment of
// kSegZ output planes plus k planes at each end. At the step that loads
// plane t, sweep s computes plane t - s from sweep s-1's planes t-s-1,
// t-s (held in registers) and t-s+1 (computed a moment before in the same
// step), with its x and y neighbours read from a shared-memory copy of
// sweep s-1's plane t-s written at the previous step (two copies, one
// barrier a step). The exact region shrinks by one cell a sweep in x and
// y and by one plane at each segment end; only exact cells of the output
// tile are written. Each cell's p, RHS and mask are read once a launch
// (two planes ahead of their use) and the RHS and mask kept in registers
// for the k sweeps that use them; a warp skips the sweeps whose exact
// band its row has left. One launch first builds a byte per cell (bit
// 0: the sweep updates the cell; bits 1-3: cnt, the number of obstacle
// neighbours) and zeroes a warm start on obstacles (the cnt * p_c identity
// needs p == 0 there). All 1 + ceil(iters / kMaxSweeps3) launches are
// issued by one C call (fn_jacobi3_solve). No index is divided at run
// time inside the march. Kernel J keeps the one-sweep launches of
// jacobi3.cuh.
#include "jacobi3.cuh"

namespace {

// The tile, the sweeps a launch and the z segment: the fastest settings
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

}  // namespace

// Sweeps one launch of fn_jacobi3_solve runs. Launches nothing.
extern "C" int fn_jacobi3_max_sweeps() { return kMaxSweeps3; }

// iters (>= 1) sweeps; the result lands in p_out. p0 may be null (a cold
// start from p = 0); `mask` holds b*d*h*w bytes and `tmp` b*d*h*w floats
// of scratch. Issues 1 + ceil(iters / kMaxSweeps3) launches on `stream`,
// ping-ponging tmp and p_out; returns the first launch error, or
// cudaErrorInvalidValue for bad arguments.
extern "C" int fn_jacobi3_solve(const int* flags, const float* div,
                                const float* p0, uint8_t* mask, float* tmp,
                                float* p_out, int b, int d, int h, int w,
                                int iters, int damped, float keep,
                                float damping, void* stream) {
  if (iters < 1 || bad_args3(b, d, h, w, iters, tmp, p_out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  Dims D{d, h, w};
  const int launches = (iters + kMaxSweeps3 - 1) / kMaxSweeps3;
  float* init = warm_buffer3(launches, tmp, p_out);
  jacobi3_mask<<<grid3(b, D), kBlock3, 0, s>>>(flags, p0, mask, init, D);
  int status = fnk::launch_status();
  if (status) return status;
  const float* src = p0 ? init : nullptr;
  float* dst = (launches % 2) ? p_out : tmp;
  for (int done = 0; done < iters;) {
    const int k = min(kMaxSweeps3, iters - done);
    status = launch_sweeps3<kMaxSweeps3>(k, src, div, mask, dst, b, D,
                                         damped, keep, damping, s);
    if (status) return status;
    done += k;
    src = dst;
    dst = (dst == p_out) ? tmp : p_out;
  }
  return 0;
}
