// Kernels F and C: fixed-count Jacobi pressure sweeps with obstacle-Neumann
// substitution, pressure pinned to 0 on the border ring and in obstacles,
// optional warm start p0 and weighted-Jacobi damping; C wraps the same
// sweeps in the learned projection's tail.
//
//   F  replaces fluidnet_cxx_tpu/ops/pallas/jacobi_pallas.py::
//      solve_jacobi_pallas (body _jacobi_kernel); plain version
//      ops/jacobi.py::solve_jacobi_fixed.
//   C  replaces fluidnet_cxx_tpu/ops/pallas/proj_tail_pallas.py::
//      project_tail_pallas (body _tail_kernel): inlet BC on U, the
//      divergence RHS, warm start p0 * scale, damped Jacobi polish sweeps,
//      the pressure-gradient velocity update, free-slip wall BCs, inlet BC
//      again; plain version ops/kernels/proj_tail.py::project_tail_plain.
//
// Both TPU kernels keep one sample's grid in VMEM and loop every sweep
// inside one kernel.
//
// fn_jacobi_adjoint, beside F, runs F's sweeps transposed: the gradient of
// F's output with respect to its warm start p0, which training needs for
// the learned projection's damped polish (ops/kernels/jacobi.py::
// JacobiPolish). It replaces no TPU kernel: JAX differentiates the "xla"
// polish (ops/jacobi.py's fori_loop) through XLA. The sweep is affine in
// p, so its transpose is linear in the upstream gradient g: with a = cont
// g and c = (w a) / 4, g'[j] = keep a[j] + n_obst(j) c[j] + (1 -
// obstacle[j]) sum_d c[j - d]; the border ring, pinned in the forward,
// receives gradient from its interior neighbours. Same tiles, halo and
// one barrier a sweep as F; a thread keeps its strip's g in registers and
// the tile's c lives in shared memory (two copies, written alternately).
// Bound like F: ~14 operations a cell a sweep, 9 bytes a cell read and 4
// written once.
//
// What bounds them on an H100. F: operations. It reads flags and the RHS
// once and writes p once (12 bytes a cell, ~3 MB at 512^2, ~0.9 us at
// 3.35 TB/s), but does ~10 operations per continuation cell per sweep:
// 200 sweeps at 512^2 are ~0.5 GFLOP, ~8 us at the 67 TFLOP/s fp32 rate.
// C: bytes. It reads flags, u, v, p0 and the inlet fields once and writes
// p, u', v' (44 bytes a cell, ~11 MB at 512^2, ~3.4 us); its 32 sweeps
// are ~0.08 GFLOP.
//
// Design. Looping all sweeps in one kernel would need every block to wait
// for the others between sweeps, which this port never does; one launch
// per sweep is launch-bound. So each launch runs up to kMaxSweeps sweeps
// by temporal blocking: a block loads its output tile plus a halo of p,
// RHS and mask, runs k sweeps on it (the exact region shrinks by one cell
// a sweep; what lies outside it is never read by a cell that is written
// back), and writes back the output tile. No block reads another's output
// within a launch; 200 sweeps are 25 launches plus one mask launch.
//
// Thread (tx, ty) owns column tx of the tile and a strip of kRows rows:
// its cells' p, RHS and mask stay in registers for the whole launch, so a
// sweep reads only the x-neighbours and the strip's two end rows from
// shared memory, which holds the previous sweep's p twice (written to the
// other copy, one barrier a sweep). No index is divided at run time. F's
// tile is 64 x 64 cells with a kMaxSweeps halo (48^2 output, 1.78x the
// output loaded) and 8-row strips: the 96 x 96 tile (80^2 output, 1.44x)
// was no faster at 8000x800, whose p, p', RHS and mask (~83 MB) exceed
// the 50 MB L2, and slower at 512^2, where it gives 49 blocks for 132 SMs
// (PERF.md). The per-cell arithmetic is jacobi_update, shared with the
// multigrid smoother, in the plain version's float32 order.
//
// C runs its sweeps through the same tile kernel (the plain version's
// float32 order again, so bit-exact), on 4-row strips (kTailRows: 32
// warps a block; F keeps its 8-row strips). One C call (fn_tail) issues
//   the prologue: inlet BC, RHS, p0 * scale, the mask byte (one thread a
//     cell);
//   ceil(iters / kMaxSweeps) tile launches, ping-ponging two buffers so
//     that the last sweep lands in p_out;
//   the epilogue: velocity update, wall BCs, inlet BC (one thread a cell).
// At 512^2 with 32 sweeps that is 6 launches. Folding the prologue into
// the first tile launch (the RHS, mask and p0 * scale computed over its
// tile and halo) and the epilogue into the last (on a tile whose halo is
// one cell wider, since U' reads p at x - 1 and y - 1) gave 4 launches
// but measured slower on the card (PERF.md).
#include <stdint.h>

#include "common.cuh"

namespace {
using namespace fnk;

constexpr int kMaxSweeps = 8;    // sweeps fused per launch, the tile's halo
constexpr int kTile = 64;        // the tile's side
constexpr int kLX = kTile, kLY = kTile;  // tile cells
constexpr int kRY = kLY / 8;     // F's rows a thread: 8 threads a column
constexpr int kTailRows = 4;     // C's rows a thread: 16 threads a column
constexpr int kOutX = kLX - 2 * kMaxSweeps, kOutY = kLY - 2 * kMaxSweeps;
// One copy of p with a row and a cell of padding at each end, so that the
// tile's edge cells read in bounds (values that are never exact).
constexpr int kPad = kLX + 1;
constexpr int kCopy = kLX * kLY + 2 * kPad;
constexpr int kSmem = 2 * kCopy * (int)sizeof(float);
static_assert(kLX % 32 == 0 && kLY % 8 == 0, "whole warps and strips");
static_assert(kSmem <= 48 * 1024, "no opt-in above 48 KB");

// Tile launches of `sweeps` sweeps.
inline int launches_of(int sweeps) {
  return (sweeps + kMaxSweeps - 1) / kMaxSweeps;
}

// C's inlet fields (U_bc, U_bc_inv_mask), both null without an inlet.
struct Inlet {
  const float* bc;    // (b, 2, h, w) or null
  const float* inv;   // (b, 2, h, w) or null
  __device__ float apply(float val, size_t j) const {
    return bc ? val * inv[j] + bc[j] : val;
  }
};

// The adjoint's mask bit: the cell itself is an obstacle (cell_mask gives
// such a cell 0, as it does the border ring). F's sweeps never test it.
constexpr uint8_t kSelfOb = 32;

// The mask launch of kernel F and of its adjoint.
__global__ void jacobi_mask(const int* __restrict__ flags_all,
                            uint8_t* __restrict__ mask_all, int h, int w) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  if (x >= w || y >= h) return;
  size_t n = (size_t)h * w;
  const int* flags = flags_all + b * n;
  uint8_t m = cell_mask(flags, x, y, h, w);
  if (flags[y * w + x] == kObstacle) m |= kSelfOb;
  mask_all[b * n + y * w + x] = m;
}

// Kernel C's prologue: the inlet BC on U, the RHS, p0 * scale, the mask.
__global__ void tail_prologue(const int* __restrict__ flags_all,
                              const float* __restrict__ U,
                              const float* __restrict__ p0,
                              const float* __restrict__ scale, Inlet in_bc,
                              float* __restrict__ rhs_all,
                              float* __restrict__ p_all,
                              uint8_t* __restrict__ mask_all, int h, int w) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  if (x >= w || y >= h) return;
  size_t n = (size_t)h * w;
  int i = y * w + x;
  const int* flags = flags_all + b * n;
  size_t ub = (size_t)b * 2 * n, vb = ub + n;
  uint8_t m = cell_mask(flags, x, y, h, w);
  float rhs = 0.f;
  if (m & kCont) {
    float u0 = in_bc.apply(U[ub + i], ub + i);
    float u1 = in_bc.apply(U[ub + i + 1], ub + i + 1);
    float v0 = in_bc.apply(U[vb + i], vb + i);
    float v1 = in_bc.apply(U[vb + i + w], vb + i + w);
    rhs = (u0 - u1) + (v0 - v1);
  }
  rhs_all[b * n + i] = rhs;
  mask_all[b * n + i] = m;
  float p = p0[b * n + i];
  p_all[b * n + i] = scale ? p * scale[b] : p;
}

// Kernel C's epilogue: velocity update, walls and the inlet BC from p.
__global__ void tail_epilogue(const int* __restrict__ flags_all,
                              const float* __restrict__ U,
                              const float* __restrict__ p_all, Inlet in_bc,
                              float* __restrict__ U_out, int h, int w) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  if (x >= w || y >= h) return;
  size_t n = (size_t)h * w;
  int i = y * w + x;
  const int* flags = flags_all + b * n;
  const float* p = p_all + b * n;
  size_t ub = (size_t)b * 2 * n, vb = ub + n;
  float un, vn;
  update_and_walls(
      flags, [p](int j) { return p[j]; }, in_bc.apply(U[ub + i], ub + i),
      in_bc.apply(U[vb + i], vb + i), x, y, h, w, &un, &vn);
  U_out[ub + i] = in_bc.apply(un, ub + i);
  U_out[vb + i] = in_bc.apply(vn, vb + i);
}

// The tile kernel: k (1..kMaxSweeps) sweeps from p_in (null: zeros) into
// p_out, kRows rows a thread; p_in and p_out are distinct buffers.
template <bool kDamped, int kRows>
__global__ void __launch_bounds__(kLX * (kLY / kRows))
    jacobi_sweeps(const float* __restrict__ p_in_all,
                  const float* __restrict__ rhs_all,
                  const uint8_t* __restrict__ mask_all,
                  float* __restrict__ p_out_all, int h, int w, int k,
                  float keep, float damping) {
  extern __shared__ float smem[];
  float* src = smem + kPad;
  float* dst = smem + kCopy + kPad;
  const int lx = threadIdx.x, ly0 = threadIdx.y * kRows;
  const int li0 = ly0 * kLX + lx;
  const int gx = blockIdx.x * kOutX - kMaxSweeps + lx;
  const int gy0 = blockIdx.y * kOutY - kMaxSweeps + ly0;
  const size_t base = blockIdx.z * (size_t)h * w;
  const bool col_in = gx >= 0 && gx < w;

  // The strip's p, RHS and mask bytes (four to a word).
  float cur[kRows], rhs[kRows];
  uint32_t mw[(kRows + 3) / 4] = {};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gy = gy0 + r;
    const bool in = col_in && gy >= 0 && gy < h;
    const size_t gi = base + (size_t)(in ? gy : 0) * w + (in ? gx : 0);
    cur[r] = (in && p_in_all) ? p_in_all[gi] : 0.f;
    rhs[r] = in ? rhs_all[gi] : 0.f;
    mw[r / 4] |= (uint32_t)(in ? mask_all[gi] : 0) << (8 * (r % 4));
    src[li0 + r * kLX] = cur[r];
  }
  __syncthreads();

  for (int s = 1; s <= k; ++s) {
    // Row r-1's value before this sweep: shared memory above the strip.
    float above = src[li0 - kLX];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int li = li0 + r * kLX;
      const float pc = cur[r];
      const float below = r < kRows - 1 ? cur[r + 1] : src[li + kLX];
      const uint8_t m = (uint8_t)(mw[r / 4] >> (8 * (r % 4)));
      cur[r] = jacobi_update(m, pc, src[li - 1], src[li + 1], above, below,
                             rhs[r], kDamped, keep, damping);
      above = pc;
      if (s < k) dst[li] = cur[r];
    }
    if (s == k) break;
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  if (!col_in || lx < kMaxSweeps || lx >= kLX - kMaxSweeps) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = ly0 + r, gy = gy0 + r;
    if (ly >= kMaxSweeps && ly < kLY - kMaxSweeps && gy >= 0 && gy < h)
      p_out_all[base + (size_t)gy * w + gx] = cur[r];
  }
}

// The tile launches of one solve: `sweeps` sweeps from `src` (null:
// zeros), kMaxSweeps a launch, ping-ponging tmp and p_out so that the
// last lands in p_out.
template <bool kDamped, int kRows>
int sweep_launches(const float* src, const float* rhs, const uint8_t* mask,
                   float* tmp, float* p_out, int b, int h, int w, int sweeps,
                   float keep, float damping, cudaStream_t s) {
  static_assert(kLY % kRows == 0, "whole strips");
  const dim3 grid((w + kOutX - 1) / kOutX, (h + kOutY - 1) / kOutY, b);
  const dim3 block(kLX, kLY / kRows);
  float* dst = (launches_of(sweeps) % 2) ? p_out : tmp;
  for (int done = 0; done < sweeps;) {
    const int k = min(kMaxSweeps, sweeps - done);
    jacobi_sweeps<kDamped, kRows><<<grid, block, kSmem, s>>>(
        src, rhs, mask, dst, h, w, k, keep, damping);
    const int status = launch_status();
    if (status) return status;
    done += k;
    src = dst;
    dst = (dst == p_out) ? tmp : p_out;
  }
  return 0;
}

template <int kRows>
int sweeps_of(bool damped, const float* src, const float* rhs,
              const uint8_t* mask, float* tmp, float* p_out, int b, int h,
              int w, int sweeps, float keep, float damping, cudaStream_t s) {
  return damped ? sweep_launches<true, kRows>(src, rhs, mask, tmp, p_out, b,
                                              h, w, sweeps, keep, damping, s)
                : sweep_launches<false, kRows>(src, rhs, mask, tmp, p_out, b,
                                               h, w, sweeps, keep, damping,
                                               s);
}

// One transposed update of a cell with mask byte m, upstream value g and
// c = (damping * cont g) * 0.25 of itself and of its neighbours at x+1,
// x-1, y+1, y-1 (ops/jacobi.py::_adjoint_sweep_maker, same order).
__device__ __forceinline__ float adjoint_update(uint8_t m, float g, float c,
                                                float c_xp, float c_xm,
                                                float c_yp, float c_ym,
                                                float keep) {
  float t = keep * ((m & kCont) ? g : 0.f);
  t = t + ((m & kObXm) ? c : 0.f);
  t = t + ((m & kObXp) ? c : 0.f);
  t = t + ((m & kObYm) ? c : 0.f);
  t = t + ((m & kObYp) ? c : 0.f);
  const bool ob = m & kSelfOb;
  t = t + (ob ? 0.f : c_xp);
  t = t + (ob ? 0.f : c_xm);
  t = t + (ob ? 0.f : c_yp);
  t = t + (ob ? 0.f : c_ym);
  return t;
}

// The adjoint's tile kernel: k (1..kMaxSweeps) transposed sweeps from g_in
// into g_out on F's tiles (kRY rows a thread). Cells off the grid hold g 0
// and mask 0, so their c is 0, as the plain version's wrapped reads of the
// border ring are.
__global__ void __launch_bounds__(kLX * (kLY / kRY))
    jacobi_adjoint_sweeps(const float* __restrict__ g_in_all,
                          const uint8_t* __restrict__ mask_all,
                          float* __restrict__ g_out_all, int h, int w, int k,
                          float keep, float damping) {
  extern __shared__ float smem[];
  float* const bufs[2] = {smem + kPad, smem + kCopy + kPad};
  const int lx = threadIdx.x, ly0 = threadIdx.y * kRY;
  const int li0 = ly0 * kLX + lx;
  const int gx = blockIdx.x * kOutX - kMaxSweeps + lx;
  const int gy0 = blockIdx.y * kOutY - kMaxSweeps + ly0;
  const size_t base = blockIdx.z * (size_t)h * w;
  const bool col_in = gx >= 0 && gx < w;

  float cur[kRY];
  uint32_t mw[(kRY + 3) / 4] = {};
#pragma unroll
  for (int r = 0; r < kRY; ++r) {
    const int gy = gy0 + r;
    const bool in = col_in && gy >= 0 && gy < h;
    const size_t gi = base + (size_t)(in ? gy : 0) * w + (in ? gx : 0);
    cur[r] = in ? g_in_all[gi] : 0.f;
    mw[r / 4] |= (uint32_t)(in ? mask_all[gi] : 0) << (8 * (r % 4));
  }

  for (int s = 0; s < k; ++s) {
    float* cb = bufs[s & 1];
    float c[kRY];
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
      const uint8_t m = (uint8_t)(mw[r / 4] >> (8 * (r % 4)));
      c[r] = (damping * ((m & kCont) ? cur[r] : 0.f)) * 0.25f;
      cb[li0 + r * kLX] = c[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
      const int li = li0 + r * kLX;
      const uint8_t m = (uint8_t)(mw[r / 4] >> (8 * (r % 4)));
      const float c_yp = r < kRY - 1 ? c[r + 1] : cb[li + kLX];
      const float c_ym = r > 0 ? c[r - 1] : cb[li - kLX];
      cur[r] = adjoint_update(m, cur[r], c[r], cb[li + 1], cb[li - 1], c_yp,
                              c_ym, keep);
    }
  }

  if (!col_in || lx < kMaxSweeps || lx >= kLX - kMaxSweeps) return;
#pragma unroll
  for (int r = 0; r < kRY; ++r) {
    const int ly = ly0 + r, gy = gy0 + r;
    if (ly >= kMaxSweeps && ly < kLY - kMaxSweeps && gy >= 0 && gy < h)
      g_out_all[base + (size_t)gy * w + gx] = cur[r];
  }
}

bool bad_args(int b, int h, int w, int iters, const float* tmp,
              const float* p_out) {
  return iters < 0 || b < 1 || b > 65535 || h < 1 || w < 1 || tmp == p_out;
}

}  // namespace

// Sweeps one tile launch runs. Launches nothing.
extern "C" int fn_jacobi_max_sweeps() { return kMaxSweeps; }

// Kernel F: iters (>= 1) sweeps; the result lands in p_out. p0 may be null
// (a cold start from p = 0); `mask` holds b*h*w bytes and `tmp` b*h*w
// floats of scratch. Issues 1 + ceil(iters / kMaxSweeps) launches on
// `stream`; returns the first launch error, or cudaErrorInvalidValue for
// bad arguments.
extern "C" int fn_jacobi_solve(const int* flags, const float* div,
                               const float* p0, uint8_t* mask, float* tmp,
                               float* p_out, int b, int h, int w, int iters,
                               int damped, float keep, float damping,
                               void* stream) {
  if (iters < 1 || bad_args(b, h, w, iters, tmp, p_out) || p0 == p_out ||
      p0 == tmp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(32, 8);
  jacobi_mask<<<grid2d(b, h, w, block), block, 0, s>>>(flags, mask, h, w);
  const int status = launch_status();
  if (status) return status;
  return sweeps_of<kRY>(damped, p0, div, mask, tmp, p_out, b, h, w, iters,
                        keep, damping, s);
}

// Launches of one fn_tail call of `iters` sweeps. Launches nothing.
extern "C" int fn_tail_launches(int iters) { return 2 + launches_of(iters); }

// Kernel C, the tail of one projection: the inlet BC on U (U_bc and U_inv
// may be null), the RHS, `iters` (>= 0) sweeps from p0 * scale (scale
// (b,) may be null) with the weighted-Jacobi blend, U' from the final p.
// `rhs` and `tmp` are b*h*w floats and `mask` b*h*w bytes of scratch; p
// lands in p_out, U' in U_out. Issues fn_tail_launches(iters) launches on
// `stream`; returns the first launch error, or cudaErrorInvalidValue for
// bad arguments.
extern "C" int fn_tail(const int* flags, const float* U, const float* p0,
                       const float* scale, const float* U_bc,
                       const float* U_inv, float* rhs, uint8_t* mask,
                       float* tmp, float* p_out, float* U_out, int b, int h,
                       int w, int iters, int damped, float keep,
                       float damping, void* stream) {
  if (bad_args(b, h, w, iters, tmp, p_out) ||
      (U_bc == nullptr) != (U_inv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(32, 8), grid = grid2d(b, h, w, block);
  const Inlet in_bc{U_bc, U_inv};
  // The prologue's p lands where the first tile launch reads it.
  float* init = (launches_of(iters) % 2) ? tmp : p_out;
  tail_prologue<<<grid, block, 0, s>>>(flags, U, p0, scale, in_bc, rhs, init,
                                       mask, h, w);
  int status = launch_status();
  if (status) return status;
  status = sweeps_of<kTailRows>(damped, init, rhs, mask, tmp, p_out, b, h, w,
                                iters, keep, damping, s);
  if (status) return status;
  tail_epilogue<<<grid, block, 0, s>>>(flags, U, p_out, in_bc, U_out, h, w);
  return launch_status();
}

// The adjoint of fn_jacobi_solve's sweeps: iters (>= 1) transposed sweeps
// of the upstream gradient g into g_out (the gradient with respect to p0);
// `mask` holds b*h*w bytes and `tmp` b*h*w floats of scratch; keep and
// damping as fn_jacobi_solve's (keep 0 and damping 1 undamped). Issues 1 +
// ceil(iters / kMaxSweeps) launches on `stream`; returns the first launch
// error, or cudaErrorInvalidValue for bad arguments.
extern "C" int fn_jacobi_adjoint(const int* flags, const float* g,
                                 uint8_t* mask, float* tmp, float* g_out,
                                 int b, int h, int w, int iters, float keep,
                                 float damping, void* stream) {
  if (iters < 1 || bad_args(b, h, w, iters, tmp, g_out) || g == g_out ||
      g == tmp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(32, 8);
  jacobi_mask<<<grid2d(b, h, w, block), block, 0, s>>>(flags, mask, h, w);
  int status = launch_status();
  if (status) return status;
  const dim3 grid((w + kOutX - 1) / kOutX, (h + kOutY - 1) / kOutY, b);
  const dim3 tile(kLX, kLY / kRY);
  const float* src = g;
  float* dst = (launches_of(iters) % 2) ? g_out : tmp;
  for (int done = 0; done < iters;) {
    const int k = min(kMaxSweeps, iters - done);
    jacobi_adjoint_sweeps<<<grid, tile, kSmem, s>>>(src, mask, dst, h, w, k,
                                                    keep, damping);
    status = launch_status();
    if (status) return status;
    done += k;
    src = dst;
    dst = (dst == g_out) ? tmp : g_out;
  }
  return 0;
}
