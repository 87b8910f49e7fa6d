// Kernel F: fixed-count Jacobi pressure sweeps with obstacle-Neumann
// substitution, pressure pinned to 0 on the border ring and in obstacles,
// optional warm start p0 and weighted-Jacobi damping.
//
// Replaces fluidnet_cxx_tpu/ops/pallas/jacobi_pallas.py::
// solve_jacobi_pallas (body _jacobi_kernel), whose TPU version keeps one
// sample's grid in VMEM and loops every sweep inside one kernel. Its plain
// version is ops/jacobi.py::solve_jacobi_fixed.
//
// What bounds it on an H100: operations. The function reads flags and the
// RHS once and writes p once (12 bytes a cell, ~3 MB at 512^2, ~0.9 us at
// 3.35 TB/s), but does ~10 operations per continuation cell per sweep:
// 200 sweeps at 512^2 are ~0.5 GFLOP, ~8 us at the 67 TFLOP/s fp32 rate.
// Looping all sweeps in one kernel would need every block to wait for the
// others between sweeps, which this port never does; one launch per sweep
// is launch-bound (C's 2.3 us sweeps take ~6-10 us of wall each). So each
// launch runs up to kMaxSweeps sweeps by temporal blocking: a block loads
// its output tile plus a kMaxSweeps-cell halo of p, RHS and mask, runs k
// sweeps on it (the exact region shrinks by one cell a sweep; what lies
// outside it is never read by a cell that is written back), and writes
// back the output tile. No block reads another's output within a launch;
// 200 sweeps are 25 launches plus one mask launch.
//
// Thread (tx, ty) owns column tx of the tile and the strip of kRY rows
// from ty * kRY: its cells' p, RHS and mask stay in registers for the
// whole launch, so a sweep reads only the x-neighbours and the strip's two
// end rows from shared memory, which holds the previous sweep's p twice
// (written to the other copy, one barrier a sweep). No index is divided
// at run time. The tile is 64 x 64 cells (48^2 output, 1.78x the output
// loaded): the 96 x 96 tile (80^2 output, 1.44x) was no faster at
// 8000x800, whose p, p', RHS and mask (~83 MB) exceed the 50 MB L2, and
// slower at 512^2, where it gives 49 blocks for 132 SMs (PERF.md).
// The per-cell arithmetic is jacobi_update, shared with kernel C's sweep
// and the multigrid smoother, in the plain version's float32 order.
#include <stdint.h>

#include "common.cuh"

namespace {
using namespace fnk;

constexpr int kMaxSweeps = 8;    // sweeps fused per launch, the tile's halo
constexpr int kTile = 64;        // the tile's side
constexpr int kLX = kTile, kLY = kTile;  // tile cells
constexpr int kRY = kLY / 8;     // rows a thread: 8 threads a column
constexpr int kOutX = kLX - 2 * kMaxSweeps, kOutY = kLY - 2 * kMaxSweeps;
constexpr int kThreads = kLX * (kLY / kRY);
// One copy of p with a row and a cell of padding at each end, so that the
// tile's edge cells read in bounds (values that are never exact).
constexpr int kPad = kLX + 1;
constexpr int kCopy = kLX * kLY + 2 * kPad;
constexpr int kSmem = 2 * kCopy * (int)sizeof(float);
static_assert(kLX % 32 == 0 && kLY % 8 == 0, "whole warps and strips");

__global__ void jacobi_mask(const int* __restrict__ flags_all,
                            uint8_t* __restrict__ mask_all, int h, int w) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  if (x >= w || y >= h) return;
  size_t n = (size_t)h * w;
  mask_all[b * n + y * w + x] = cell_mask(flags_all + b * n, x, y, h, w);
}

// k (1..kMaxSweeps) sweeps from p_in (null: zeros) into p_out; p_in and
// p_out are distinct buffers.
template <bool kDamped>
__global__ void __launch_bounds__(kThreads)
    jacobi_sweeps(const float* __restrict__ p_in_all,
                  const float* __restrict__ rhs_all,
                  const uint8_t* __restrict__ mask_all,
                  float* __restrict__ p_out_all, int h, int w, int k,
                  float keep, float damping) {
  extern __shared__ float smem[];
  float* src = smem + kPad;
  float* dst = smem + kCopy + kPad;
  const int lx = threadIdx.x, ly0 = threadIdx.y * kRY;
  const int li0 = ly0 * kLX + lx;
  const int gx = blockIdx.x * kOutX - kMaxSweeps + lx;
  const int gy0 = blockIdx.y * kOutY - kMaxSweeps + ly0;
  const size_t base = blockIdx.z * (size_t)h * w;
  const bool col_in = gx >= 0 && gx < w;

  // The strip's p, RHS and mask bytes (four to a word).
  float cur[kRY], rhs[kRY];
  uint32_t mw[(kRY + 3) / 4] = {};
#pragma unroll
  for (int r = 0; r < kRY; ++r) {
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
    for (int r = 0; r < kRY; ++r) {
      const int li = li0 + r * kLX;
      const float pc = cur[r];
      const float below = r < kRY - 1 ? cur[r + 1] : src[li + kLX];
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
  for (int r = 0; r < kRY; ++r) {
    const int ly = ly0 + r, gy = gy0 + r;
    if (ly >= kMaxSweeps && ly < kLY - kMaxSweeps && gy >= 0 && gy < h)
      p_out_all[base + (size_t)gy * w + gx] = cur[r];
  }
}

template <bool kDamped>
int launch_sweeps(const float* p_in, const float* rhs, const uint8_t* mask,
                  float* p_out, int b, int h, int w, int k, float keep,
                  float damping, cudaStream_t s) {
  auto kern = jacobi_sweeps<kDamped>;
  if (kSmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((w + kOutX - 1) / kOutX, (h + kOutY - 1) / kOutY, b);
  kern<<<grid, dim3(kLX, kLY / kRY), kSmem, s>>>(p_in, rhs, mask, p_out, h,
                                                  w, k, keep, damping);
  return launch_status();
}

}  // namespace

extern "C" int fn_jacobi_mask(const int* flags, uint8_t* mask, int b, int h,
                              int w, void* stream) {
  dim3 block(32, 8);
  jacobi_mask<<<fnk::grid2d(b, h, w, block), block, 0,
                (cudaStream_t)stream>>>(flags, mask, h, w);
  return fnk::launch_status();
}

// Sweeps one fn_jacobi_sweeps call may run. Launches nothing.
extern "C" int fn_jacobi_max_sweeps() { return kMaxSweeps; }

// p_in may be null (a cold start from p = 0).
extern "C" int fn_jacobi_sweeps(const float* p_in, const float* rhs,
                                const uint8_t* mask, float* p_out, int b,
                                int h, int w, int k, int damped, float keep,
                                float damping, void* stream) {
  if (k < 1 || k > kMaxSweeps || p_in == p_out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  if (damped)
    return launch_sweeps<true>(p_in, rhs, mask, p_out, b, h, w, k, keep,
                               damping, s);
  return launch_sweeps<false>(p_in, rhs, mask, p_out, b, h, w, k, keep,
                              damping, s);
}
