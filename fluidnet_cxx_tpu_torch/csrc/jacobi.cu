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
// its 32x32 output tile plus a k-cell halo of p, RHS and mask into shared
// memory, runs k sweeps there (the exact region shrinks by one cell a
// sweep), and writes back the inner tile. No block reads another's output
// within a launch; 200 sweeps are 25 launches plus one mask launch.
// The per-cell arithmetic is jacobi_cell, shared with kernel C's sweep and
// the multigrid smoother, in the plain version's float32 order.
#include <stdint.h>

#include "common.cuh"

namespace {
using namespace fnk;

constexpr int kTile = 32;                        // output tile side
constexpr int kMaxSweeps = 8;                    // sweeps fused per launch
constexpr int kSide = kTile + 2 * kMaxSweeps;    // shared tile side, 48

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
__global__ void __launch_bounds__(256)
    jacobi_sweeps(const float* __restrict__ p_in_all,
                  const float* __restrict__ rhs_all,
                  const uint8_t* __restrict__ mask_all,
                  float* __restrict__ p_out_all, int h, int w, int k,
                  int damped, float keep, float damping) {
  __shared__ float pa[kSide * kSide];
  __shared__ float pb[kSide * kSide];
  __shared__ float rs[kSide * kSide];
  __shared__ uint8_t ms[kSide * kSide];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const size_t n = (size_t)h * w;
  const size_t base = blockIdx.z * n;
  const int x0 = blockIdx.x * kTile - k, y0 = blockIdx.y * kTile - k;
  const int side = kTile + 2 * k;

  for (int t = tid; t < side * side; t += nt) {
    int ly = t / side, lx = t - ly * side;
    int gx = x0 + lx, gy = y0 + ly;
    int li = ly * kSide + lx;
    bool in = inside(gx, gy, h, w);
    size_t gi = base + (size_t)gy * w + gx;
    pa[li] = (in && p_in_all) ? p_in_all[gi] : 0.f;
    rs[li] = in ? rhs_all[gi] : 0.f;
    ms[li] = in ? mask_all[gi] : 0;
  }
  __syncthreads();

  float* cur = pa;
  float* nxt = pb;
  for (int s = 1; s <= k; ++s) {
    // After sweep s the cells s..side-1-s of each axis are exact.
    int cs = side - 2 * s;
    for (int t = tid; t < cs * cs; t += nt) {
      int ly = s + t / cs, lx = s + t % cs;
      int li = ly * kSide + lx;
      nxt[li] = jacobi_cell(cur, li, kSide, ms[li], rs[li], damped, keep,
                            damping);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int t = tid; t < kTile * kTile; t += nt) {
    int ly = t / kTile, lx = t % kTile;
    int gx = x0 + k + lx, gy = y0 + k + ly;
    if (inside(gx, gy, h, w))
      p_out_all[base + (size_t)gy * w + gx] = cur[(ly + k) * kSide + lx + k];
  }
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
  dim3 block(32, 8);
  jacobi_sweeps<<<fnk::grid2d(b, h, w, dim3(kTile, kTile)), block, 0,
                  (cudaStream_t)stream>>>(p_in, rhs, mask, p_out, h, w, k,
                                          damped, keep, damping);
  return fnk::launch_status();
}
