// Shared helpers for the port's CUDA kernels (built by
// fluidnet_cxx_tpu_torch/ops/kernels/_build.py with one nvcc command).
//
// Floating-point contract: the library is compiled with -fmad=false, so a
// product followed by a sum rounds twice, as the plain PyTorch versions of
// the kernels do; code that wants a fused multiply-add calls fmaf().
#pragma once
#include <cuda_runtime.h>

namespace fnk {

constexpr int kFluid = 1;
constexpr int kObstacle = 2;
constexpr int kEmpty = 4;

__device__ __forceinline__ bool inside(int x, int y, int h, int w) {
  return x >= 0 && x < w && y >= 0 && y < h;
}

// Interior of the 1-cell border ring.
__device__ __forceinline__ bool interior(int x, int y, int h, int w) {
  return x >= 1 && x <= w - 2 && y >= 1 && y <= h - 2;
}

// Load with zero outside the grid: a sample beyond the domain reads 0.
__device__ __forceinline__ float ld(const float* a, int x, int y, int h,
                                    int w) {
  return inside(x, y, h, w) ? a[y * w + x] : 0.f;
}

// Flag with 0 (TypeNone: neither fluid nor obstacle) outside the grid.
__device__ __forceinline__ int ldf(const int* f, int x, int y, int h, int w) {
  return inside(x, y, h, w) ? f[y * w + x] : 0;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace fnk
