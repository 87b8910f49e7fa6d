// The 3-D Jacobi code shared by kernel I (csrc/jacobi3.cu) and kernel J
// (csrc/proj_tail3.cu): the mask byte, the argument checks, and the
// one-sweep launch that J runs (I runs several sweeps a launch, in
// jacobi3.cu): the 3-D Jacobi pressure sweep (6 neighbours) with the
// obstacle-Neumann substitution folded into cnt * p_c, in the float32
// order of ops/ops3d.py::solve_jacobi_fixed3: acc = div + cnt * p_c, then
// + x-1, + x+1, + y-1, + y+1, + z-1, + z+1, times float32(1/6), then the
// weighted-Jacobi blend.
//
// Threads run x fastest, one z-slice of one sample per blockIdx.z; cell
// indices are size_t.
#pragma once
#include <stdint.h>

#include "common.cuh"

namespace {
using namespace fnk;

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

// One sweep from p_in (null: zeros) into p_out (a distinct buffer).
__global__ void __launch_bounds__(256)
    jacobi3_sweep(const float* __restrict__ p_in,
                  const float* __restrict__ div,
                  const uint8_t* __restrict__ mask,
                  float* __restrict__ p_out, Dims D, int damped, float keep,
                  float damping) {
  int x, y, z;
  size_t base;
  if (!cell_of(D, &x, &y, &z, &base)) return;
  const size_t hw = (size_t)D.h * D.w;
  const size_t i = base + z * hw + (size_t)y * D.w + x;
  const uint8_t m = mask[i];
  if (!(m & 1)) {
    p_out[i] = 0.f;
    return;
  }
  const float sixth = (float)(1.0 / 6.0);
  float pc = 0.f, acc;
  if (p_in) {
    pc = p_in[i];
    acc = div[i] + (float)(m >> 1) * pc;
    acc = acc + p_in[i - 1];
    acc = acc + p_in[i + 1];
    acc = acc + p_in[i - D.w];
    acc = acc + p_in[i + D.w];
    acc = acc + p_in[i - hw];
    acc = acc + p_in[i + hw];
  } else {
    // p == 0: the same sums of zeros, div + 0 + ... + 0 == div.
    acc = div[i];
  }
  float upd = acc * sixth;
  p_out[i] = damped ? keep * pc + damping * upd : upd;
}

// The buffer a warm start goes into so that the last of `launches`
// ping-ponging launches lands in p_out: an odd count starts writing p_out,
// an even one tmp.
inline float* warm_buffer3(int launches, float* tmp, float* p_out) {
  return (launches % 2) ? tmp : p_out;
}

// `iters` sweep launches from src (null: zeros; else warm_buffer3's
// buffer), ping-ponging tmp and p_out; the result lands in p_out.
inline int jacobi3_sweeps(const float* src, const float* div,
                          const uint8_t* mask, float* tmp, float* p_out,
                          int b, const Dims& D, int iters, int damped,
                          float keep, float damping, cudaStream_t s) {
  float* dst = (iters % 2) ? p_out : tmp;
  for (int k = 0; k < iters; ++k) {
    jacobi3_sweep<<<grid3(b, D), kBlock3, 0, s>>>(src, div, mask, dst, D,
                                                  damped, keep, damping);
    int status = fnk::launch_status();
    if (status) return status;
    float* next = (dst == p_out) ? tmp : p_out;
    src = dst;
    dst = next;
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

}  // namespace
