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
// waits on another, so each sweep is one launch, ping-ponging two pressure
// buffers; the 2-D kernel F's temporal blocking in shared memory is left
// for a later change. One launch first builds a byte per cell (bit 0: the
// sweep updates the cell; bits 1-3: cnt, the number of obstacle
// neighbours) and zeroes a warm start on obstacles (the cnt * p_c identity
// needs p == 0 there). At 128^3 p, p', the RHS and the mask byte take
// ~27 MB, inside the 50 MB L2, so a sweep reads its neighbours from L2.
// All 1 + iters launches are issued by one C call (fn_jacobi3_solve), so
// the host pays one ctypes call per solve. Threads run x fastest; cell
// indices are size_t.
#include <stdint.h>

#include "common.cuh"

namespace {
using namespace fnk;

const dim3 kBlock(32, 8);

struct Dims {
  int d, h, w;
};

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

__global__ void jacobi3_mask(const int* __restrict__ flags,
                             const float* __restrict__ p0,
                             uint8_t* __restrict__ mask,
                             float* __restrict__ p_init, Dims D) {
  int x, y, z;
  size_t base;
  if (!cell_of(D, &x, &y, &z, &base)) return;
  const size_t hw = (size_t)D.h * D.w;
  const size_t i = base + z * hw + (size_t)y * D.w + x;
  const bool ob = flags[i] == kObstacle;
  if (p0) p_init[i] = ob ? 0.f : p0[i];
  bool in = x >= 1 && x <= D.w - 2 && y >= 1 && y <= D.h - 2 && z >= 1 &&
            z <= D.d - 2;
  if (!in || ob) {
    mask[i] = 0;
    return;
  }
  int cnt = (flags[i - 1] == kObstacle) + (flags[i + 1] == kObstacle) +
            (flags[i - D.w] == kObstacle) + (flags[i + D.w] == kObstacle) +
            (flags[i - hw] == kObstacle) + (flags[i + hw] == kObstacle);
  mask[i] = (uint8_t)(1 | (cnt << 1));
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

}  // namespace

// iters (>= 1) sweeps; the result lands in p_out. p0 may be null (a cold
// start from p = 0); `mask` holds b*d*h*w bytes and `tmp` b*d*h*w floats
// of scratch. Issues 1 + iters launches on `stream`; returns the first
// launch error, or cudaErrorInvalidValue for bad arguments.
extern "C" int fn_jacobi3_solve(const int* flags, const float* div,
                                const float* p0, uint8_t* mask, float* tmp,
                                float* p_out, int b, int d, int h, int w,
                                int iters, int damped, float keep,
                                float damping, void* stream) {
  if (iters < 1 || b < 1 || d < 3 || h < 3 || w < 3 || tmp == p_out ||
      (size_t)b * d > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  Dims D{d, h, w};
  dim3 grid((w + kBlock.x - 1) / kBlock.x, (h + kBlock.y - 1) / kBlock.y,
            b * d);
  // Ping-pong so that the last sweep writes p_out: an odd count starts
  // writing p_out, an even one tmp; the warm start sits in the other.
  float* first_dst = (iters % 2) ? p_out : tmp;
  float* init = (iters % 2) ? tmp : p_out;
  jacobi3_mask<<<grid, kBlock, 0, s>>>(flags, p0, mask, init, D);
  int status = fnk::launch_status();
  if (status) return status;
  const float* src = p0 ? init : nullptr;
  float* dst = first_dst;
  for (int k = 0; k < iters; ++k) {
    jacobi3_sweep<<<grid, kBlock, 0, s>>>(src, div, mask, dst, D, damped,
                                          keep, damping);
    status = fnk::launch_status();
    if (status) return status;
    float* next = (dst == p_out) ? tmp : p_out;
    src = dst;
    dst = next;
  }
  return 0;
}
