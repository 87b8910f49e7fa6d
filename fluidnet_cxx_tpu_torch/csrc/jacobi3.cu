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
#include "jacobi3.cuh"

namespace {

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
  if (iters < 1 || bad_args3(b, d, h, w, iters, tmp, p_out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  Dims D{d, h, w};
  float* init = warm_buffer3(iters, tmp, p_out);
  jacobi3_mask<<<grid3(b, D), kBlock3, 0, s>>>(flags, p0, mask, init, D);
  int status = fnk::launch_status();
  if (status) return status;
  return jacobi3_sweeps(p0 ? init : nullptr, div, mask, tmp, p_out, b, D,
                        iters, damped, keep, damping, s);
}
