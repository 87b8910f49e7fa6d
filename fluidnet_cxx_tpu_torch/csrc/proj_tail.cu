// Kernel C: the learned projection's tail — inlet BC on U, divergence RHS,
// warm start p0*scale, damped Jacobi polish sweeps, pressure-gradient
// velocity update, free-slip wall BCs, inlet BC again.
//
// Replaces fluidnet_cxx_tpu/ops/pallas/proj_tail_pallas.py::
// project_tail_pallas (body _tail_kernel), whose TPU version keeps the
// whole grid in VMEM and loops the sweeps inside one kernel. Its plain
// version is ops/kernels/proj_tail.py::project_tail_plain.
//
// What bounds it on an H100: memory. The function reads flags, u, v, p0
// and the inlet fields once and writes p, u', v' (~11 MB at 512^2,
// ~3.3 us at 3.35 TB/s); each sweep is a 5-point stencil. A grid-resident
// loop would need every block to wait for all others between sweeps, so
// this design never does that: one launch per sweep, ping-ponging two
// pressure buffers, with the 512^2 working set (p, rhs, masks ~2.3 MB)
// living in the 50 MB L2 between launches.
//   prologue: inlet BC, RHS, p0*scale, per-cell mask byte;
//   sweeps:   `iters` launches;
//   epilogue: velocity update, wall BCs, inlet BC.
// Fusing several sweeps per launch in shared memory is a later step.
#include <stdint.h>

#include "common.cuh"

namespace {
using namespace fnk;

struct Inlet {
  const float* bc;    // (b, 2, h, w) or null
  const float* inv;   // (b, 2, h, w) or null
  __device__ float apply(float val, size_t j) const {
    return bc ? val * inv[j] + bc[j] : val;
  }
};

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

__global__ void tail_sweep(const float* __restrict__ p_in_all,
                           const float* __restrict__ rhs_all,
                           const uint8_t* __restrict__ mask_all,
                           float* __restrict__ p_out_all, int h, int w,
                           int damped, float keep, float damping) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  if (x >= w || y >= h) return;
  size_t n = (size_t)h * w;
  int i = y * w + x;
  p_out_all[b * n + i] =
      jacobi_cell(p_in_all + b * n, i, w, mask_all[b * n + i],
                  rhs_all[b * n + i], damped, keep, damping);
}

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

}  // namespace

// scale (b,) and the inlet pair (U_bc, U_bc_inv_mask) may be null.
extern "C" int fn_tail_prologue(const int* flags, const float* U,
                                const float* p0, const float* scale,
                                const float* U_bc, const float* U_inv,
                                float* rhs, float* p, uint8_t* mask, int b,
                                int h, int w, void* stream) {
  dim3 block(32, 8);
  tail_prologue<<<fnk::grid2d(b, h, w, block), block, 0,
                  (cudaStream_t)stream>>>(flags, U, p0, scale,
                                          Inlet{U_bc, U_inv}, rhs, p, mask,
                                          h, w);
  return fnk::launch_status();
}

extern "C" int fn_tail_sweep(const float* p_in, const float* rhs,
                             const uint8_t* mask, float* p_out, int b, int h,
                             int w, int damped, float keep, float damping,
                             void* stream) {
  dim3 block(32, 8);
  tail_sweep<<<fnk::grid2d(b, h, w, block), block, 0,
               (cudaStream_t)stream>>>(p_in, rhs, mask, p_out, h, w, damped,
                                       keep, damping);
  return fnk::launch_status();
}

extern "C" int fn_tail_epilogue(const int* flags, const float* U,
                                const float* p, const float* U_bc,
                                const float* U_inv, float* U_out, int b,
                                int h, int w, void* stream) {
  dim3 block(32, 8);
  tail_epilogue<<<fnk::grid2d(b, h, w, block), block, 0,
                  (cudaStream_t)stream>>>(flags, U, p, Inlet{U_bc, U_inv},
                                          U_out, h, w);
  return fnk::launch_status();
}
