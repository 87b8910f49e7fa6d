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

enum : uint8_t {
  kCont = 1,   // interior, not obstacle: the sweep updates it
  kObXm = 2,   // obstacle neighbours: Neumann substitution
  kObXp = 4,
  kObYm = 8,
  kObYp = 16,
};

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
  bool ob = flags[i] == kObstacle;
  bool cont = interior(x, y, h, w) && !ob;
  float rhs = 0.f;
  uint8_t m = 0;
  if (cont) {
    float u0 = in_bc.apply(U[ub + i], ub + i);
    float u1 = in_bc.apply(U[ub + i + 1], ub + i + 1);
    float v0 = in_bc.apply(U[vb + i], vb + i);
    float v1 = in_bc.apply(U[vb + i + w], vb + i + w);
    rhs = (u0 - u1) + (v0 - v1);
    m = kCont;
    if (flags[i - 1] == kObstacle) m |= kObXm;
    if (flags[i + 1] == kObstacle) m |= kObXp;
    if (flags[i - w] == kObstacle) m |= kObYm;
    if (flags[i + w] == kObstacle) m |= kObYp;
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
  const float* p_in = p_in_all + b * n;
  uint8_t m = mask_all[b * n + i];
  float out = 0.f;
  if (m & kCont) {
    float p = p_in[i];
    float p1 = (m & kObXm) ? p : p_in[i - 1];
    float p2 = (m & kObXp) ? p : p_in[i + 1];
    float p3 = (m & kObYm) ? p : p_in[i - w];
    float p4 = (m & kObYp) ? p : p_in[i + w];
    float upd = ((((p1 + p2) + p3) + p4) + rhs_all[b * n + i]) * 0.25f;
    out = damped ? keep * p + damping * upd : upd;
  }
  p_out_all[b * n + i] = out;
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
  float u = in_bc.apply(U[ub + i], ub + i);
  float v = in_bc.apply(U[vb + i], vb + i);
  int f = flags[i];
  bool fl = f == kFluid, em = f == kEmpty, ob = f == kObstacle;

  // Velocity update (fluid/empty face rules); border faces untouched.
  float un = u, vn = v;
  if (interior(x, y, h, w)) {
    int fx = flags[i - 1], fy = flags[i - w];
    bool flx = fx == kFluid, emx = fx == kEmpty;
    bool fly = fy == kFluid, emy = fy == kEmpty;
    float pc = p[i], px = p[i - 1], py = p[i - w];
    un = (fl && flx) ? u - (pc - px)
         : (fl && emx) ? u - pc
         : (em && flx) ? u + px : 0.f;
    vn = (fl && fly) ? v - (pc - py)
         : (fl && emy) ? v - pc
         : (em && fly) ? v + py : 0.f;
  }
  // Free-slip walls, left/down neighbour index clamped at 0.
  int fxc = x > 0 ? flags[i - 1] : f;
  int fyc = y > 0 ? flags[i - w] : f;
  bool contw = fl || ob;
  bool kill_u = contw && (fxc == kObstacle || (ob && fxc == kFluid));
  bool kill_v = contw && (fyc == kObstacle || (ob && fyc == kFluid));
  if (kill_u) un = 0.f;
  if (kill_v) vn = 0.f;
  U_out[ub + i] = in_bc.apply(un, ub + i);
  U_out[vb + i] = in_bc.apply(vn, vb + i);
}

dim3 grid_for(int b, int h, int w, dim3 block) {
  return dim3((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, b);
}

}  // namespace

// scale (b,) and the inlet pair (U_bc, U_bc_inv_mask) may be null.
extern "C" int fn_tail_prologue(const int* flags, const float* U,
                                const float* p0, const float* scale,
                                const float* U_bc, const float* U_inv,
                                float* rhs, float* p, uint8_t* mask, int b,
                                int h, int w, void* stream) {
  dim3 block(32, 8);
  tail_prologue<<<grid_for(b, h, w, block), block, 0,
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
  tail_sweep<<<grid_for(b, h, w, block), block, 0, (cudaStream_t)stream>>>(
      p_in, rhs, mask, p_out, h, w, damped, keep, damping);
  return fnk::launch_status();
}

extern "C" int fn_tail_epilogue(const int* flags, const float* U,
                                const float* p, const float* U_bc,
                                const float* U_inv, float* U_out, int b,
                                int h, int w, void* stream) {
  dim3 block(32, 8);
  tail_epilogue<<<grid_for(b, h, w, block), block, 0,
                  (cudaStream_t)stream>>>(flags, U, p, Inlet{U_bc, U_inv},
                                          U_out, h, w);
  return fnk::launch_status();
}
