// Kernel J: the learned 3-D projection's tail — the divergence RHS, warm
// damped Jacobi sweeps (the cnt-folded obstacle-Neumann form, p pinned to
// 0 on obstacles and the border shell), the pressure-gradient velocity
// update (border faces untouched) and the free-slip wall BCs.
//
// Replaces fluidnet_cxx_tpu/ops/pallas/proj_tail3_pallas.py::
// project_tail3_pallas (body _tail3_kernel), whose TPU version keeps the
// whole volume in VMEM and loops the sweeps inside one kernel (and falls
// back to the unfused chain above its VMEM budget; this port runs at every
// size). Its plain version is ops/kernels/proj_tail3.py::
// project_tail3_plain, the unfused chain of ops/ops3d.py, in the same
// float32 order (-fmad=false), so the two agree bit for bit.
//
// What bounds it on an H100: memory. The function reads flags, U and p0
// once and writes p and U' once (36 bytes a cell: 75 MB, ~22 us at
// 3.35 TB/s for 128^3); a sweep does 14 operations a cell (16 sweeps:
// ~0.47 GFLOP, ~7 us at 67 TFLOP/s). No block waits on another, so the
// design is C's and I's: a prologue launch (RHS, the mask byte, p0 zeroed
// on obstacles), one launch per sweep with kernel I's sweep (csrc/
// jacobi3.cuh), ping-ponging two pressure buffers that at 128^3 live in
// the 50 MB L2 with the RHS and the mask, and an epilogue launch (update
// and walls). One C call issues all 2 + iters launches.
#include "jacobi3.cuh"

namespace {

__global__ void tail3_prologue(const int* __restrict__ flags,
                               const float* __restrict__ U,
                               const float* __restrict__ p0,
                               float* __restrict__ rhs,
                               uint8_t* __restrict__ mask,
                               float* __restrict__ p_init, Dims D) {
  int x, y, z;
  size_t base;
  if (!cell_of(D, &x, &y, &z, &base)) return;
  const size_t hw = (size_t)D.h * D.w, n = D.d * hw;
  const size_t cell = z * hw + (size_t)y * D.w + x;
  const size_t i = base + cell;
  const bool ob = flags[i] == kObstacle;
  p_init[i] = ob ? 0.f : p0[i];
  mask[i] = mask_byte3(flags, x, y, z, i, D);
  float r = 0.f;
  if (interior3(x, y, z, D) && !ob) {
    // ops3d.velocity_divergence3: (u - u[x+1]) + (v - v[y+1]) + (w - w[z+1])
    const float* u = U + 3 * base + cell;
    const float* v = u + n;
    const float* wz = v + n;
    r = ((u[0] - u[1]) + (v[0] - v[D.w])) + (wz[0] - wz[hw]);
  }
  rhs[i] = r;
}

__global__ void tail3_epilogue(const int* __restrict__ flags,
                               const float* __restrict__ U,
                               const float* __restrict__ p,
                               float* __restrict__ U_out, Dims D) {
  int x, y, z;
  size_t base;
  if (!cell_of(D, &x, &y, &z, &base)) return;
  const size_t hw = (size_t)D.h * D.w, n = D.d * hw;
  const size_t cell = z * hw + (size_t)y * D.w + x;
  const size_t i = base + cell;
  const int f = flags[i];
  const bool fl = f == kFluid, em = f == kEmpty, ob = f == kObstacle;
  const bool in = interior3(x, y, z, D);
  const size_t stride[3] = {1, (size_t)D.w, hw};
  const int idx[3] = {x, y, z};
  const float pc = p[i];
  for (int c = 0; c < 3; ++c) {
    const size_t ui = 3 * base + c * n + cell;
    const float vel = U[ui];
    // ops3d.velocity_update3; border faces keep their velocity.
    float val = vel;
    if (in) {
      const size_t j = i - stride[c];
      const int fm = flags[j];
      const float pm = p[j];
      val = (fl && fm == kFluid)   ? vel - (pc - pm)
            : (fl && fm == kEmpty) ? vel - pc
            : (em && fm == kFluid) ? vel + pm
                                   : 0.f;
    }
    // ops3d.set_wall_bcs3, the lower neighbour's index clamped at 0.
    const int fb = idx[c] > 0 ? flags[i - stride[c]] : f;
    const bool kill =
        (fl || ob) && (fb == kObstacle || (ob && fb == kFluid));
    U_out[ui] = kill ? 0.f : val;
  }
}

}  // namespace

// The tail of one projection: RHS of U, `iters` (>= 0) warm sweeps from p0
// (zeroed on obstacles) with the weighted-Jacobi blend, U' from the final
// p. `rhs` and `tmp` are b*d*h*w floats and `mask` b*d*h*w bytes of
// scratch; p lands in p_out, U' in U_out. Issues 2 + iters launches on
// `stream`; returns the first launch error, or cudaErrorInvalidValue for
// bad arguments.
extern "C" int fn_tail3(const int* flags, const float* U, const float* p0,
                        float* rhs, uint8_t* mask, float* tmp, float* p_out,
                        float* U_out, int b, int d, int h, int w, int iters,
                        int damped, float keep, float damping,
                        void* stream) {
  if (bad_args3(b, d, h, w, iters, tmp, p_out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  Dims D{d, h, w};
  float* init = warm_buffer3(iters, tmp, p_out);
  tail3_prologue<<<grid3(b, D), kBlock3, 0, s>>>(flags, U, p0, rhs, mask,
                                                 init, D);
  int status = fnk::launch_status();
  if (status) return status;
  status = jacobi3_sweeps(init, rhs, mask, tmp, p_out, b, D, iters, damped,
                          keep, damping, s);
  if (status) return status;
  tail3_epilogue<<<grid3(b, D), kBlock3, 0, s>>>(flags, U, p_out, U_out, D);
  return fnk::launch_status();
}
