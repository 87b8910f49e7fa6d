// Shared helpers for the port's CUDA kernels (built by
// fluidnet_cxx_tpu_torch/ops/kernels/_build.py with one nvcc command).
//
// Floating-point contract: the library is compiled with -fmad=false, so a
// product followed by a sum rounds twice, as the plain PyTorch versions of
// the kernels do; code that wants a fused multiply-add calls fmaf().
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

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

// Per-cell mask byte of the pressure solvers.
enum : uint8_t {
  kCont = 1,   // interior, not obstacle: the sweep updates it
  kObXm = 2,   // obstacle neighbours: Neumann substitution
  kObXp = 4,
  kObYm = 8,
  kObYp = 16,
};

// Mask byte of cell (x, y) of one sample's flags (h, w).
__device__ __forceinline__ uint8_t cell_mask(const int* flags, int x, int y,
                                             int h, int w) {
  int i = y * w + x;
  if (!interior(x, y, h, w) || flags[i] == kObstacle) return 0;
  uint8_t m = kCont;
  if (flags[i - 1] == kObstacle) m |= kObXm;
  if (flags[i + 1] == kObstacle) m |= kObXp;
  if (flags[i - w] == kObstacle) m |= kObYm;
  if (flags[i + w] == kObstacle) m |= kObYp;
  return m;
}

// One Jacobi update of a cell with mask byte m from its own value pc and
// its neighbours' values at x-1, x+1, y-1, y+1 (ops/jacobi.py::
// _sweep_maker, same float32 operation order): obstacle neighbours read
// the centre value, non-continuation cells are pinned to 0, `damped`
// blends keep * p + damping * update.
__device__ __forceinline__ float jacobi_update(uint8_t m, float pc, float xm,
                                               float xp, float ym, float yp,
                                               float rhs, int damped,
                                               float keep, float damping) {
  if (!(m & kCont)) return 0.f;
  float p1 = (m & kObXm) ? pc : xm;
  float p2 = (m & kObXp) ? pc : xp;
  float p3 = (m & kObYm) ? pc : ym;
  float p4 = (m & kObYp) ? pc : yp;
  float upd = ((((p1 + p2) + p3) + p4) + rhs) * 0.25f;
  return damped ? keep * pc + damping * upd : upd;
}

// jacobi_update of cell i of a row-major field p with row stride
// `stride` (a continuation cell is interior: its neighbours are in p).
__device__ __forceinline__ float jacobi_cell(const float* p, int i,
                                             int stride, uint8_t m, float rhs,
                                             int damped, float keep,
                                             float damping) {
  if (!(m & kCont)) return 0.f;
  return jacobi_update(m, p[i], p[i - 1], p[i + 1], p[i - stride],
                       p[i + stride], rhs, damped, keep, damping);
}

// Pressure-gradient velocity update (fluid/empty face rules, border faces
// untouched) and free-slip wall BCs of cell (x, y): ops/stencils.py's
// velocity_update then set_wall_bcs. `pv(j)` returns the pressure of cell
// j of this sample; u, v are the cell's input faces.
template <class P>
__device__ __forceinline__ void update_and_walls(const int* flags, P pv,
                                                 float u, float v, int x,
                                                 int y, int h, int w,
                                                 float* u_out, float* v_out) {
  int i = y * w + x;
  int f = flags[i];
  bool fl = f == kFluid, em = f == kEmpty, ob = f == kObstacle;
  float un = u, vn = v;
  if (interior(x, y, h, w)) {
    int fx = flags[i - 1], fy = flags[i - w];
    bool flx = fx == kFluid, emx = fx == kEmpty;
    bool fly = fy == kFluid, emy = fy == kEmpty;
    float pc = pv(i), px = pv(i - 1), py = pv(i - w);
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
  *u_out = kill_u ? 0.f : un;
  *v_out = kill_v ? 0.f : vn;
}

// Grid of 2-D blocks covering (h, w), one z-slice per sample.
inline dim3 grid2d(int b, int h, int w, dim3 block) {
  return dim3((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, b);
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace fnk
