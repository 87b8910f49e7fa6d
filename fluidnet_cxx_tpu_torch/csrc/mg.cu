// Kernels G and H: geometric multigrid V-cycles for the obstacle-aware
// pressure Poisson equation (G), and the whole multigrid pressure
// projection around them (H: divergence RHS, V-cycles, zero-mean gauge,
// velocity update and free-slip wall BCs).
//
// Replaces fluidnet_cxx_tpu/ops/pallas/mg_pallas.py::solve_mg_pallas (G,
// body _mg_kernel) and ::project_mg_pallas (H, body _mg_proj_kernel),
// whose TPU versions hold every level of one sample in VMEM and run the
// whole solve in one kernel. Plain versions: ops/multigrid.py::solve_mg
// (G) and the chain velocity_divergence -> solve_mg -> velocity_update ->
// set_wall_bcs (H), in ops/kernels/mg.py.
//
// What bounds it on an H100: bytes and launches. The function reads flags,
// the RHS (or U) and p0 once and writes p (and U) once (16-28 bytes a
// cell, 1.3-2.2 us at 512^2); its ~180 operations per fine cell per
// V-cycle take ~1.4 us at the fp32 rate. A grid-resident V-cycle would
// need grid-wide waits between its stages, which this port never uses, so
// the design splits the levels:
//   * levels too large for one block run one launch per stage: the
//     compatibility projection (every block sums the per-block partials of
//     the stage that produced the RHS, in a fixed order, so runs repeat
//     bit for bit), the pre- and post-smoothing sweeps (kernel F's
//     temporally blocked jacobi_sweeps), residual + border fold + 2x2
//     child-sum restriction fused with the next level's partial sums, and
//     Neumann extension + bilinear prolongation fused per fine tile;
//   * the first level whose remaining hierarchy fits in one block's shared
//     memory (64^2 and below at 512^2; 128x32 and below at 512x128) runs
//     the whole rest of the V-cycle in ONE single-block launch per sample,
//     with __syncthreads between stages.
// At 512^2 one V-cycle is 15 launches (2 V-cycles and the set-up: 41),
// against ~70 per V-cycle for a launch per operation. The TPU kernel's
// MXU restriction/prolongation matrices are a TPU device: here restriction
// is a child sum and prolongation the (3/4, 1/4) stencil, both in the
// plain version's float32 order; the sweeps use the plain version's
// obstacle substitution (jacobi_cell), so p0 needs no masking. The sums
// (projections, gauge, the 2x2 child sum) are taken in another order than
// PyTorch's, so results agree with the plain version to rounding.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {
using namespace fnk;

constexpr int kMaxLevels = 16;
constexpr int kSmallThreads = 1024;
// Dynamic shared memory the single-block launch may take (a block may use
// 227 KB); fn_mg_cut_level picks the first level that fits.
constexpr int kSmallBudget = 160 * 1024;
constexpr int kPT = 32;               // prolongation: fine tile side
constexpr int kPR = kPT / 2 + 6;      // its coarse region side (halo 3)

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

__device__ __forceinline__ int thread_rank() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int block_threads() {
  return blockDim.x * blockDim.y;
}

__device__ __forceinline__ float cont_f(uint8_t m) {
  return (m & kCont) ? 1.f : 0.f;
}

// Sums of (a, c) over the block in a fixed tree order (blockDim a power of
// two, sa/sc one float per thread); every thread gets the totals. Every
// thread of the block must call it.
__device__ void block_sum2(float& a, float& c, float* sa, float* sc) {
  int tid = thread_rank(), nt = block_threads();
  sa[tid] = a;
  sc[tid] = c;
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (tid < s) {
      sa[tid] = sa[tid] + sa[tid + s];
      sc[tid] = sc[tid] + sc[tid + s];
    }
    __syncthreads();
  }
  a = sa[0];
  c = sc[0];
  __syncthreads();
}

// Mean sum/max(count, 1) of a level from its per-block (sum, count)
// partials. Every thread of the block must call it.
__device__ float partials_mean(const float* parts, int nparts, float* sa,
                               float* sc) {
  float a = 0.f, c = 0.f;
  for (int j = thread_rank(); j < nparts; j += block_threads()) {
    a = a + parts[2 * j];
    c = c + parts[2 * j + 1];
  }
  block_sum2(a, c, sa, sc);
  return a / fmaxf(c, 1.f);
}

// Thread 0 stores the block's (sum, count) partial of sample b.
__device__ void store_partial(float a, float c, float* parts_all, float* sa,
                              float* sc) {
  block_sum2(a, c, sa, sc);
  if (thread_rank() == 0) {
    int nblk = gridDim.x * gridDim.y;
    int j = blockIdx.z * nblk + blockIdx.y * gridDim.x + blockIdx.x;
    parts_all[2 * j] = a;
    parts_all[2 * j + 1] = c;
  }
}

// ---- per-cell operators (ops/multigrid.py, same float32 order) ----

// Residual rhs - A p of cell i (0 off continuation cells).
__device__ __forceinline__ float resid(const float* p, const float* rhs,
                                       const uint8_t* mask, int i, int w) {
  uint8_t m = mask[i];
  if (!(m & kCont)) return 0.f;
  float pc = p[i];
  float acc = 0.f;
  acc = acc + ((m & kObXm) ? pc : p[i - 1]);
  acc = acc + ((m & kObXp) ? pc : p[i + 1]);
  acc = acc + ((m & kObYm) ? pc : p[i - w]);
  acc = acc + ((m & kObYp) ? pc : p[i + w]);
  return rhs[i] - (4.f * pc - acc);
}

// Residual of cell (x, y) after _fold_border's row step.
__device__ float resid_rows(const float* p, const float* rhs,
                            const uint8_t* mask, int x, int y, int h, int w) {
  if (y == 1 || y == h - 2) return 0.f;
  float r = resid(p, rhs, mask, y * w + x, w);
  if (y == 2) r = r + resid(p, rhs, mask, w + x, w);
  if (y == h - 3) r = r + resid(p, rhs, mask, (h - 2) * w + x, w);
  return r;
}

// Residual of cell (x, y) after both steps of _fold_border.
__device__ float folded(const float* p, const float* rhs, const uint8_t* mask,
                        int x, int y, int h, int w) {
  if (x == 1 || x == w - 2) return 0.f;
  float r = resid_rows(p, rhs, mask, x, y, h, w);
  if (x == 2) r = r + resid_rows(p, rhs, mask, 1, y, h, w);
  if (x == w - 3) r = r + resid_rows(p, rhs, mask, w - 2, y, h, w);
  return r;
}

// Coarse cell (X, Y) of _restrict_sum(residual) of a fine level (h, w).
__device__ float restrict_cell(const float* p, const float* rhs,
                               const uint8_t* mask, int X, int Y, int h,
                               int w) {
  int x = 2 * X, y = 2 * Y;
  return (folded(p, rhs, mask, x, y, h, w) +
          folded(p, rhs, mask, x + 1, y, h, w)) +
         (folded(p, rhs, mask, x, y + 1, h, w) +
          folded(p, rhs, mask, x + 1, y + 1, h, w));
}

// One pass of _neumann_extend at cell c with neighbours (x-1, x+1, y-1,
// y+1) at jxm, jxp, jym, jyp; stores the pass's live flag if asked.
__device__ __forceinline__ float extend_cell(const float* e,
                                             const uint8_t* live, int c,
                                             int jxm, int jxp, int jym,
                                             int jyp, uint8_t* live_out) {
  float lxm = live[jxm], lxp = live[jxp], lym = live[jym], lyp = live[jyp];
  float num = 0.f;
  num = num + e[jxm] * lxm;
  num = num + e[jxp] * lxp;
  num = num + e[jym] * lym;
  num = num + e[jyp] * lyp;
  float den = 0.f;
  den = den + lxm;
  den = den + lxp;
  den = den + lym;
  den = den + lyp;
  float fill = num / fmaxf(den, 1.f);
  if (live_out) live_out[c] = (live[c] || den > 0.5f) ? 1 : 0;
  return live[c] ? e[c] : fill;
}

// Cell-centred bilinear prolongation (_prolong) of fine child (2i+a,
// 2j+b) from coarse rows i, i2 = i -/+ 1 and columns j, j2 = j -/+ 1 of a
// row-major field E with row stride s.
__device__ __forceinline__ float prolong_val(const float* E, int s, int i,
                                             int j, int i2, int j2) {
  float g = 0.75f * E[i * s + j] + 0.25f * E[i2 * s + j];
  float g2 = 0.75f * E[i * s + j2] + 0.25f * E[i2 * s + j2];
  return 0.75f * g + 0.25f * g2;
}

// ---- multi-block stages ----

// H's prologue: the mask byte and the divergence RHS of level 0.
__global__ void mg_prologue(const int* __restrict__ flags_all,
                            const float* __restrict__ U,
                            uint8_t* __restrict__ mask_all,
                            float* __restrict__ rhs_all, int h, int w) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  if (x >= w || y >= h) return;
  size_t n = (size_t)h * w;
  int i = y * w + x;
  size_t ub = (size_t)b * 2 * n, vb = ub + n;
  uint8_t m = cell_mask(flags_all + b * n, x, y, h, w);
  float rhs = 0.f;
  if (m & kCont)
    rhs = (U[ub + i] - U[ub + i + 1]) + (U[vb + i] - U[vb + i + w]);
  mask_all[b * n + i] = m;
  rhs_all[b * n + i] = rhs;
}

// Flags of coarse cell (X, Y) (_coarsen_flags): OBSTACLE on the border
// ring and where all four children are; else the least non-obstacle child.
__device__ int coarse_flag(const int* ff, int X, int Y, int hf, int wf) {
  if (!interior(X, Y, hf / 2, wf / 2)) return kObstacle;
  int rep = INT_MAX;
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      int f = ff[(2 * Y + a) * wf + 2 * X + c];
      if (f != kObstacle) rep = min(rep, f);
    }
  return rep == INT_MAX ? kObstacle : rep;
}

__global__ void mg_coarsen(const int* __restrict__ flags_f_all,
                           int* __restrict__ flags_c_all,
                           uint8_t* __restrict__ mask_c_all, int hf, int wf) {
  int X = blockIdx.x * blockDim.x + threadIdx.x;
  int Y = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  int hc = hf / 2, wc = wf / 2;
  if (X >= wc || Y >= hc) return;
  const int* ff = flags_f_all + (size_t)b * hf * wf;
  int f = coarse_flag(ff, X, Y, hf, wf);
  uint8_t m = 0;
  if (interior(X, Y, hc, wc) && f != kObstacle) {
    m = kCont;
    if (coarse_flag(ff, X - 1, Y, hf, wf) == kObstacle) m |= kObXm;
    if (coarse_flag(ff, X + 1, Y, hf, wf) == kObstacle) m |= kObXp;
    if (coarse_flag(ff, X, Y - 1, hf, wf) == kObstacle) m |= kObYm;
    if (coarse_flag(ff, X, Y + 1, hf, wf) == kObstacle) m |= kObYp;
  }
  size_t j = (size_t)b * hc * wc + Y * wc + X;
  flags_c_all[j] = f;
  mask_c_all[j] = m;
}

// Per-block partial sums (field * cont, cont) of a level.
__global__ void __launch_bounds__(256)
    mg_partials(const float* __restrict__ field_all,
                const uint8_t* __restrict__ mask_all,
                float* __restrict__ parts_all, int h, int w) {
  __shared__ float sa[256], sc[256];
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  size_t j = blockIdx.z * (size_t)h * w + y * w + x;
  float a = 0.f, c = 0.f;
  if (x < w && y < h) {
    c = cont_f(mask_all[j]);
    a = field_all[j] * c;
  }
  store_partial(a, c, parts_all, sa, sc);
}

// out = (field - mean) * cont, the mean over continuation cells taken from
// the level's partials: the compatibility projection of a RHS
// (_remove_incompatible) and G's zero-mean gauge of p.
__global__ void __launch_bounds__(256)
    mg_project(const float* __restrict__ field_all,
               const uint8_t* __restrict__ mask_all,
               const float* __restrict__ parts_all, int nparts,
               float* __restrict__ out_all, int h, int w) {
  __shared__ float sa[256], sc[256];
  float mean = partials_mean(parts_all + 2 * blockIdx.z * nparts, nparts,
                             sa, sc);
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  size_t j = blockIdx.z * (size_t)h * w + y * w + x;
  out_all[j] = (field_all[j] - mean) * cont_f(mask_all[j]);
}

// Residual, border fold and child-sum restriction of fine level (h, w)
// into the coarse RHS, with the coarse level's per-block partial sums.
__global__ void __launch_bounds__(256)
    mg_restrict(const float* __restrict__ p_all,
                const float* __restrict__ rhsp_all,
                const uint8_t* __restrict__ mask_all, int h, int w,
                float* __restrict__ rhs_c_all,
                const uint8_t* __restrict__ mask_c_all,
                float* __restrict__ parts_all) {
  __shared__ float sa[256], sc[256];
  int X = blockIdx.x * blockDim.x + threadIdx.x;
  int Y = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  int hc = h / 2, wc = w / 2;
  float a = 0.f, c = 0.f;
  if (X < wc && Y < hc) {
    size_t n = (size_t)h * w;
    float r = restrict_cell(p_all + b * n, rhsp_all + b * n,
                            mask_all + b * n, X, Y, h, w);
    size_t jc = (size_t)b * hc * wc + Y * wc + X;
    rhs_c_all[jc] = r;
    c = cont_f(mask_c_all[jc]);
    a = r * c;
  }
  store_partial(a, c, parts_all, sa, sc);
}

// p += cont * prolong(neumann_extend(e_c)) on one 32x32 fine tile of level
// (h, w); e_c is the correction on level (h/2, w/2). The tile's coarse
// region (16x16 plus a 3-cell halo, indices wrapped as the plain
// version's rolls wrap) is extended in shared memory.
__global__ void __launch_bounds__(256)
    mg_prolong(const float* __restrict__ e_c_all,
               const uint8_t* __restrict__ mask_c_all,
               float* __restrict__ p_all,
               const uint8_t* __restrict__ mask_all, int h, int w) {
  __shared__ float e0[kPR * kPR], e1[kPR * kPR];
  __shared__ uint8_t l0[kPR * kPR], l1[kPR * kPR];
  const int tid = thread_rank(), nt = block_threads();
  const int b = blockIdx.z;
  const int hc = h / 2, wc = w / 2;
  const size_t nc = (size_t)hc * wc, n = (size_t)h * w;
  const int cy0 = blockIdx.y * (kPT / 2) - 3;
  const int cx0 = blockIdx.x * (kPT / 2) - 3;
  for (int t = tid; t < kPR * kPR; t += nt) {
    int ly = t / kPR, lx = t % kPR;
    size_t j = b * nc + wrap(cy0 + ly, hc) * wc + wrap(cx0 + lx, wc);
    uint8_t live = mask_c_all[j] & kCont;
    l0[t] = live;
    e0[t] = e_c_all[j] * (live ? 1.f : 0.f);
  }
  __syncthreads();
  for (int t = tid; t < (kPR - 2) * (kPR - 2); t += nt) {
    int c = (1 + t / (kPR - 2)) * kPR + 1 + t % (kPR - 2);
    e1[c] = extend_cell(e0, l0, c, c - 1, c + 1, c - kPR, c + kPR, l1);
  }
  __syncthreads();
  for (int t = tid; t < (kPR - 4) * (kPR - 4); t += nt) {
    int c = (2 + t / (kPR - 4)) * kPR + 2 + t % (kPR - 4);
    e0[c] = extend_cell(e1, l1, c, c - 1, c + 1, c - kPR, c + kPR, nullptr);
  }
  __syncthreads();
  for (int t = tid; t < kPT * kPT; t += nt) {
    int ty = t / kPT, tx = t % kPT;
    int y = blockIdx.y * kPT + ty, x = blockIdx.x * kPT + tx;
    if (y >= h || x >= w) continue;
    size_t i = b * n + (size_t)y * w + x;
    float v = 0.f;
    if (mask_all[i] & kCont) {
      int ly = (ty >> 1) + 3, lx = (tx >> 1) + 3;
      v = prolong_val(e0, kPR, ly, lx, (ty & 1) ? ly + 1 : ly - 1,
                      (tx & 1) ? lx + 1 : lx - 1);
    }
    p_all[i] = p_all[i] + v;
  }
}

// H's epilogue: the gauge, the velocity update and the free-slip walls.
__global__ void __launch_bounds__(256)
    mg_epilogue(const int* __restrict__ flags_all,
                const float* __restrict__ U, const float* __restrict__ p_all,
                const uint8_t* __restrict__ mask_all,
                const float* __restrict__ parts_all, int nparts,
                float* __restrict__ p_out_all, float* __restrict__ U_out,
                int h, int w) {
  __shared__ float sa[256], sc[256];
  int b = blockIdx.z;
  float mean = partials_mean(parts_all + 2 * b * nparts, nparts, sa, sc);
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  size_t n = (size_t)h * w;
  int i = y * w + x;
  const float* p = p_all + b * n;
  const uint8_t* mask = mask_all + b * n;
  auto pv = [p, mask, mean](int j) {
    return cont_f(mask[j]) * (p[j] - mean);
  };
  size_t ub = (size_t)b * 2 * n, vb = ub + n;
  p_out_all[b * n + i] = pv(i);
  float un, vn;
  update_and_walls(flags_all + b * n, pv, U[ub + i], U[vb + i], x, y, h, w,
                   &un, &vn);
  U_out[ub + i] = un;
  U_out[vb + i] = vn;
}

// ---- the single-block rest of the V-cycle ----

struct Small {
  int n;                              // levels, the first is the cut
  int h[kMaxLevels], w[kMaxLevels];
  const uint8_t* mask[kMaxLevels];    // (b, h, w) each
};

// Offsets into the dynamic shared memory: per level p and r (floats) and
// the mask (bytes); one float scratch field and two live-flag fields the
// size of the first level.
struct SmallLayout {
  int p[kMaxLevels], r[kMaxLevels], m[kMaxLevels];
  int scratch, live_a, live_b, bytes;
};

__host__ __device__ SmallLayout small_layout(const Small& L) {
  SmallLayout o;
  int f = 0;
  for (int j = 0; j < L.n; ++j) {
    o.p[j] = f;
    f += L.h[j] * L.w[j];
    o.r[j] = f;
    f += L.h[j] * L.w[j];
  }
  int n0 = L.h[0] * L.w[0];
  o.scratch = f;
  f += n0;
  int byte = 4 * f;
  for (int j = 0; j < L.n; ++j) {
    o.m[j] = byte;
    byte += L.h[j] * L.w[j];
  }
  o.live_a = byte;
  byte += n0;
  o.live_b = byte;
  byte += n0;
  o.bytes = (byte + 15) & ~15;
  return o;
}

__device__ void project_level(float* r, const uint8_t* m, int n, float* sa,
                              float* sc) {
  float a = 0.f, c = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float mf = cont_f(m[i]);
    a = a + r[i] * mf;
    c = c + mf;
  }
  block_sum2(a, c, sa, sc);
  float mean = a / fmaxf(c, 1.f);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    r[i] = (r[i] - mean) * cont_f(m[i]);
  __syncthreads();
}

// k sweeps on p in place (tmp: a scratch field of the level's size).
__device__ void smooth_level(float* p, float* tmp, const float* r,
                             const uint8_t* m, int h, int w, int k,
                             int damped, float keep, float damping) {
  int n = h * w;
  float* cur = p;
  float* nxt = tmp;
  for (int s = 0; s < k; ++s) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      nxt[i] = jacobi_cell(cur, i, w, m[i], r[i], damped, keep, damping);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (cur != p) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = cur[i];
    __syncthreads();
  }
}

// Both passes of _neumann_extend on a whole level, neighbours wrapped.
__device__ void extend_level(float* e, const uint8_t* m, float* tmp,
                             uint8_t* la, uint8_t* lb, int h, int w) {
  int n = h * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    la[i] = m[i] & kCont;
    e[i] = e[i] * (la[i] ? 1.f : 0.f);
  }
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    const float* src = pass ? tmp : e;
    float* dst = pass ? e : tmp;
    const uint8_t* live = pass ? lb : la;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int y = i / w, x = i - y * w;
      int row = y * w;
      dst[i] = extend_cell(src, live, i, row + wrap(x - 1, w),
                           row + wrap(x + 1, w), wrap(y - 1, h) * w + x,
                           wrap(y + 1, h) * w + x, pass ? nullptr : lb);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSmallThreads)
    mg_small(Small L, const float* __restrict__ p_in_all,
             const float* __restrict__ rhs_all, float* __restrict__ p_out_all,
             int pre, int post, int coarse, int damped, float keep,
             float damping) {
  extern __shared__ float4 smem4[];
  __shared__ float sa[kSmallThreads], sc[kSmallThreads];
  float* sf = reinterpret_cast<float*>(smem4);
  uint8_t* sb = reinterpret_cast<uint8_t*>(smem4);
  const SmallLayout o = small_layout(L);
  const int b = blockIdx.x;
  const int n0 = L.h[0] * L.w[0];
  float* scratch = sf + o.scratch;

  for (int j = 0; j < L.n; ++j) {
    int n = L.h[j] * L.w[j];
    const uint8_t* mg = L.mask[j] + (size_t)b * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) sb[o.m[j] + i] = mg[i];
  }
  for (int i = threadIdx.x; i < n0; i += blockDim.x) {
    sf[o.r[0] + i] = rhs_all[(size_t)b * n0 + i];
    sf[o.p[0] + i] = p_in_all ? p_in_all[(size_t)b * n0 + i] : 0.f;
  }
  __syncthreads();

  // Down: project, pre-smooth, restrict into a zero-started coarser level.
  for (int j = 0; j + 1 < L.n; ++j) {
    int h = L.h[j], w = L.w[j], hc = L.h[j + 1], wc = L.w[j + 1];
    float* p = sf + o.p[j];
    float* r = sf + o.r[j];
    const uint8_t* m = sb + o.m[j];
    project_level(r, m, h * w, sa, sc);
    smooth_level(p, scratch, r, m, h, w, pre, damped, keep, damping);
    for (int i = threadIdx.x; i < hc * wc; i += blockDim.x) {
      int Y = i / wc, X = i - Y * wc;
      sf[o.r[j + 1] + i] = restrict_cell(p, r, m, X, Y, h, w);
      sf[o.p[j + 1] + i] = 0.f;
    }
    __syncthreads();
  }
  {
    int j = L.n - 1;
    project_level(sf + o.r[j], sb + o.m[j], L.h[j] * L.w[j], sa, sc);
    smooth_level(sf + o.p[j], scratch, sf + o.r[j], sb + o.m[j], L.h[j],
                 L.w[j], coarse, damped, keep, damping);
  }
  // Up: extend the coarse correction, prolong it onto p, post-smooth.
  for (int j = L.n - 2; j >= 0; --j) {
    int h = L.h[j], w = L.w[j], hc = L.h[j + 1], wc = L.w[j + 1];
    float* e = sf + o.p[j + 1];
    float* p = sf + o.p[j];
    const uint8_t* m = sb + o.m[j];
    extend_level(e, sb + o.m[j + 1], scratch, sb + o.live_a, sb + o.live_b,
                 hc, wc);
    for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
      float v = 0.f;
      if (m[i] & kCont) {
        int y = i / w, x = i - y * w;
        int cy = y >> 1, cx = x >> 1;
        v = prolong_val(e, wc, cy, cx, wrap((y & 1) ? cy + 1 : cy - 1, hc),
                        wrap((x & 1) ? cx + 1 : cx - 1, wc));
      }
      p[i] = p[i] + v;
    }
    __syncthreads();
    smooth_level(p, scratch, sf + o.r[j], m, h, w, post, damped, keep,
                 damping);
  }
  for (int i = threadIdx.x; i < n0; i += blockDim.x)
    p_out_all[(size_t)b * n0 + i] = sf[o.p[0] + i];
}

}  // namespace

extern "C" int fn_mg_prologue(const int* flags, const float* U,
                              uint8_t* mask, float* rhs, int b, int h, int w,
                              void* stream) {
  dim3 block(32, 8);
  mg_prologue<<<fnk::grid2d(b, h, w, block), block, 0,
                (cudaStream_t)stream>>>(flags, U, mask, rhs, h, w);
  return fnk::launch_status();
}

extern "C" int fn_mg_coarsen(const int* flags_f, int* flags_c,
                             uint8_t* mask_c, int b, int hf, int wf,
                             void* stream) {
  dim3 block(32, 8);
  mg_coarsen<<<fnk::grid2d(b, hf / 2, wf / 2, block), block, 0,
               (cudaStream_t)stream>>>(flags_f, flags_c, mask_c, hf, wf);
  return fnk::launch_status();
}

// parts: b * nblk (sum, count) pairs, nblk = ceil(w/32) * ceil(h/8).
extern "C" int fn_mg_partials(const float* field, const uint8_t* mask,
                              float* parts, int b, int h, int w,
                              void* stream) {
  dim3 block(32, 8);
  mg_partials<<<fnk::grid2d(b, h, w, block), block, 0,
                (cudaStream_t)stream>>>(field, mask, parts, h, w);
  return fnk::launch_status();
}

extern "C" int fn_mg_project(const float* field, const uint8_t* mask,
                             const float* parts, int nparts, float* out,
                             int b, int h, int w, void* stream) {
  dim3 block(32, 8);
  mg_project<<<fnk::grid2d(b, h, w, block), block, 0,
               (cudaStream_t)stream>>>(field, mask, parts, nparts, out, h, w);
  return fnk::launch_status();
}

// parts: the coarse level's partials, nblk = ceil(w/64) * ceil(h/16).
extern "C" int fn_mg_restrict(const float* p, const float* rhsp,
                              const uint8_t* mask, float* rhs_c,
                              const uint8_t* mask_c, float* parts, int b,
                              int h, int w, void* stream) {
  dim3 block(32, 8);
  mg_restrict<<<fnk::grid2d(b, h / 2, w / 2, block), block, 0,
                (cudaStream_t)stream>>>(p, rhsp, mask, h, w, rhs_c, mask_c,
                                        parts);
  return fnk::launch_status();
}

extern "C" int fn_mg_prolong(const float* e_c, const uint8_t* mask_c,
                             float* p, const uint8_t* mask, int b, int h,
                             int w, void* stream) {
  dim3 block(32, 8);
  mg_prolong<<<fnk::grid2d(b, h, w, dim3(kPT, kPT)), block, 0,
               (cudaStream_t)stream>>>(e_c, mask_c, p, mask, h, w);
  return fnk::launch_status();
}

extern "C" int fn_mg_epilogue(const int* flags, const float* U,
                              const float* p, const uint8_t* mask,
                              const float* parts, int nparts, float* p_out,
                              float* U_out, int b, int h, int w,
                              void* stream) {
  dim3 block(32, 8);
  mg_epilogue<<<fnk::grid2d(b, h, w, block), block, 0,
                (cudaStream_t)stream>>>(flags, U, p, mask, parts, nparts,
                                        p_out, U_out, h, w);
  return fnk::launch_status();
}

// Index of the first of the n levels hs[j] x ws[j] whose remaining
// hierarchy fits the single-block launch's shared memory, or -1. Launches
// nothing.
extern "C" int fn_mg_cut_level(int n, const int* hs, const int* ws) {
  for (int j = 0; j < n; ++j) {
    if (n - j > kMaxLevels) continue;
    Small L;
    L.n = n - j;
    for (int i = j; i < n; ++i) {
      L.h[i - j] = hs[i];
      L.w[i - j] = ws[i];
    }
    if (small_layout(L).bytes <= kSmallBudget) return j;
  }
  return -1;
}

// The rest of a V-cycle from level hs[0] x ws[0] down, one block per
// sample: masks[j] is level j's mask, rhs the first level's RHS before
// its compatibility projection, p_in its start (null: zeros).
extern "C" int fn_mg_small(int n, const int* hs, const int* ws,
                           const void* const* masks, const float* p_in,
                           const float* rhs, float* p_out, int b, int pre,
                           int post, int coarse, int damped, float keep,
                           float damping, void* stream) {
  if (n < 1 || n > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Small L;
  L.n = n;
  for (int j = 0; j < n; ++j) {
    L.h[j] = hs[j];
    L.w[j] = ws[j];
    L.mask[j] = static_cast<const uint8_t*>(masks[j]);
  }
  int bytes = small_layout(L).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      mg_small, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  mg_small<<<b, kSmallThreads, bytes, (cudaStream_t)stream>>>(
      L, p_in, rhs, p_out, pre, post, coarse, damped, keep, damping);
  return fnk::launch_status();
}
