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
// one C call (fn_mg_solve, fn_mg_project) issues a short chain of fat
// launches on the caller's stream, with its scratch in one workspace:
//   * set-up: one launch builds level 0's mask bytes (and H's divergence
//     RHS) with the RHS's per-block partial sums, and the coarse flags of
//     levels 1-6 per 64^2 fine tile (a coarse flag depends only on its
//     children and its position); one more builds every coarse level's
//     mask bytes (a level below the sixth adds one launch);
//   * each level too large for the tail runs one down launch a V-cycle
//     (the compatibility projection, the pre-sweeps, the residual, the
//     border fold and the 2x2 child-sum restriction into the coarse RHS,
//     with the coarse RHS's per-block partials) and one up launch (Neumann
//     extension of the coarse correction, prolongation added onto p, the
//     post-sweeps) on square tiles with an even halo: kernel F's design, a
//     thread owning a column strip of 8 cells in registers, sweeps reading
//     x-neighbours and strip ends from shared memory, no index division.
//     Tiles are 64^2 where a level has enough of them to fill the card,
//     else 32^2 (more blocks, less work an SM: these launches are bound by
//     one SM's issue rate, not by the card's);
//   * the first level whose remaining hierarchy fits in one block's shared
//     memory (64^2 and below at 512^2; 128x32 and below at 512x128) runs
//     the rest of the V-cycle in one single-block launch per sample: each
//     level on a group of whole warps (a cell a thread; a named barrier or
//     __syncwarp for a group smaller than the block), sweeps ping-ponging p
//     with one scratch field (one barrier a sweep), each level's mean from
//     warp-shuffle sums that the stage writing its RHS leaves behind, the
//     stages out of line and their loops rolled (each runs once a launch:
//     a compact kernel keeps its code in the instruction cache);
//   * one epilogue: the zero-mean gauge (and H's velocity update and
//     walls).
// Means over a level come from per-block partial sums that the next launch
// adds in one fixed order, so a repeat gives the same bits. At 512^2 one
// V-cycle is 7 launches (2 V-cycles and the set-up: 17).
//
// The learned coarse solve (models/mg_coarse.py; JAX's mg_learned, which
// reaches no Pallas kernel) splits a V-cycle at a level `cut` above the
// tail's first level or at it, into two C calls that share one workspace:
// fn_mg_learned_down (set-up, the pre-sweeps and down launches of the
// levels above the cut, and one launch that writes the cut level's flags
// and its compatibility-projected RHS into the caller's tensors) and, once
// the caller's network has turned those into a correction e,
// fn_mg_learned_up (the post-sweeps at the cut level from e on that same
// RHS, the up launches, the gauge). A cut inside the tail is refused.
//
// The per-cell operators keep the plain version's float32 order (built
// with -fmad=false): the sweep is common.cuh::jacobi_cell/jacobi_update,
// the residual, _fold_border, the child sum (a + b) + (c + d),
// _neumann_extend's passes and the (3/4, 1/4) prolongation; indices wrap
// where the plain version's rolls wrap. The sums of the compatibility
// projections and the gauge run in another order than PyTorch's, so
// results agree with the plain version to rounding.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {
using namespace fnk;

constexpr int kMaxLevels = 16;

// ---- the per-level launches: square tiles with a halo ----
constexpr int kMaxSweeps = 8;    // sweeps a per-level launch runs
constexpr int kRY = 8;           // rows a thread owns
// The residual's ring around a down launch's output: the fold reads one
// cell further only next to the border ring, whose p every sweep pins to 0.
constexpr int kResidHalo = 1;
constexpr int kExtHalo = 3;      // coarse halo: prolongation 1, extension 2
// A level's launches take 64^2 tiles when its down launch has at least
// kWideBlocks of them (they fill the card), else 32^2 tiles.
constexpr int kWideBlocks = 96;
// The smallest output side of a tile (32^2, kMaxSweeps and the residual).
constexpr int kMinOut = 32 - 2 * (kMaxSweeps + kResidHalo);

// ---- set-up ----
constexpr int kSetupLevels = 6;               // coarse levels from one tile
constexpr int kSetupTile = 1 << kSetupLevels; // its side, fine cells

// ---- the single-block tail ----
constexpr int kTailThreads = 1024;
constexpr int kTailWarps = kTailThreads / 32;
constexpr int kLaneCells = 1;    // cells a thread, which sizes a level's group
// Dynamic shared memory the tail may take (a block may use 227 KB).
constexpr int kTailBudget = 160 * 1024;
constexpr uint8_t kLive1 = 32;   // mask bit: live after extension pass 1

__device__ __forceinline__ int thread_rank() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ float cont_f(uint8_t m) {
  return (m & kCont) ? 1.f : 0.f;
}

// v mod n in [0, n).
__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Sums of (a, c) over the warp in a fixed xor-tree order; every lane gets
// the same bits (each step adds the same two values in either order).
__device__ __forceinline__ void warp_sum2(float& a, float& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = a + __shfl_xor_sync(0xffffffffu, a, o);
    c = c + __shfl_xor_sync(0xffffffffu, c, o);
  }
}

// Sums of (a, c) over the block's nw warps: a warp tree, one barrier, then
// every thread adds the warps' sums in order. Every thread of the block
// calls it; a later call needs a barrier between (slots are reused).
__device__ float2 block_sum2(float a, float c, float2* slots, int nw) {
  warp_sum2(a, c);
  const int tid = thread_rank();
  if ((tid & 31) == 0) slots[tid >> 5] = make_float2(a, c);
  __syncthreads();
  a = 0.f;
  c = 0.f;
  for (int k = 0; k < nw; ++k) {
    a = a + slots[k].x;
    c = c + slots[k].y;
  }
  return make_float2(a, c);
}

// Mean sum/max(count, 1) of a level from its nparts per-block (sum, count)
// partials. Every block with the same thread count gets the same bits.
__device__ float partials_mean(const float* parts, int nparts, float2* slots) {
  const int nt = blockDim.x * blockDim.y;
  float a = 0.f, c = 0.f;
  for (int j = thread_rank(); j < nparts; j += nt) {
    a = a + parts[2 * j];
    c = c + parts[2 * j + 1];
  }
  float2 s = block_sum2(a, c, slots, nt >> 5);
  return s.x / fmaxf(s.y, 1.f);
}

// Thread 0 stores the block's partial (a, c) of sample blockIdx.z.
__device__ void store_partial(float a, float c, float* parts_all,
                              float2* slots) {
  float2 s = block_sum2(a, c, slots, (blockDim.x * blockDim.y) >> 5);
  if (thread_rank() == 0) {
    int nblk = gridDim.x * gridDim.y;
    int j = blockIdx.z * nblk + blockIdx.y * gridDim.x + blockIdx.x;
    parts_all[2 * j] = s.x;
    parts_all[2 * j + 1] = s.y;
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

// _fold_border of a residual field R at index li of cell (x, y) of a
// level (h, w), R's rows `stride` apart: the row step, then the column
// step.
__device__ __forceinline__ float fold_rows(const float* R, int li, int stride,
                                           int y, int h) {
  if (y == 1 || y == h - 2) return 0.f;
  float r = R[li];
  if (y == 2) r = r + R[li - stride];
  if (y == h - 3) r = r + R[li + stride];
  return r;
}

__device__ __forceinline__ float fold(const float* R, int li, int stride,
                                      int x, int y, int h, int w) {
  if (x == 1 || x == w - 2) return 0.f;
  float r = fold_rows(R, li, stride, y, h);
  if (x == 2) r = r + fold_rows(R, li - 1, stride, y, h);
  if (x == w - 3) r = r + fold_rows(R, li + 1, stride, y, h);
  return r;
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

// Flags of coarse cell (X, Y) of level (hc, wc) (_coarsen_flags) from its
// children at (2X, 2Y) of a field f with row stride s: OBSTACLE on the
// border ring and where all four children are; else the least
// non-obstacle child.
__device__ __forceinline__ int coarse_flag(const int* f, int s, int X, int Y,
                                           int x0, int y0, int hc, int wc) {
  if (!interior(X, Y, hc, wc)) return kObstacle;
  int rep = INT_MAX;
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      int v = f[(y0 + a) * s + x0 + c];
      if (v != kObstacle) rep = min(rep, v);
    }
  return rep == INT_MAX ? kObstacle : rep;
}

// ---- set-up ----

// Every level's shape, flags (level 0: the input) and mask bytes.
struct Levels {
  int n;
  int h[kMaxLevels], w[kMaxLevels];
  int* flags[kMaxLevels];
  uint8_t* mask[kMaxLevels];
};

// One 64^2 fine tile: level 0's mask bytes and RHS (H: the divergence of
// U; G: div as given) with the RHS's per-block partial sums, and the
// coarse flags of levels 1..min(n-1, 6) over the tile, each level reduced
// from the one before in shared memory.
template <bool kProject>
__global__ void __launch_bounds__(512)
    mg_setup(Levels L, const float* __restrict__ U,
             const float* __restrict__ rhs_in, float* __restrict__ rhs0_all,
             float* __restrict__ parts_all) {
  __shared__ int fl[2][(kSetupTile / 2) * (kSetupTile / 2)];
  __shared__ float2 slots[16];
  const int b = blockIdx.z, h = L.h[0], w = L.w[0];
  const size_t n = (size_t)h * w;
  const int* flags = L.flags[0] + b * n;
  const int x = blockIdx.x * kSetupTile + threadIdx.x;
  float a = 0.f, c = 0.f;
  for (int ty = threadIdx.y; ty < kSetupTile; ty += blockDim.y) {
    const int y = blockIdx.y * kSetupTile + ty;
    if (x >= w || y >= h) continue;
    const int i = y * w + x;
    const uint8_t m = cell_mask(flags, x, y, h, w);
    float rhs;
    if (kProject) {
      const size_t ub = (size_t)b * 2 * n, vb = ub + n;
      rhs = (m & kCont)
                ? (U[ub + i] - U[ub + i + 1]) + (U[vb + i] - U[vb + i + w])
                : 0.f;
      rhs0_all[b * n + i] = rhs;
    } else {
      rhs = rhs_in[b * n + i];
    }
    L.mask[0][b * n + i] = m;
    const float cf = cont_f(m);
    a = a + rhs * cf;
    c = c + cf;
  }
  store_partial(a, c, parts_all, slots);

  const int top = min(L.n - 1, kSetupLevels);
  for (int j = 1; j <= top; ++j) {
    const int side = kSetupTile >> j, hc = L.h[j], wc = L.w[j];
    const int X0 = blockIdx.x * side, Y0 = blockIdx.y * side;
    int* out = fl[j & 1];
    const int* prev = fl[(j - 1) & 1];
    const int lx = threadIdx.x, X = X0 + lx;
    for (int ly = threadIdx.y; lx < side && ly < side; ly += blockDim.y) {
      const int Y = Y0 + ly;
      if (X >= wc || Y >= hc) continue;
      const int f = j == 1 ? coarse_flag(flags, w, X, Y, 2 * X, 2 * Y, hc, wc)
                           : coarse_flag(prev, 2 * side, X, Y, 2 * lx, 2 * ly,
                                         hc, wc);
      out[ly * side + lx] = f;
      L.flags[j][(size_t)b * hc * wc + Y * wc + X] = f;
    }
    __syncthreads();
  }
}

// Coarse flags of one level below kSetupLevels, from the level above.
__global__ void mg_coarsen(const int* __restrict__ flags_f_all,
                           int* __restrict__ flags_c_all, int hf, int wf) {
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  const int Y = blockIdx.y * blockDim.y + threadIdx.y;
  const int hc = hf / 2, wc = wf / 2;
  if (X >= wc || Y >= hc) return;
  const size_t b = blockIdx.z;
  flags_c_all[b * hc * wc + Y * wc + X] = coarse_flag(
      flags_f_all + b * hf * wf, wf, X, Y, 2 * X, 2 * Y, hc, wc);
}

// Mask bytes of every coarse level: blockIdx.z = sample * (n-1) + level-1,
// the grid sized for level 1.
__global__ void mg_masks(Levels L) {
  const int nl = L.n - 1;
  const int j = 1 + blockIdx.z % nl, b = blockIdx.z / nl;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int h = L.h[j], w = L.w[j];
  if (x >= w || y >= h) return;
  const size_t off = (size_t)b * h * w;
  L.mask[j][off + y * w + x] = cell_mask(L.flags[j] + off, x, y, h, w);
}

// Per-block partial sums (p * cont, cont) of level 0 (p null: zeros): the
// gauge's sums when no V-cycle runs.
__global__ void __launch_bounds__(256)
    mg_partials(const float* __restrict__ p_all,
                const uint8_t* __restrict__ mask_all,
                float* __restrict__ parts_all, int h, int w) {
  __shared__ float2 slots[8];
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const size_t j = blockIdx.z * (size_t)h * w + y * w + x;
  float a = 0.f, c = 0.f;
  if (x < w && y < h) {
    c = cont_f(mask_all[j]);
    a = (p_all ? p_all[j] : 0.f) * c;
  }
  store_partial(a, c, parts_all, slots);
}

// The learned cut's inputs: level j's flags and its RHS less the level's
// mean over continuation cells (its per-block partials), times cont.
__global__ void __launch_bounds__(256)
    mg_cut_out(const int* __restrict__ flags_all,
               const float* __restrict__ rhs_all,
               const uint8_t* __restrict__ mask_all,
               const float* __restrict__ parts_all, int nparts,
               int* __restrict__ flags_out, float* __restrict__ rhs_out,
               int h, int w) {
  __shared__ float2 slots[8];
  const float mean =
      partials_mean(parts_all + 2 * blockIdx.z * nparts, nparts, slots);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t j = blockIdx.z * (size_t)h * w + y * w + x;
  flags_out[j] = flags_all[j];
  rhs_out[j] = (rhs_all[j] - mean) * cont_f(mask_all[j]);
}

// ---- the per-level launches ----

// A tile of T x T cells (T = 32 or 64): T/kRY rows of T threads, each
// owning a column strip of kRY cells; two copies of p with a row and a
// cell of padding at each end, so that the tile's edge cells read in
// bounds (values that are never exact); the up launch's coarse region
// (T/2 + 2 kExtHalo a side, two fields and two live-flag fields) after
// them.
template <int T>
struct Tile {
  static constexpr int kThreads = T * (T / kRY);
  static constexpr int kPad = T + 1;
  static constexpr int kCopy = T * T + 2 * kPad;
  static constexpr int kCR = T / 2 + 2 * kExtHalo;
  static constexpr int kDownSmem = 2 * kCopy * (int)sizeof(float);
  static constexpr int kUpSmem = kDownSmem + 2 * kCR * kCR * 5;
  static_assert(T % 32 == 0 && T % kRY == 0 && kRY % 2 == 0,
                "whole warps and even strips");
};

struct LevelArgs {
  const float* p_in;      // start of the level (null: zeros)
  const float* rhs;       // the level's RHS before its projection
  const float* parts;     // the RHS's per-block partials, nparts a sample
  int nparts;
  const uint8_t* mask;
  float* p_out;           // the output tiles' p
  int h, w, k, halo;      // level shape, sweeps, tile halo
  // Down launch: the coarse RHS (restriction) and its partials; else null.
  float* rhs_c;
  const uint8_t* mask_c;
  // Restriction: the coarse RHS's partials; else the partials of p * cont
  // over the output (the gauge's), or null.
  float* parts_out;
  // The output window: columns [lo, hi) of the level's arrays, written
  // into rows (hi - lo) wide (p_out; rhs_c half as wide). gx0, gw: the
  // level's first column is column gx0 of a grid gw wide (the border fold
  // reads global columns). The coarse arrays the launch reads (mask_c,
  // e_c) are wcp wide, the coarse cell of column x at column x / 2 +
  // offc. A whole grid: lo 0, hi w, gx0 0, gw w, wcp w / 2, offc 0.
  int lo, hi, gx0, gw, wcp, offc;
};

// A launch on a whole grid: its window and coarse arrays are the level's.
inline void whole_grid(LevelArgs& a) {
  a.lo = 0;
  a.hi = a.w;
  a.gx0 = 0;
  a.gw = a.w;
  a.wcp = a.w / 2;
  a.offc = 0;
}

// The strip of a thread: p (null: zeros) and the RHS of rows gy0 .. gy0 +
// kRY - 1 of column gx, with the mask bytes four to a word. Cells off the
// grid read 0. load_strip issues the loads; project_strip applies the
// compatibility projection once the level's mean is known (its partials
// are summed while the loads are in flight).
struct Strip {
  float cur[kRY], rhs[kRY];
  uint32_t mw[(kRY + 3) / 4];
  __device__ uint8_t m(int r) const {
    return (uint8_t)(mw[r / 4] >> (8 * (r % 4)));
  }
};

__device__ __forceinline__ void load_strip(Strip& S, const LevelArgs& L,
                                           size_t base, int gx, int gy0) {
  const bool col_in = gx >= 0 && gx < L.w;
#pragma unroll
  for (int q = 0; q < (kRY + 3) / 4; ++q) S.mw[q] = 0;
#pragma unroll
  for (int r = 0; r < kRY; ++r) {
    const int gy = gy0 + r;
    const bool in = col_in && gy >= 0 && gy < L.h;
    const size_t gi = base + (size_t)(in ? gy : 0) * L.w + (in ? gx : 0);
    const uint8_t m = in ? L.mask[gi] : 0;
    S.cur[r] = (in && L.p_in) ? L.p_in[gi] : 0.f;
    S.rhs[r] = in ? L.rhs[gi] : 0.f;
    S.mw[r / 4] |= (uint32_t)m << (8 * (r % 4));
  }
}

__device__ __forceinline__ void project_strip(Strip& S, float mean) {
#pragma unroll
  for (int r = 0; r < kRY; ++r) S.rhs[r] = (S.rhs[r] - mean) * cont_f(S.m(r));
}

// k sweeps of the strips (kernel F's loop): src holds the strips' p on
// entry. With keep_shared the last sweep's p is also left in src (behind
// a barrier); otherwise only in the registers.
template <int T, bool kDamped>
__device__ __forceinline__ void sweep_strips(Strip& S, float*& src,
                                             float*& dst, int li0, int k,
                                             bool keep_shared, float keep,
                                             float damping) {
  for (int s = 1; s <= k; ++s) {
    // Every shared-memory read of the sweep first, then the arithmetic,
    // then the stores (the compiler may not move a read above a store).
    float xm[kRY], xp[kRY];
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
      xm[r] = src[li0 + r * T - 1];
      xp[r] = src[li0 + r * T + 1];
    }
    float above = src[li0 - T];
    const float last = src[li0 + kRY * T];
    const bool store = s < k || keep_shared;
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
      const float pc = S.cur[r];
      const float below = r < kRY - 1 ? S.cur[r + 1] : last;
      S.cur[r] = jacobi_update(S.m(r), pc, xm[r], xp[r], above, below,
                               S.rhs[r], kDamped, keep, damping);
      above = pc;
    }
    if (!store) break;
#pragma unroll
    for (int r = 0; r < kRY; ++r) dst[li0 + r * T] = S.cur[r];
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
}

// Writes the output tile's p and, if asked, the block's partial of
// p * cont over it (every thread calls it).
template <int T>
__device__ __forceinline__ void store_output(const Strip& S,
                                             const LevelArgs& L, int lx,
                                             int ly0, int gx, int gy0,
                                             float2* slots) {
  float a = 0.f, c = 0.f;
  const int wo = L.hi - L.lo;
  const size_t base_o = blockIdx.z * (size_t)L.h * wo;
  const bool col_out = gx >= L.lo && gx < L.hi && lx >= L.halo &&
                       lx < T - L.halo;
#pragma unroll
  for (int r = 0; r < kRY; ++r) {
    const int ly = ly0 + r, gy = gy0 + r;
    if (col_out && ly >= L.halo && ly < T - L.halo && gy >= 0 && gy < L.h) {
      L.p_out[base_o + (size_t)gy * wo + gx - L.lo] = S.cur[r];
      const float cf = cont_f(S.m(r));
      a = a + S.cur[r] * cf;
      c = c + cf;
    }
  }
  if (L.parts_out) store_partial(a, c, L.parts_out, slots);
}

// The down launch of a level (rhs_c set) or a smoothing launch: the
// compatibility projection, k sweeps from p_in, and either the residual,
// border fold and child-sum restriction of the output tile into the coarse
// RHS with its partials, or the output p (with the gauge's partials).
// Exact where it is written if halo >= k + kResidHalo (restriction, halo
// even) or halo >= k (smoothing).
template <int T, bool kDamped>
__global__ void __launch_bounds__(Tile<T>::kThreads)
    mg_down(LevelArgs L, float keep, float damping) {
  using G = Tile<T>;
  extern __shared__ float smem[];
  __shared__ float2 slots[G::kThreads / 32];
  float* src = smem + G::kPad;
  float* dst = smem + G::kCopy + G::kPad;
  const int lx = threadIdx.x, ly0 = threadIdx.y * kRY;
  const int li0 = ly0 * T + lx;
  const int out = T - 2 * L.halo;
  const int gx = L.lo + blockIdx.x * out - L.halo + lx;
  const int gy0 = blockIdx.y * out - L.halo + ly0;
  const size_t base = blockIdx.z * (size_t)L.h * L.w;
  const bool restrict_ = L.rhs_c != nullptr;
  const int hc = L.h / 2, wo = L.hi - L.lo, wco = wo / 2;
  const size_t base_c = blockIdx.z * (size_t)hc * wco;
  const size_t base_mc = blockIdx.z * (size_t)hc * L.wcp;
  const bool col_out = gx >= L.lo && gx < L.hi && lx >= L.halo &&
                       lx < T - L.halo;
  // The column's place in the grid (the fold's rows and columns).
  const int gxg = wrap(gx + L.gx0, L.gw);

  Strip S;
  load_strip(S, L, base, gx, gy0);
  // The coarse cells' mask bytes: rows r, r+1 of an even lane's columns
  // lx, lx+1 (a down launch's halo and origin are even).
  uint8_t mc[kRY / 2];
#pragma unroll
  for (int q = 0; q < kRY / 2; ++q) {
    const int ly = ly0 + 2 * q, gy = gy0 + 2 * q;
    const bool out_c = restrict_ && col_out && !(lx & 1) && ly >= L.halo &&
                       ly < T - L.halo && gy >= 0 && gy < L.h;
    mc[q] = out_c ? L.mask_c[base_mc + (size_t)(gy >> 1) * L.wcp +
                             (gx >> 1) + L.offc]
                  : 0;
  }
  const float mean =
      partials_mean(L.parts + 2 * blockIdx.z * L.nparts, L.nparts, slots);
  project_strip(S, mean);
#pragma unroll
  for (int r = 0; r < kRY; ++r) src[li0 + r * T] = S.cur[r];
  __syncthreads();
  sweep_strips<T, kDamped>(S, src, dst, li0, L.k, restrict_, keep, damping);

  if (!restrict_) {
    store_output<T>(S, L, lx, ly0, gx, gy0, slots);
    return;
  }
  // The residual of every strip cell into dst (src holds p).
  {
    float xm[kRY], xp[kRY], res[kRY];
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
      xm[r] = src[li0 + r * T - 1];
      xp[r] = src[li0 + r * T + 1];
    }
    float above = src[li0 - T];
    const float last = src[li0 + kRY * T];
#pragma unroll
    for (int r = 0; r < kRY; ++r) {
      const float pc = S.cur[r];
      const float below = r < kRY - 1 ? S.cur[r + 1] : last;
      const uint8_t m = S.m(r);
      res[r] = 0.f;
      if (m & kCont) {
        float acc = 0.f;
        acc = acc + ((m & kObXm) ? pc : xm[r]);
        acc = acc + ((m & kObXp) ? pc : xp[r]);
        acc = acc + ((m & kObYm) ? pc : above);
        acc = acc + ((m & kObYp) ? pc : below);
        res[r] = S.rhs[r] - (4.f * pc - acc);
      }
      above = pc;
    }
#pragma unroll
    for (int r = 0; r < kRY; ++r) dst[li0 + r * T] = res[r];
  }
  __syncthreads();
  // Fold, then the 2x2 child sum of the output tile: rows r, r+1 of this
  // strip and columns lx, lx+1 (the next lane).
  float a = 0.f, c = 0.f;
#pragma unroll
  for (int r = 0; r < kRY; r += 2) {
    const int li = li0 + r * T, gy = gy0 + r;
    const float f00 = fold(dst, li, T, gxg, gy, L.h, L.gw);
    const float f01 = fold(dst, li + T, T, gxg, gy + 1, L.h, L.gw);
    const float f10 = __shfl_down_sync(0xffffffffu, f00, 1);
    const float f11 = __shfl_down_sync(0xffffffffu, f01, 1);
    const int ly = ly0 + r;
    if (col_out && !(lx & 1) && ly >= L.halo && ly < T - L.halo &&
        gy >= 0 && gy < L.h) {
      const float v = (f00 + f10) + (f01 + f11);
      const size_t jc = base_c + (size_t)(gy >> 1) * wco +
                        ((gx - L.lo) >> 1);
      L.rhs_c[jc] = v;
      const float cf = cont_f(mc[r / 2]);
      a = a + v * cf;
      c = c + cf;
    }
  }
  // The output tile's p.
  const size_t base_o = blockIdx.z * (size_t)L.h * wo;
#pragma unroll
  for (int r = 0; r < kRY; ++r) {
    const int ly = ly0 + r, gy = gy0 + r;
    if (col_out && ly >= L.halo && ly < T - L.halo && gy >= 0 && gy < L.h)
      L.p_out[base_o + (size_t)gy * wo + gx - L.lo] = S.cur[r];
  }
  store_partial(a, c, L.parts_out, slots);
}

// One _neumann_extend pass over the cells [lo, kCR - lo)^2 of a coarse
// region (lo = pass): column lx, rows ty, ty + ny, ...; reads first, then
// the arithmetic and the stores.
template <int kCR, int kRows>
__device__ __forceinline__ void extend_region(const float* e,
                                              const uint8_t* live, float* out,
                                              uint8_t* live_out, int lx,
                                              int ty, int ny, int lo) {
  float v[kRows][5];
  uint8_t l[kRows][5];
  const bool col = lx >= lo && lx < kCR - lo;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int cy = ty + q * ny;
    const int c = (col && cy >= lo && cy < kCR - lo) ? cy * kCR + lx
                                                    : kCR + 1;
    const int js[5] = {c, c - 1, c + 1, c - kCR, c + kCR};
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      v[q][t] = e[js[t]];
      l[q][t] = live[js[t]];
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int cy = ty + q * ny;
    if (!col || cy < lo || cy >= kCR - lo) continue;
    const float lxm = l[q][1], lxp = l[q][2], lym = l[q][3], lyp = l[q][4];
    float num = 0.f;
    num = num + v[q][1] * lxm;
    num = num + v[q][2] * lxp;
    num = num + v[q][3] * lym;
    num = num + v[q][4] * lyp;
    float den = 0.f;
    den = den + lxm;
    den = den + lxp;
    den = den + lym;
    den = den + lyp;
    const int c = cy * kCR + lx;
    if (live_out) live_out[c] = (l[q][0] || den > 0.5f) ? 1 : 0;
    out[c] = l[q][0] ? v[q][0] : num / fmaxf(den, 1.f);
  }
}

// The up launch of a level: both _neumann_extend passes over the tile's
// coarse region (kExtHalo coarse cells around it, indices wrapped as the
// plain version's rolls wrap), the prolongation added onto p_in on the
// continuation cells of the tile and its halo, k post-sweeps, the output
// tile's p (with the gauge's partials if asked). Exact where written if
// halo >= k (halo even).
template <int T, bool kDamped>
__global__ void __launch_bounds__(Tile<T>::kThreads)
    mg_up(LevelArgs L, const float* __restrict__ e_c_all,
          const uint8_t* __restrict__ mask_c_all, float keep, float damping) {
  using G = Tile<T>;
  constexpr int kCR = G::kCR;
  extern __shared__ float smem[];
  __shared__ float2 slots[G::kThreads / 32];
  float* src = smem + G::kPad;
  float* dst = smem + G::kCopy + G::kPad;
  float* e0 = smem + 2 * G::kCopy;
  float* e1 = e0 + kCR * kCR;
  uint8_t* l0 = reinterpret_cast<uint8_t*>(e1 + kCR * kCR);
  uint8_t* l1 = l0 + kCR * kCR;
  const int lx = threadIdx.x, ly0 = threadIdx.y * kRY;
  const int li0 = ly0 * T + lx;
  const int out = T - 2 * L.halo;
  const int ox = L.lo + blockIdx.x * out - L.halo;
  const int oy = blockIdx.y * out - L.halo;
  const int gx = ox + lx, gy0 = oy + ly0;
  const size_t base = blockIdx.z * (size_t)L.h * L.w;
  const int hc = L.h / 2;
  const size_t base_c = blockIdx.z * (size_t)hc * L.wcp;
  const int cx0 = ox / 2 - kExtHalo, cy0 = oy / 2 - kExtHalo;
  const int ny = blockDim.y;

  // The strip's loads, then the coarse region's (column lx, kCR < T; rows
  // ty, ty + ny, ...), all issued before the first store.
  Strip S;
  load_strip(S, L, base, gx, gy0);
  constexpr int kRows = (kCR + G::kThreads / T - 1) / (G::kThreads / T);
  {
    float ev[kRows];
    uint8_t lv[kRows];
    const int cxw = wrap(cx0 + lx + L.offc, L.wcp);
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int cy = threadIdx.y + q * ny;
      const bool in = lx < kCR && cy < kCR;
      const size_t j = base_c +
                       (size_t)wrap(cy0 + (in ? cy : 0), hc) * L.wcp + cxw;
      lv[q] = in ? (mask_c_all[j] & kCont) : 0;
      ev[q] = in ? e_c_all[j] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int cy = threadIdx.y + q * ny;
      if (lx < kCR && cy < kCR) {
        l0[cy * kCR + lx] = lv[q];
        e0[cy * kCR + lx] = ev[q] * (lv[q] ? 1.f : 0.f);
      }
    }
  }
  const float mean =
      partials_mean(L.parts + 2 * blockIdx.z * L.nparts, L.nparts, slots);
  project_strip(S, mean);
  extend_region<kCR, kRows>(e0, l0, e1, l1, lx, threadIdx.y, ny, 1);
  __syncthreads();
  extend_region<kCR, kRows>(e1, l1, e0, nullptr, lx, threadIdx.y, ny, 2);
  __syncthreads();

  const bool col_in = gx >= 0 && gx < L.w;
  const int lxc = (lx >> 1) + kExtHalo;
  const int lxc2 = (gx & 1) ? lxc + 1 : lxc - 1;
#pragma unroll
  for (int r = 0; r < kRY; ++r) {
    const int gy = gy0 + r;
    if (col_in && gy >= 0 && gy < L.h) {
      float v = 0.f;
      if (S.m(r) & kCont) {
        const int lyc = ((ly0 + r) >> 1) + kExtHalo;
        v = prolong_val(e0, kCR, lyc, lxc, (gy & 1) ? lyc + 1 : lyc - 1,
                        lxc2);
      }
      S.cur[r] = S.cur[r] + v;
    }
    src[li0 + r * T] = S.cur[r];
  }
  __syncthreads();
  sweep_strips<T, kDamped>(S, src, dst, li0, L.k, false, keep, damping);
  store_output<T>(S, L, lx, ly0, gx, gy0, slots);
}

// ---- the single-block rest of the V-cycle ----

// The tail's levels first .. n-1: shapes, offsets of p and r (floats) and
// of the mask bytes (live bits packed beside them) in the dynamic shared
// memory, each level's group of threads, the masks in device memory.
// Computed on the host; the kernel reads it from its parameters.
struct TailArgs {
  int first, n, bytes, scratch;
  int h[kMaxLevels], w[kMaxLevels], nt[kMaxLevels];
  int p[kMaxLevels], r[kMaxLevels], m[kMaxLevels];
  const uint8_t* mask[kMaxLevels];
};

// Threads of the group that runs a level of n cells: whole warps, about
// kLaneCells cells each, at most the block.
int group_threads(int n) {
  int t = ((n + kLaneCells - 1) / kLaneCells + 31) & ~31;
  return t > kTailThreads ? kTailThreads : t;
}

TailArgs tail_args(const Levels& L, int first) {
  TailArgs A{};
  A.first = first;
  A.n = L.n;
  int f = 0;
  for (int j = first; j < L.n; ++j) {
    const int n = L.h[j] * L.w[j];
    A.h[j] = L.h[j];
    A.w[j] = L.w[j];
    A.nt[j] = group_threads(n);
    A.mask[j] = L.mask[j];
    A.p[j] = f;
    A.r[j] = f + n;
    f += 2 * n;
  }
  A.scratch = f;
  f += L.h[first] * L.w[first];
  int byte = 4 * f;
  for (int j = first; j < L.n; ++j) {
    A.m[j] = byte;
    byte += (L.h[j] * L.w[j] + 3) & ~3;
  }
  A.bytes = (byte + 15) & ~15;
  return A;
}

// The tail's dynamic shared memory and its reduction slots. The stages
// below are out-of-line functions that address it by offsets: each runs
// once or a few times a launch, and a compact kernel keeps its code in
// the instruction cache.
extern __shared__ float4 tail_smem[];
__shared__ float2 tail_slots[kTailWarps];

__device__ __forceinline__ float* tf() {
  return reinterpret_cast<float*>(tail_smem);
}
__device__ __forceinline__ uint8_t* tb() {
  return reinterpret_cast<uint8_t*>(tail_smem);
}

// One level of the tail: offsets of p, r and the mask bytes, its shape,
// cell count and group size.
struct Lvl {
  int p, r, m, h, w, n, nt;
};

__device__ __forceinline__ Lvl tail_level(const TailArgs& A, int j) {
  return Lvl{A.p[j], A.r[j], A.m[j], A.h[j], A.w[j], A.h[j] * A.w[j],
             A.nt[j]};
}

// A barrier over the group of threads 0 .. nt-1 (only they call it).
__device__ __forceinline__ void group_sync(int nt) {
  if (nt >= kTailThreads) {
    __syncthreads();
  } else if (nt <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
  }
}

// The cells thread tid owns of a level of width w run by nt threads: tid,
// tid + nt, ... walked with their (x, y) and no division per cell.
struct Walk {
  int i, x, y, dx, dy, step;
  __device__ Walk(int tid, int w, int nt) {
    i = tid;
    y = tid / w;
    x = tid - y * w;
    step = nt;
    dy = nt / w;
    dx = nt - dy * w;
  }
  __device__ void next(int w) {
    i += step;
    x += dx;
    y += dy;
    if (x >= w) {
      x -= w;
      ++y;
    }
  }
};

// v - 1 or v + 1 wrapped into [0, n).
__device__ __forceinline__ int wrap1(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// Sum over the group of (a, c): warp trees, one group barrier, the warps'
// sums in order. The group's threads call it; the slots are free to
// write (a barrier separates two calls).
__device__ __noinline__ float2 group_sum2(float a, float c, int tid, int nt) {
  warp_sum2(a, c);
  if ((tid & 31) == 0) tail_slots[tid >> 5] = make_float2(a, c);
  group_sync(nt);
  a = 0.f;
  c = 0.f;
  for (int k = 0; k < (nt >> 5); ++k) {
    a = a + tail_slots[k].x;
    c = c + tail_slots[k].y;
  }
  return make_float2(a, c);
}

// The warps' sums of (a, c) into the slots (every lane of the warps of
// the stage calls it; a barrier follows before they are read).
__device__ __forceinline__ void warp_partial(float a, float c, int tid) {
  warp_sum2(a, c);
  if ((tid & 31) == 0) tail_slots[tid >> 5] = make_float2(a, c);
}

// The compatibility projection of the level's RHS on the thread's cells,
// its mean from the nw warps' sums of (RHS * cont, cont) that the stage
// writing the RHS left in the slots (the sweeps read only their own
// cells' RHS; the restriction reads others' after a barrier).
__device__ __noinline__ void tail_project(Lvl L, int nw, int tid) {
  float* r = tf() + L.r;
  const uint8_t* m = tb() + L.m;
  float a = 0.f, c = 0.f;
  for (int k = 0; k < nw; ++k) {
    a = a + tail_slots[k].x;
    c = c + tail_slots[k].y;
  }
  const float mean = a / fmaxf(c, 1.f);
  for (int i = tid; i < L.n; i += L.nt) r[i] = (r[i] - mean) * cont_f(m[i]);
}

// k sweeps of the level, ping-ponging p and the scratch field (one group
// barrier a sweep); an odd k copies the result back.
__device__ __noinline__ void tail_smooth(Lvl L, int scratch, int tid, int k,
                                         int damped, float keep,
                                         float damping) {
  const float* r = tf() + L.r;
  const uint8_t* m = tb() + L.m;
  float* cur = tf() + L.p;
  float* nxt = tf() + scratch;
  for (int s = 0; s < k; ++s) {
    for (int i = tid; i < L.n; i += L.nt)
      nxt[i] = jacobi_cell(cur, i, L.w, m[i], r[i], damped, keep, damping);
    group_sync(L.nt);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (k & 1) {
    for (int i = tid; i < L.n; i += L.nt) nxt[i] = cur[i];
    group_sync(L.nt);
  }
}

// The restriction of level F's residual into level C's RHS on the cells
// of C the thread owns (F's group), C's p set to 0, and the warps' sums of
// (RHS * cont, cont) of C into the slots. The residual of F's cells goes
// through the scratch field first.
__device__ __noinline__ void tail_restrict(Lvl F, Lvl C, int scratch,
                                           int tid) {
  const float* p = tf() + F.p;
  const float* r = tf() + F.r;
  const uint8_t* m = tb() + F.m;
  float* R = tf() + scratch;
  for (int i = tid; i < F.n; i += F.nt) R[i] = resid(p, r, m, i, F.w);
  group_sync(F.nt);
  float* rc = tf() + C.r;
  float* pc = tf() + C.p;
  const uint8_t* mc = tb() + C.m;
  float a = 0.f, c = 0.f;
  Walk q(tid, C.w, F.nt);
#pragma unroll 1
  for (; q.i < C.n; q.next(C.w)) {
    const int x = 2 * q.x, y = 2 * q.y, i = y * F.w + x;
    const float v = (fold(R, i, F.w, x, y, F.h, F.w) +
                     fold(R, i + 1, F.w, x + 1, y, F.h, F.w)) +
                    (fold(R, i + F.w, F.w, x, y + 1, F.h, F.w) +
                     fold(R, i + F.w + 1, F.w, x + 1, y + 1, F.h, F.w));
    rc[q.i] = v;
    pc[q.i] = 0.f;
    const float cf = cont_f(mc[q.i]);
    a = a + v * cf;
    c = c + cf;
  }
  warp_partial(a, c, tid);
}

// One _neumann_extend pass over the whole level, neighbours wrapped. Pass
// 0 reads e = p times the cont bits and writes into r (free once the
// level's post-sweeps are done) with the live bits kLive1; pass 1 reads
// them and writes p.
__device__ __noinline__ void tail_extend(Lvl L, int tid, int pass) {
  const float* e = tf() + (pass ? L.r : L.p);
  float* out = tf() + (pass ? L.p : L.r);
  uint8_t* m = tb() + L.m;
  const uint8_t bit = pass ? kLive1 : kCont;
  Walk c(tid, L.w, L.nt);
#pragma unroll 1
  for (; c.i < L.n; c.next(L.w)) {
    const int row = c.y * L.w;
    const int jxm = row + wrap1(c.x - 1, L.w);
    const int jxp = row + wrap1(c.x + 1, L.w);
    const int jym = wrap1(c.y - 1, L.h) * L.w + c.x;
    const int jyp = wrap1(c.y + 1, L.h) * L.w + c.x;
    const float lxm = (m[jxm] & bit) ? 1.f : 0.f;
    const float lxp = (m[jxp] & bit) ? 1.f : 0.f;
    const float lym = (m[jym] & bit) ? 1.f : 0.f;
    const float lyp = (m[jyp] & bit) ? 1.f : 0.f;
    // Pass 0 reads e * live, the plain version's e = e * live.
    const float exm = pass ? e[jxm] : e[jxm] * lxm;
    const float exp_ = pass ? e[jxp] : e[jxp] * lxp;
    const float eym = pass ? e[jym] : e[jym] * lym;
    const float eyp = pass ? e[jyp] : e[jyp] * lyp;
    float num = 0.f;
    num = num + exm * lxm;
    num = num + exp_ * lxp;
    num = num + eym * lym;
    num = num + eyp * lyp;
    float den = 0.f;
    den = den + lxm;
    den = den + lxp;
    den = den + lym;
    den = den + lyp;
    const bool live = m[c.i] & bit;
    out[c.i] = live ? e[c.i] : num / fmaxf(den, 1.f);
    if (!pass)
      m[c.i] = (m[c.i] & ~kLive1) | ((live || den > 0.5f) ? kLive1 : 0);
  }
  group_sync(L.nt);
}

// p += cont * prolong(e) on level F's cells the thread owns, e level C's
// extended correction.
__device__ __noinline__ void tail_prolong(Lvl F, Lvl C, int tid) {
  float* p = tf() + F.p;
  const float* e = tf() + C.p;
  const uint8_t* m = tb() + F.m;
  Walk c(tid, F.w, F.nt);
#pragma unroll 1
  for (; c.i < F.n; c.next(F.w)) {
    if (!(m[c.i] & kCont)) continue;
    const int cy = c.y >> 1, cx = c.x >> 1;
    p[c.i] = p[c.i] + prolong_val(e, C.w, cy, cx,
                                  wrap1((c.y & 1) ? cy + 1 : cy - 1, C.h),
                                  wrap1((c.x & 1) ? cx + 1 : cx - 1, C.w));
  }
}

__global__ void __launch_bounds__(kTailThreads)
    mg_tail(TailArgs A, const float* __restrict__ p_in_all,
            const float* __restrict__ rhs_all, float* __restrict__ p_out_all,
            float* __restrict__ gauge_all, int pre, int post, int coarse,
            int damped, float keep, float damping) {
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int j = A.first; j < A.n; ++j) {
    const Lvl L = tail_level(A, j);
    // Mask bytes four at a time (the workspace aligns each level).
    const uint8_t* mg = A.mask[j] + (size_t)b * L.n;
    if ((L.n & 3) == 0) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(mg);
      uint32_t* dst = reinterpret_cast<uint32_t*>(tb() + L.m);
      for (int i = tid; i < L.n / 4; i += kTailThreads) dst[i] = src[i];
    } else {
      for (int i = tid; i < L.n; i += kTailThreads) tb()[L.m + i] = mg[i];
    }
  }
  const Lvl top = tail_level(A, A.first);
  {
    float a = 0.f, c = 0.f;
    for (int i = tid; i < top.n; i += kTailThreads) {
      const float v = rhs_all[(size_t)b * top.n + i];
      tf()[top.r + i] = v;
      tf()[top.p + i] = p_in_all ? p_in_all[(size_t)b * top.n + i] : 0.f;
      const float cf = cont_f(A.mask[A.first][(size_t)b * top.n + i]);
      a = a + v * cf;
      c = c + cf;
    }
    warp_partial(a, c, tid);
  }
  __syncthreads();

  // Down: project, pre-smooth, restrict into a zero-started coarser level.
  // nw: the warps whose sums of the level's RHS are in the slots.
  int nw = kTailWarps;
  for (int j = A.first; j + 1 < A.n; ++j) {
    const Lvl F = tail_level(A, j);
    if (tid < F.nt) {
      tail_project(F, nw, tid);
      tail_smooth(F, A.scratch, tid, pre, damped, keep, damping);
      if (pre == 0) group_sync(F.nt);
      tail_restrict(F, tail_level(A, j + 1), A.scratch, tid);
    }
    nw = F.nt >> 5;
    __syncthreads();
  }
  {
    const Lvl C = tail_level(A, A.n - 1);
    if (tid < C.nt) {
      tail_project(C, nw, tid);
      tail_smooth(C, A.scratch, tid, coarse, damped, keep, damping);
    }
  }
  // Up: extend the coarse correction, prolong it onto p, post-smooth.
  for (int j = A.n - 2; j >= A.first; --j) {
    const Lvl F = tail_level(A, j);
    const Lvl C = tail_level(A, j + 1);
    if (tid < C.nt) {
      tail_extend(C, tid, 0);
      tail_extend(C, tid, 1);
    }
    __syncthreads();
    if (tid < F.nt) {
      tail_prolong(F, C, tid);
      group_sync(F.nt);
      tail_smooth(F, A.scratch, tid, post, damped, keep, damping);
    }
    __syncthreads();
  }
  __syncthreads();
  if (tid < top.nt) {
    float a = 0.f, c = 0.f;
    for (int i = tid; i < top.n; i += top.nt) {
      const float v = tf()[top.p + i];
      p_out_all[(size_t)b * top.n + i] = v;
      const float cf = cont_f(tb()[top.m + i]);
      a = a + v * cf;
      c = c + cf;
    }
    if (gauge_all) {
      const float2 s = group_sum2(a, c, tid, top.nt);
      if (tid == 0) {
        gauge_all[2 * b] = s.x;
        gauge_all[2 * b + 1] = s.y;
      }
    }
  }
}

// ---- epilogues ----

// G's zero-mean gauge: out = (p - mean) * cont (p null: zeros).
__global__ void __launch_bounds__(256)
    mg_gauge(const float* __restrict__ p_all,
             const uint8_t* __restrict__ mask_all,
             const float* __restrict__ parts_all, int nparts,
             float* __restrict__ out_all, int h, int w) {
  __shared__ float2 slots[8];
  const float mean =
      partials_mean(parts_all + 2 * blockIdx.z * nparts, nparts, slots);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t j = blockIdx.z * (size_t)h * w + y * w + x;
  out_all[j] = ((p_all ? p_all[j] : 0.f) - mean) * cont_f(mask_all[j]);
}

// H's epilogue: the gauge, the velocity update and the free-slip walls.
__global__ void __launch_bounds__(256)
    mg_epilogue(const int* __restrict__ flags_all,
                const float* __restrict__ U, const float* __restrict__ p_all,
                const uint8_t* __restrict__ mask_all,
                const float* __restrict__ parts_all, int nparts,
                float* __restrict__ p_out_all, float* __restrict__ U_out,
                int h, int w) {
  __shared__ float2 slots[8];
  const int b = blockIdx.z;
  const float mean = partials_mean(parts_all + 2 * b * nparts, nparts, slots);
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t n = (size_t)h * w;
  const int i = y * w + x;
  const float* p = p_all ? p_all + b * n : nullptr;
  const uint8_t* mask = mask_all + b * n;
  auto pv = [p, mask, mean](int j) {
    return cont_f(mask[j]) * ((p ? p[j] : 0.f) - mean);
  };
  const size_t ub = (size_t)b * 2 * n, vb = ub + n;
  p_out_all[b * n + i] = pv(i);
  float un, vn;
  update_and_walls(flags_all + b * n, pv, U[ub + i], U[vb + i], x, y, h, w,
                   &un, &vn);
  U_out[ub + i] = un;
  U_out[vb + i] = vn;
}

// ---- the width-sharded levels (parallel/multigrid.py) ----
//
// A slab of a level is its columns gx0 .. gx0 + w - 1 of a grid gw wide,
// taken mod gw: a halo past a domain edge holds the other edge's columns,
// as the plain version's rolls wrap there. The set-up kernels below build
// a slab's flags and mask bytes with the border ring at the grid's
// columns; mg_down and mg_up run one level's launch on a slab with their
// window and fold at the grid's columns (LevelArgs); the epilogue runs
// the gauge (and H's velocity update and walls) on a window.

// Coarse flags of a slab (hf, wf) whose first coarse column is the coarse
// grid's column gx0c of gwc: _coarsen_flags with the ring at the grid's
// columns.
__global__ void mg_slab_coarsen(const int* __restrict__ flags_f_all,
                                int* __restrict__ flags_c_all, int hf, int wf,
                                int gx0c, int gwc) {
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  const int Y = blockIdx.y * blockDim.y + threadIdx.y;
  const int hc = hf / 2, wc = wf / 2;
  if (X >= wc || Y >= hc) return;
  const size_t b = blockIdx.z;
  flags_c_all[b * hc * wc + Y * wc + X] =
      coarse_flag(flags_f_all + b * hf * wf, wf, wrap(gx0c + X, gwc), Y,
                  2 * X, 2 * Y, hc, gwc);
}

// Mask bytes of a slab: continuation by the grid's border ring, obstacle
// neighbours within the slab (none read past its first or last column).
__global__ void mg_slab_mask(const int* __restrict__ flags_all,
                             uint8_t* __restrict__ mask_all, int h, int w,
                             int gx0, int gw) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t n = (size_t)h * w;
  const int* f = flags_all + blockIdx.z * n;
  const int i = y * w + x;
  uint8_t m = 0;
  if (interior(wrap(gx0 + x, gw), y, h, gw) && f[i] != kObstacle) {
    m = kCont;
    if (x > 0 && f[i - 1] == kObstacle) m |= kObXm;
    if (x < w - 1 && f[i + 1] == kObstacle) m |= kObXp;
    if (f[i - w] == kObstacle) m |= kObYm;
    if (f[i + w] == kObstacle) m |= kObYp;
  }
  mask_all[blockIdx.z * n + i] = m;
}

// Per-block partial sums (x * cont, cont) over the window's columns
// [lo, hi) of a slab (h, w): 32 x 8 cells a block.
__global__ void __launch_bounds__(256)
    mg_slab_partials(const float* __restrict__ x_all,
                     const uint8_t* __restrict__ mask_all,
                     float* __restrict__ parts_all, int h, int w, int lo,
                     int hi) {
  __shared__ float2 slots[8];
  const int x = lo + blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  float a = 0.f, c = 0.f;
  if (x < hi && y < h) {
    const size_t j = blockIdx.z * (size_t)h * w + y * w + x;
    c = cont_f(mask_all[j]);
    a = x_all[j] * c;
  }
  store_partial(a, c, parts_all, slots);
}

// update_and_walls of cell i of a slab: `inner` says whether the cell is
// inside the grid's border ring; the walls' left neighbour is clamped at
// the slab's first column (a slab that starts inside the grid holds the
// cell to the left of every cell it writes).
template <class P>
__device__ __forceinline__ void slab_update_walls(const int* flags, P pv,
                                                  float u, float v, int i,
                                                  int x, int y, bool inner,
                                                  int w, float* u_out,
                                                  float* v_out) {
  const int f = flags[i];
  const bool fl = f == kFluid, em = f == kEmpty, ob = f == kObstacle;
  float un = u, vn = v;
  if (inner) {
    const int fx = flags[i - 1], fy = flags[i - w];
    const bool flx = fx == kFluid, emx = fx == kEmpty;
    const bool fly = fy == kFluid, emy = fy == kEmpty;
    const float pc = pv(i, x), px = pv(i - 1, x - 1), py = pv(i - w, x);
    un = (fl && flx) ? u - (pc - px)
         : (fl && emx) ? u - pc
         : (em && flx) ? u + px : 0.f;
    vn = (fl && fly) ? v - (pc - py)
         : (fl && emy) ? v - pc
         : (em && fly) ? v + py : 0.f;
  }
  const int fxc = x > 0 ? flags[i - 1] : f;
  const int fyc = y > 0 ? flags[i - w] : f;
  const bool contw = fl || ob;
  const bool kill_u = contw && (fxc == kObstacle || (ob && fxc == kFluid));
  const bool kill_v = contw && (fyc == kObstacle || (ob && fyc == kFluid));
  *u_out = kill_u ? 0.f : un;
  *v_out = kill_v ? 0.f : vn;
}

// The gauge of a slab's window, (p - mean) * cont with the mean of the
// grid's sums (sum, count) a sample, into p_out (rows hi - lo wide); with
// U also H's velocity update and free-slip walls into U_out. cont is the
// grid's: the border ring at columns gx0 + x.
__global__ void __launch_bounds__(256)
    mg_slab_epilogue(const int* __restrict__ flags_all,
                     const float* __restrict__ U,
                     const float* __restrict__ p_all,
                     const float* __restrict__ sums,
                     float* __restrict__ p_out_all, float* __restrict__ U_out,
                     int h, int w, int gx0, int gw, int lo, int hi) {
  const int b = blockIdx.z;
  const float mean = sums[2 * b] / fmaxf(sums[2 * b + 1], 1.f);
  const int x = lo + blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= hi || y >= h) return;
  const size_t n = (size_t)h * w;
  const int wo = hi - lo;
  const size_t no = (size_t)h * wo;
  const int i = y * w + x;
  const int* flags = flags_all + b * n;
  const float* p = p_all + b * n;
  auto cont = [flags, h, gx0, gw, w](int j, int xj) {
    return (interior(wrap(gx0 + xj, gw), j / w, h, gw) &&
            flags[j] != kObstacle)
               ? 1.f : 0.f;
  };
  auto pg = [p, mean, cont](int j, int xj) {
    return cont(j, xj) * (p[j] - mean);
  };
  p_out_all[b * no + (size_t)y * wo + x - lo] = pg(i, x);
  if (!U) return;
  const size_t ub = (size_t)b * 2 * n, vb = ub + n;
  const size_t uo = (size_t)b * 2 * no, vo = uo + no;
  const bool inner = x > 0 && interior(wrap(gx0 + x, gw), y, h, gw);
  float un, vn;
  slab_update_walls(flags, pg, U[ub + i], U[vb + i], i, x, y, inner, w, &un,
                    &vn);
  U_out[uo + (size_t)y * wo + x - lo] = un;
  U_out[vo + (size_t)y * wo + x - lo] = vn;
}

// ---- the plan of one call, computed on the host ----

// Levels of (h, w) (ops/multigrid.py::level_shapes): halve while both
// sides are even and the halved smaller side is at least min_size. False
// if there are more than kMaxLevels.
bool level_shapes(int h, int w, int min_size, Levels* L) {
  L->n = 1;
  L->h[0] = h;
  L->w[0] = w;
  for (;;) {
    const int hh = L->h[L->n - 1], ww = L->w[L->n - 1];
    if (hh % 2 || ww % 2 || min(hh, ww) / 2 < min_size) return true;
    if (L->n == kMaxLevels) return false;
    L->h[L->n] = hh / 2;
    L->w[L->n] = ww / 2;
    ++L->n;
  }
}

// The first level whose remaining hierarchy fits the tail's shared
// memory; L.n if none does.
int tail_cut(const Levels& L) {
  for (int j = 0; j < L.n; ++j)
    if (tail_args(L, j).bytes <= kTailBudget) return j;
  return L.n;
}

int tiles(int n, int out) { return (n + out - 1) / out; }

// Upper bound of the per-block partials of a level (the smallest tile
// output of any launch).
int max_parts(int h, int w) { return tiles(h, kMinOut) * tiles(w, kMinOut); }

struct Workspace {
  size_t flags[kMaxLevels], mask[kMaxLevels], rhs[kMaxLevels];
  size_t pa[kMaxLevels], pb[kMaxLevels], parts[kMaxLevels], gauge;
  size_t bytes;
};

// Offsets of the call's scratch: coarse flags and masks of every level;
// the RHS (level 0 only for H), two p buffers and the RHS partials of
// every level down to the tail's; the gauge's partials.
Workspace workspace(const Levels& L, int cut, int b, bool project) {
  Workspace o{};
  size_t at = 0;
  auto take = [&at](size_t nbytes) {
    size_t off = at;
    at += (nbytes + 255) & ~(size_t)255;
    return off;
  };
  for (int j = 0; j < L.n; ++j) {
    const size_t n = (size_t)b * L.h[j] * L.w[j];
    if (j > 0) o.flags[j] = take(4 * n);
    o.mask[j] = take(n);
    if (j > cut) continue;
    if (j > 0 || project) o.rhs[j] = take(4 * n);
    o.pa[j] = take(4 * n);
    o.pb[j] = take(4 * n);
    o.parts[j] = take((size_t)8 * b * max_parts(L.h[j], L.w[j]));
  }
  o.gauge = take((size_t)8 * b * max_parts(L.h[0], L.w[0]));
  o.bytes = at;
  return o;
}

struct Problem {
  int b, h, w, min_size, n_vcycles, pre, post, coarse, damped;
  float keep, damping;
};

bool bad_problem(const Problem& P) {
  return P.b < 1 || P.h < 3 || P.w < 3 || P.n_vcycles < 0 || P.pre < 0 ||
         P.post < 0 || P.coarse < 0;
}

template <int T>
int launch_down(dim3 grid, const LevelArgs& a, const Problem& P,
                cudaStream_t s) {
  dim3 block(T, T / kRY);
  constexpr int smem = Tile<T>::kDownSmem;
  static_assert(smem <= 48 * 1024, "no opt-in shared memory");
  if (P.damped)
    mg_down<T, true><<<grid, block, smem, s>>>(a, P.keep, P.damping);
  else
    mg_down<T, false><<<grid, block, smem, s>>>(a, P.keep, P.damping);
  return 0;
}

// Opts the up launches into their shared memory once a process.
template <int T>
int up_smem_status() {
  static const int status = [] {
    constexpr int smem = Tile<T>::kUpSmem;
    if (smem <= 48 * 1024) return 0;
    cudaError_t e = cudaFuncSetAttribute(
        mg_up<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mg_up<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    return static_cast<int>(e);
  }();
  return status;
}

template <int T>
int launch_up(dim3 grid, const LevelArgs& a, const float* e_c,
              const uint8_t* mask_c, const Problem& P, cudaStream_t s) {
  const int status = up_smem_status<T>();
  if (status) return status;
  dim3 block(T, T / kRY);
  constexpr int smem = Tile<T>::kUpSmem;
  if (P.damped)
    mg_up<T, true><<<grid, block, smem, s>>>(a, e_c, mask_c, P.keep,
                                            P.damping);
  else
    mg_up<T, false><<<grid, block, smem, s>>>(a, e_c, mask_c, P.keep,
                                             P.damping);
  return 0;
}

// One solve: with issue false it only counts the launches it would make.
class Solve {
 public:
  Solve(const Problem& P, bool project, char* work, const int* flags,
        const float* rhs_in, const float* U, const float* p0,
        cudaStream_t s, bool issue)
      : P_(P), project_(project), work_(work), flags_(flags),
        rhs_in_(rhs_in), U_(U), p0_(p0), s_(s), issue_(issue) {
    ok_ = !bad_problem(P) && level_shapes(P.h, P.w, P.min_size, &L_);
    if (!ok_) return;
    cut_ = tail_cut(L_);
    W_ = workspace(L_, cut_, P.b, project);
    for (int j = 0; j < L_.n; ++j) {
      L_.flags[j] = j ? reinterpret_cast<int*>(work_ + W_.flags[j])
                      : const_cast<int*>(flags_);
      L_.mask[j] = reinterpret_cast<uint8_t*>(work_ + W_.mask[j]);
    }
  }

  bool ok() const { return ok_; }
  int launches() const { return launches_; }
  int status() const { return status_; }
  size_t bytes() const { return W_.bytes; }
  int cut() const { return cut_; }

  // Set-up, the V-cycles, the gauge; G's output in out, H's in out and
  // U_out.
  void run(float* out, float* U_out) {
    setup(true);
    const float* p = p0_;
    for (int v = 0; v < P_.n_vcycles; ++v)
      p = vcycle(p, v + 1 == P_.n_vcycles);
    if (P_.n_vcycles == 0) {
      dim3 block(32, 8);
      dim3 grid = grid2d(P_.b, P_.h, P_.w, block);
      gauge_nparts_ = grid.x * grid.y;
      if (go())
        mg_partials<<<grid, block, 0, s_>>>(p, L_.mask[0], f(W_.gauge),
                                            P_.h, P_.w);
      note();
    }
    epilogue(p, out, U_out);
  }

  // A learned cut at level `cut` is taken if it lies above the tail or at
  // its first level.
  bool learned_ok(int cut) const { return cut >= 1 && cut <= cut_ &&
                                          cut < L_.n; }

  // The learned V-cycle's first C call: the set-up (if asked), the
  // levels above the cut from src (null: zeros), then the cut level's
  // flags and projected RHS into flags_c and rhs_c.
  void learned_down(const float* src, int cut, bool with_setup,
                    int* flags_c, float* rhs_c) {
    setup(with_setup);
    const float* q = src;
    for (int j = 0; j < cut; ++j) {
      pre_[j] = descend(j, q);
      q = nullptr;
    }
    dim3 block(32, 8);
    if (go())
      mg_cut_out<<<grid2d(P_.b, L_.h[cut], L_.w[cut], block), block, 0,
                   s_>>>(L_.flags[cut], rhs(cut), L_.mask[cut],
                         f(W_.parts[cut]), nparts_[cut], flags_c, rhs_c,
                         L_.h[cut], L_.w[cut]);
    note();
  }

  // The second: `post` sweeps at the cut level from e on rhs_c (already
  // projected), the levels above it, and, after the last V-cycle, the
  // gauge into out; else level 0's p into out. Replays learned_down's
  // bookkeeping first without launching.
  void learned_up(int cut, const float* e, const float* rhs_c, float* out,
                  bool last) {
    quiet_ = true;
    learned_down(nullptr, cut, false, nullptr, nullptr);
    quiet_ = false;
    const float* q = smooth(cut, e, P_.post, false, false, nullptr, rhs_c);
    for (int j = cut - 1; j >= 0; --j)
      q = ascend(j, pre_[j], q, last && j == 0,
                 (!last && j == 0) ? out : nullptr);
    if (last) epilogue(q, out, nullptr);
  }

  // The whole V-cycle from a zero start, without the gauge, when the
  // whole hierarchy fits the single-block tail: the set-up and one tail
  // launch a sample into out (the gathered coarse levels of a
  // width-sharded solve).
  bool tail_whole() const { return cut_ == 0; }
  void tail_only(float* out) {
    setup(true);
    tail(0, nullptr, out, false);
  }

 private:
  float* f(size_t off) { return reinterpret_cast<float*>(work_ + off); }

  void epilogue(const float* p, float* out, float* U_out) {
    dim3 block(32, 8);
    dim3 grid = grid2d(P_.b, P_.h, P_.w, block);
    if (go()) {
      if (project_)
        mg_epilogue<<<grid, block, 0, s_>>>(flags_, U_, p, L_.mask[0],
                                            f(W_.gauge), gauge_nparts_, out,
                                            U_out, P_.h, P_.w);
      else
        mg_gauge<<<grid, block, 0, s_>>>(p, L_.mask[0], f(W_.gauge),
                                         gauge_nparts_, out, P_.h, P_.w);
    }
    note();
  }

  // Counts a launch; true if it is to be issued. A quiet stretch only
  // replays the bookkeeping (buffers, partial counts) of launches that
  // another call issued.
  bool go() {
    if (quiet_) return false;
    ++launches_;
    return issue_ && status_ == 0;
  }
  void note() {
    if (!quiet_ && issue_ && status_ == 0) status_ = launch_status();
  }

  const float* rhs(int j) {
    return (j == 0 && !project_) ? rhs_in_ : f(W_.rhs[j]);
  }

  // The set-up launches (launch false: only their bookkeeping).
  void setup(bool launch) {
    const bool was_quiet = quiet_;
    quiet_ = quiet_ || !launch;
    dim3 block(kSetupTile, 512 / kSetupTile);
    dim3 grid(tiles(P_.w, kSetupTile), tiles(P_.h, kSetupTile), P_.b);
    nparts_[0] = grid.x * grid.y;
    if (go()) {
      if (project_)
        mg_setup<true><<<grid, block, 0, s_>>>(L_, U_, nullptr, f(W_.rhs[0]),
                                              f(W_.parts[0]));
      else
        mg_setup<false><<<grid, block, 0, s_>>>(L_, nullptr, rhs_in_,
                                               nullptr, f(W_.parts[0]));
    }
    note();
    dim3 b2(32, 8);
    for (int j = kSetupLevels + 1; j < L_.n; ++j) {
      if (go())
        mg_coarsen<<<grid2d(P_.b, L_.h[j], L_.w[j], b2), b2, 0, s_>>>(
            L_.flags[j - 1], L_.flags[j], L_.h[j - 1], L_.w[j - 1]);
      note();
    }
    if (L_.n > 1) {
      dim3 g2 = grid2d(P_.b * (L_.n - 1), L_.h[1], L_.w[1], b2);
      if (go()) mg_masks<<<g2, b2, 0, s_>>>(L_);
      note();
    }
    quiet_ = was_quiet;
  }

  LevelArgs level_args(int j, const float* p_in, float* p_out, int k,
                       int halo) {
    LevelArgs a{};
    a.p_in = p_in;
    a.rhs = rhs(j);
    a.parts = f(W_.parts[j]);
    a.nparts = nparts_[j];
    a.mask = L_.mask[j];
    a.p_out = p_out;
    a.h = L_.h[j];
    a.w = L_.w[j];
    a.k = k;
    a.halo = halo;
    whole_grid(a);
    return a;
  }

  // The tile side of level j's launches (kWideBlocks).
  int tile_of(int j) const {
    const int out = 64 - 2 * ((min(P_.pre, kMaxSweeps) + kResidHalo + 1) & ~1);
    return P_.b * tiles(L_.w[j], out) * tiles(L_.h[j], out) >= kWideBlocks
               ? 64 : 32;
  }

  dim3 level_grid(int j, int t, int halo) const {
    const int out = t - 2 * halo;
    return dim3(tiles(L_.w[j], out), tiles(L_.h[j], out), P_.b);
  }

  // A smoothing launch (k sweeps), or the down launch with restrict.
  // rhs_in: a RHS already projected in place of the level's own (its
  // mean is then taken as 0).
  void down(int j, const float* p_in, float* p_out, int k, bool restrict_,
            bool gauge, const float* rhs_in = nullptr) {
    const int halo = restrict_ ? ((k + kResidHalo + 1) & ~1) : k;
    const int t = tile_of(j);
    LevelArgs a = level_args(j, p_in, p_out, k, halo);
    if (rhs_in) {
      a.rhs = rhs_in;
      a.nparts = 0;
    }
    dim3 grid = level_grid(j, t, halo);
    if (restrict_) {
      a.rhs_c = f(W_.rhs[j + 1]);
      a.mask_c = L_.mask[j + 1];
      a.parts_out = f(W_.parts[j + 1]);
      nparts_[j + 1] = grid.x * grid.y;
    } else if (gauge) {
      a.parts_out = f(W_.gauge);
      gauge_nparts_ = grid.x * grid.y;
    }
    if (go())
      status_ = t == 64 ? launch_down<64>(grid, a, P_, s_)
                        : launch_down<32>(grid, a, P_, s_);
    note();
  }

  void up(int j, const float* p_in, const float* e_c, float* p_out, int k,
          bool gauge) {
    const int halo = (k + 1) & ~1;
    const int t = tile_of(j);
    LevelArgs a = level_args(j, p_in, p_out, k, halo);
    dim3 grid = level_grid(j, t, halo);
    if (gauge) {
      a.parts_out = f(W_.gauge);
      gauge_nparts_ = grid.x * grid.y;
    }
    if (go())
      status_ = t == 64 ? launch_up<64>(grid, a, e_c, L_.mask[j + 1], P_, s_)
                        : launch_up<32>(grid, a, e_c, L_.mask[j + 1], P_, s_);
    note();
  }

  void tail(int j, const float* p_in, float* p_out, bool gauge) {
    if (gauge) gauge_nparts_ = 1;
    const TailArgs A = tail_args(L_, j);
    if (go()) {
      status_ = static_cast<int>(cudaFuncSetAttribute(
          mg_tail, cudaFuncAttributeMaxDynamicSharedMemorySize, A.bytes));
      if (status_ == 0)
        mg_tail<<<P_.b, kTailThreads, A.bytes, s_>>>(
            A, p_in, rhs(j), p_out, gauge ? f(W_.gauge) : nullptr,
            P_.pre, P_.post, P_.coarse, P_.damped, P_.keep, P_.damping);
    }
    note();
  }

  // The buffer of level j's pair that q is not.
  float* other(int j, const float* q) {
    float* A = f(W_.pa[j]);
    return q == A ? f(W_.pb[j]) : A;
  }

  // k sweeps of level j from q in launches of up to kMaxSweeps sweeps
  // (at least one launch if once), the last into final_out if given;
  // `gauge`: the last launch writes the gauge's partials. Returns the
  // buffer that holds the result.
  const float* smooth(int j, const float* q, int k, bool gauge, bool once,
                      float* final_out, const float* rhs_in = nullptr) {
    while (k > 0 || once) {
      const int kk = min(k, kMaxSweeps);
      float* o = (final_out && k == kk) ? final_out : other(j, q);
      down(j, q, o, kk, false, gauge && k == kk, rhs_in);
      q = o;
      k -= kk;
      once = false;
    }
    return q;
  }

  // Level j's pre-sweeps from src (null: zeros) and its down launch;
  // returns the buffer with its pre-swept p.
  const float* descend(int j, const float* src) {
    const int k = P_.pre > kMaxSweeps
                      ? (P_.pre - 1) % kMaxSweeps + 1 : P_.pre;
    const float* q = smooth(j, src, P_.pre - k, false, false, nullptr);
    float* o = other(j, q);
    down(j, q, o, k, true, false);
    return o;
  }

  // Level j's up launch onto its pre-swept p q from level j+1's
  // correction e, and the rest of its post-sweeps.
  const float* ascend(int j, const float* q, const float* e, bool gauge,
                      float* final_out) {
    const int kp = min(P_.post, kMaxSweeps);
    float* o = (final_out && kp == P_.post) ? final_out : other(j, q);
    up(j, q, e, o, kp, gauge && kp == P_.post);
    return smooth(j, o, P_.post - kp, gauge, false, final_out);
  }

  // One V-cycle from src (null: zeros): down to the tail's first level or
  // the coarsest, the tail or the coarsest level's sweeps, back up.
  // Returns the buffer that holds level 0's result. `last`: the solve's
  // last V-cycle (its final launch of level 0 writes the gauge's
  // partials).
  const float* vcycle(const float* src, bool last) {
    int j = 0;
    const float* q = src;
    for (; j != cut_ && j + 1 < L_.n; ++j) {
      pre_[j] = descend(j, q);
      q = nullptr;
    }
    const bool gauge = last && j == 0;
    const float* e;
    if (j == cut_) {
      float* o = other(j, q);
      tail(j, q, o, gauge);
      e = o;
    } else {
      e = smooth(j, q, P_.coarse, gauge, true, nullptr);
    }
    while (j-- > 0) e = ascend(j, pre_[j], e, last && j == 0, nullptr);
    return e;
  }

  Problem P_;
  bool project_;
  char* work_;
  const int* flags_;
  const float* rhs_in_;
  const float* U_;
  const float* p0_;
  cudaStream_t s_;
  bool issue_;
  bool ok_ = false;
  Levels L_{};
  int cut_ = 0;
  Workspace W_{};
  int nparts_[kMaxLevels] = {};
  int gauge_nparts_ = 0;
  int launches_ = 0;
  int status_ = 0;
  bool quiet_ = false;
  const float* pre_[kMaxLevels] = {};
};

int clamp_int(size_t v) { return v > (size_t)INT_MAX ? -1 : (int)v; }

// A launch on a slab's window: kind 0 a smoothing launch, 1 a down
// launch with the restriction, 2 an up launch; k sweeps. Its tile side
// (64 where its blocks fill the card, else 32), halo and grid.
struct SlabPlan {
  int t, halo;
  dim3 grid;
};

bool slab_plan(int kind, int b, int h, int lo, int hi, int k,
               SlabPlan* out) {
  if (kind < 0 || kind > 2 || b < 1 || h < 3 || lo < 0 || hi <= lo ||
      k < 0 || k > kMaxSweeps || (kind > 0 && (lo % 2 || hi % 2)))
    return false;
  const int halo = kind == 0 ? k
                   : kind == 1 ? ((k + kResidHalo + 1) & ~1)
                               : ((k + 1) & ~1);
  const int wide = 64 - 2 * halo;
  const int t =
      b * tiles(hi - lo, wide) * tiles(h, wide) >= kWideBlocks ? 64 : 32;
  out->t = t;
  out->halo = halo;
  out->grid = dim3(tiles(hi - lo, t - 2 * halo), tiles(h, t - 2 * halo), b);
  return true;
}

LevelArgs slab_args(const float* p_in, const float* rhs, const uint8_t* mask,
                    const float* sums, float* p_out, int h, int w, int gx0,
                    int gw, int lo, int hi, int wcp, int offc, int k,
                    int halo) {
  LevelArgs a{};
  a.p_in = p_in;
  a.rhs = rhs;
  a.parts = sums;
  a.nparts = 1;
  a.mask = mask;
  a.p_out = p_out;
  a.h = h;
  a.w = w;
  a.k = k;
  a.halo = halo;
  a.lo = lo;
  a.hi = hi;
  a.gx0 = gx0;
  a.gw = gw;
  a.wcp = wcp;
  a.offc = offc;
  return a;
}

}  // namespace

// Bytes of device workspace fn_mg_solve (project 0) or fn_mg_project
// (project 1) needs; -1 for arguments it refuses. Launches nothing.
extern "C" int fn_mg_workspace(int b, int h, int w, int min_size, int pre,
                               int post, int coarse, int project) {
  Problem P{b, h, w, min_size, 0, pre, post, coarse, 0, 0.f, 0.f};
  Solve S(P, project != 0, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr, false);
  return S.ok() ? clamp_int(S.bytes()) : -1;
}

// Kernel launches one such call issues; -1 for arguments it refuses.
// Launches nothing.
extern "C" int fn_mg_launches(int b, int h, int w, int min_size,
                              int n_vcycles, int pre, int post, int coarse,
                              int project) {
  Problem P{b, h, w, min_size, n_vcycles, pre, post, coarse, 0, 0.f, 0.f};
  Solve S(P, project != 0, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr, false);
  if (!S.ok()) return -1;
  S.run(nullptr, nullptr);
  return S.launches();
}

// Index of the first level of (h, w) that the single-block tail runs (the
// levels above it run per-level launches); the number of levels if none.
// Launches nothing.
extern "C" int fn_mg_cut_level(int h, int w, int min_size) {
  Levels L;
  if (!level_shapes(h, w, min_size, &L)) return -1;
  return tail_cut(L);
}

// Kernel G: n_vcycles V-cycles of (flags, div) from p0 (null: zeros) and
// the zero-mean gauge into out; `work` holds fn_mg_workspace(..., 0)
// bytes. Issues every launch on `stream`; returns the first launch error,
// or cudaErrorInvalidValue for bad arguments.
extern "C" int fn_mg_solve(const int* flags, const float* div,
                           const float* p0, float* out, void* work, int b,
                           int h, int w, int min_size, int n_vcycles,
                           int pre, int post, int coarse, int damped,
                           float keep, float damping, void* stream) {
  Problem P{b, h, w, min_size, n_vcycles, pre, post, coarse, damped, keep,
            damping};
  Solve S(P, false, static_cast<char*>(work), flags, div, nullptr, p0,
          (cudaStream_t)stream, true);
  if (!S.ok() || !work) return static_cast<int>(cudaErrorInvalidValue);
  S.run(out, nullptr);
  return S.status();
}

// Kernel H: the divergence RHS of U (b, 2, h, w), n_vcycles V-cycles from
// p0 (null: zeros), the gauge into p_out, the velocity update and the
// free-slip walls into U_out; `work` holds fn_mg_workspace(..., 1) bytes.
extern "C" int fn_mg_project(const int* flags, const float* U,
                             const float* p0, float* p_out, float* U_out,
                             void* work, int b, int h, int w, int min_size,
                             int n_vcycles, int pre, int post, int coarse,
                             int damped, float keep, float damping,
                             void* stream) {
  Problem P{b, h, w, min_size, n_vcycles, pre, post, coarse, damped, keep,
            damping};
  Solve S(P, true, static_cast<char*>(work), flags, nullptr, U, p0,
          (cudaStream_t)stream, true);
  if (!S.ok() || !work) return static_cast<int>(cudaErrorInvalidValue);
  S.run(p_out, U_out);
  return S.status();
}

// Kernel launches of one half of a learned V-cycle cut at level `cut`
// (half 0: fn_mg_learned_down, flag its with_setup; half 1:
// fn_mg_learned_up, flag its last); -1 for arguments or a cut the split
// refuses (a cut inside the tail, or at the finest level). Launches
// nothing.
extern "C" int fn_mg_learned_launches(int b, int h, int w, int min_size,
                                      int cut, int pre, int post, int coarse,
                                      int half, int flag) {
  Problem P{b, h, w, min_size, 1, pre, post, coarse, 0, 0.f, 0.f};
  Solve S(P, false, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
          false);
  if (!S.ok() || !S.learned_ok(cut)) return -1;
  if (half == 0)
    S.learned_down(nullptr, cut, flag != 0, nullptr, nullptr);
  else
    S.learned_up(cut, nullptr, nullptr, nullptr, flag != 0);
  return S.launches();
}

// Kernel G's learned V-cycle, first half: the set-up (with_setup: the
// first V-cycle of a solve), the pre-sweeps and down launches of levels
// 0 .. cut-1 from p_in (null: zeros), then level cut's flags into flags_c
// and its compatibility-projected RHS into rhs_c (b, h_cut, w_cut). `work`
// holds fn_mg_workspace(..., 0) bytes and is handed unchanged to
// fn_mg_learned_up.
extern "C" int fn_mg_learned_down(const int* flags, const float* div,
                                  const float* p_in, int* flags_c,
                                  float* rhs_c, void* work, int b, int h,
                                  int w, int min_size, int cut,
                                  int with_setup, int pre, int post,
                                  int coarse, int damped, float keep,
                                  float damping, void* stream) {
  Problem P{b, h, w, min_size, 1, pre, post, coarse, damped, keep, damping};
  Solve S(P, false, static_cast<char*>(work), flags, div, nullptr, nullptr,
          (cudaStream_t)stream, true);
  if (!S.ok() || !S.learned_ok(cut) || !work || !flags_c || !rhs_c)
    return static_cast<int>(cudaErrorInvalidValue);
  S.learned_down(p_in, cut, with_setup != 0, flags_c, rhs_c);
  return S.status();
}

// Second half: `post` damped sweeps of level cut from the correction e on
// rhs_c (fn_mg_learned_down's output), the up launches of levels cut-1 ..
// 0 and their post-sweeps (level 0's on div, the RHS the first half got),
// then (last) the zero-mean gauge into out, or (not last) level 0's p into
// out for the next V-cycle's p_in.
extern "C" int fn_mg_learned_up(const int* flags, const float* div,
                                const float* e, const float* rhs_c,
                                float* out, void* work, int b, int h, int w,
                                int min_size, int cut, int last, int pre,
                                int post, int coarse, int damped, float keep,
                                float damping, void* stream) {
  Problem P{b, h, w, min_size, 1, pre, post, coarse, damped, keep, damping};
  Solve S(P, false, static_cast<char*>(work), flags, div, nullptr, nullptr,
          (cudaStream_t)stream, true);
  if (!S.ok() || !S.learned_ok(cut) || !work || !div || !e || !rhs_c ||
      !out)
    return static_cast<int>(cudaErrorInvalidValue);
  S.learned_up(cut, e, rhs_c, out, last != 0);
  return S.status();
}

// ---- the width-sharded V-cycle's entries (parallel/multigrid.py) ----
//
// Each runs one launch on a slab of a level (b, h, w): columns gx0 .. of a
// grid gw wide, mod gw. Its window is the columns [lo, hi) it writes;
// outputs are rows hi - lo wide. `sums` (b, 2) holds the grid's sums
// (sum, count) a sample of the level's RHS over continuation cells (the
// ranks' partials, all-reduced): the launch subtracts their mean.

// Per-sample partial sums a launch of fn_mg_slab_down (kind 1) or of
// fn_mg_slab_partials (kind 3) writes, (sum, count) each; -1 for
// arguments it refuses. Launches nothing.
extern "C" int fn_mg_slab_parts(int kind, int b, int h, int lo, int hi,
                                int k) {
  if (kind == 3)
    return (b < 1 || hi <= lo) ? -1 : tiles(hi - lo, 32) * tiles(h, 8);
  SlabPlan pl;
  if (!slab_plan(kind, b, h, lo, hi, k, &pl)) return -1;
  return pl.grid.x * pl.grid.y;
}

// The coarse flags (b, hf / 2, wf / 2) of a slab of fine flags whose
// first column is the grid's column gx0 of gw (both even).
extern "C" int fn_mg_slab_coarsen(const int* flags_f, int* flags_c, int b,
                                  int hf, int wf, int gx0, int gw,
                                  void* stream) {
  if (b < 1 || hf % 2 || wf % 2 || gx0 % 2 || gw % 2 || !flags_f ||
      !flags_c)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, 8);
  mg_slab_coarsen<<<fnk::grid2d(b, hf / 2, wf / 2, block), block, 0,
                    (cudaStream_t)stream>>>(flags_f, flags_c, hf, wf,
                                            gx0 / 2, gw / 2);
  return fnk::launch_status();
}

// The mask bytes (b, h, w) of a slab of flags.
extern "C" int fn_mg_slab_mask(const int* flags, uint8_t* mask, int b,
                               int h, int w, int gx0, int gw, void* stream) {
  if (b < 1 || h < 3 || w < 1 || gw < 3 || !flags || !mask)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, 8);
  mg_slab_mask<<<fnk::grid2d(b, h, w, block), block, 0, (cudaStream_t)stream>>>(
      flags, mask, h, w, gx0, gw);
  return fnk::launch_status();
}

// Per-block partials (x * cont, cont) of the window into parts,
// fn_mg_slab_parts(3, ...) pairs a sample.
extern "C" int fn_mg_slab_partials(const float* x, const uint8_t* mask,
                                   float* parts, int b, int h, int w, int lo,
                                   int hi, void* stream) {
  if (b < 1 || lo < 0 || hi > w || hi <= lo || !x || !mask || !parts)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, 8);
  dim3 grid(tiles(hi - lo, 32), tiles(h, 8), b);
  mg_slab_partials<<<grid, block, 0, (cudaStream_t)stream>>>(x, mask, parts,
                                                             h, w, lo, hi);
  return fnk::launch_status();
}

// One down launch on a slab: the compatibility projection of rhs by the
// mean of `sums`, k <= kMaxSweeps sweeps from p_in (null: zeros), p of
// the window into p_out; with restrict_ also the residual, the border fold
// at the grid's columns and the child sums into rhs_c (b, h / 2, (hi - lo)
// / 2) with their per-block partials (fn_mg_slab_parts(1, ...) a sample)
// into parts, the coarse cells' mask bytes read from mask_c (wcp wide,
// the coarse cell of column x at x / 2 + offc). Exact in the window where
// the slab's columns hold the grid's within k + 2 of it (halo even).
extern "C" int fn_mg_slab_down(const float* p_in, const float* rhs,
                               const uint8_t* mask, const float* sums,
                               const uint8_t* mask_c, float* p_out,
                               float* rhs_c, float* parts, int b, int h,
                               int w, int gx0, int gw, int lo, int hi,
                               int wcp, int offc, int k, int restrict_,
                               int damped, float keep, float damping,
                               void* stream) {
  SlabPlan pl;
  if (!slab_plan(restrict_ ? 1 : 0, b, h, lo, hi, k, &pl) || hi > w ||
      !rhs || !mask || !sums || !p_out ||
      (restrict_ && (!mask_c || !rhs_c || !parts || h % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  LevelArgs a = slab_args(p_in, rhs, mask, sums, p_out, h, w, gx0, gw, lo,
                          hi, wcp, offc, k, pl.halo);
  if (restrict_) {
    a.rhs_c = rhs_c;
    a.mask_c = mask_c;
    a.parts_out = parts;
  }
  Problem P{b, h, w, 0, 1, 0, 0, 0, damped, keep, damping};
  cudaStream_t s = (cudaStream_t)stream;
  const int st = pl.t == 64 ? launch_down<64>(pl.grid, a, P, s)
                            : launch_down<32>(pl.grid, a, P, s);
  return st ? st : fnk::launch_status();
}

// One up launch on a slab: both Neumann-extension passes of the coarse
// correction e_c (wcp wide, as mask_c), its prolongation added onto p_in
// on the continuation cells, k post-sweeps on rhs projected by the mean of
// `sums`, p of the window into p_out. Exact in the window where the fine
// columns within k and the coarse columns within k / 2 + 4 of it hold the
// grid's.
extern "C" int fn_mg_slab_up(const float* p_in, const float* rhs,
                             const uint8_t* mask, const float* sums,
                             const float* e_c, const uint8_t* mask_c,
                             float* p_out, int b, int h, int w, int gx0,
                             int gw, int lo, int hi, int wcp, int offc, int k,
                             int damped, float keep, float damping,
                             void* stream) {
  SlabPlan pl;
  if (!slab_plan(2, b, h, lo, hi, k, &pl) || hi > w || h % 2 || !p_in ||
      !rhs || !mask || !sums || !e_c || !mask_c || !p_out)
    return static_cast<int>(cudaErrorInvalidValue);
  LevelArgs a = slab_args(p_in, rhs, mask, sums, p_out, h, w, gx0, gw, lo,
                          hi, wcp, offc, k, pl.halo);
  Problem P{b, h, w, 0, 1, 0, 0, 0, damped, keep, damping};
  cudaStream_t s = (cudaStream_t)stream;
  const int st = pl.t == 64 ? launch_up<64>(pl.grid, a, e_c, mask_c, P, s)
                            : launch_up<32>(pl.grid, a, e_c, mask_c, P, s);
  return st ? st : fnk::launch_status();
}

// The gauge of a slab's window by the mean of `sums` into p_out, and with
// U (b, 2, h, w) H's velocity update and free-slip walls into U_out (b,
// 2, h, hi - lo).
extern "C" int fn_mg_slab_epilogue(const int* flags, const float* U,
                                   const float* p, const float* sums,
                                   float* p_out, float* U_out, int b, int h,
                                   int w, int gx0, int gw, int lo, int hi,
                                   void* stream) {
  if (b < 1 || h < 3 || lo < 0 || hi > w || hi <= lo || gw < 3 || !flags ||
      !p || !sums || !p_out || (U && !U_out))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, 8);
  dim3 grid(tiles(hi - lo, 32), tiles(h, 8), b);
  mg_slab_epilogue<<<grid, block, 0, (cudaStream_t)stream>>>(
      flags, U, p, sums, p_out, U_out, h, w, gx0, gw, lo, hi);
  return fnk::launch_status();
}

// Launches of fn_mg_tail_solve on (b, h, w); -1 if the whole hierarchy
// does not fit the single-block tail. Launches nothing.
extern "C" int fn_mg_tail_launches(int b, int h, int w, int min_size,
                                   int pre, int post, int coarse) {
  Problem P{b, h, w, min_size, 1, pre, post, coarse, 0, 0.f, 0.f};
  Solve S(P, false, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
          false);
  if (!S.ok() || !S.tail_whole()) return -1;
  S.tail_only(nullptr);
  return S.launches();
}

// Kernel G's V-cycle from a zero start on a grid whose whole hierarchy fits
// the single-block tail, without the gauge: the set-up, then one tail
// launch a sample into out. `work` holds fn_mg_workspace(..., 0) bytes.
extern "C" int fn_mg_tail_solve(const int* flags, const float* rhs,
                                float* out, void* work, int b, int h, int w,
                                int min_size, int pre, int post, int coarse,
                                int damped, float keep, float damping,
                                void* stream) {
  Problem P{b, h, w, min_size, 1, pre, post, coarse, damped, keep, damping};
  Solve S(P, false, static_cast<char*>(work), flags, rhs, nullptr, nullptr,
          (cudaStream_t)stream, true);
  if (!S.ok() || !S.tail_whole() || !work || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  S.tail_only(out);
  return S.status();
}
