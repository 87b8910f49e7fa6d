// Kernels K, L and M: 3-D MacCormack advection on the window engine.
//
//   K  the scalar alone; replaces fluidnet_cxx_tpu/ops/pallas/
//      advect3_pallas.py::advect_scalar3_pallas (body
//      _advect_scalar3_kernel);
//   L  scalar + MAC velocity from the same pre-advection U; replaces
//      advect3_pallas.py::advect_all3_pallas (body _advect_all3_kernel);
//   M  the MAC velocity alone; replaces advect3_pallas.py::
//      advect_velocity3_pallas (body _advect_vel3_kernel); with `orig`
//      (the viscous field the step advects, as E does in 2-D) it samples,
//      corrects and clamps orig along U's MAC vectors, which the JAX
//      step runs on its XLA window engine (ops3d.advect_velocity3).
//
// Same semantics as the port's plain versions ops/ops3d.py
// (advect_scalar3, advect_velocity3; impl='window', first-hit trace):
// the centred velocity, the MAC vectors, fwd and bwd zeroed on the border
// shell (_border_zero3); every sample guarded by where(fluid, sample,
// field); the back-traced position clamped to the cell centre +- D and
// sampled trilinearly with its 8 corners loaded directly (the TPU's
// masked-shift sums over the (2D+2)^3 window are a VMEM device, not
// semantics); the scalar's clamp to the 3^3 fluid neighbourhood of the
// forward landing cell (interior only, the forward value where it has no
// fluid); the velocity's skip rule and Selle clamp over the 8 corners of
// idx -/+ vel*dt. Each velocity component is sampled from the cell centre
// idx + 0.5 along its face's vector, as the reference does.
//
// What bounds it on an H100: bytes (K: rho, u, v, w, flags in and rho'
// out, 24 B a cell; L: 36 B; M: 28 B, ~0.015-0.023 ms at 128^3; M with
// orig: 40 B, 0.0188 ms at 32x128x384 and 0.0250 ms at 128^3 at 3.35
// TB/s); the
// trilinear samples and clamps are ~150 operations a cell per half and
// the trace three slab tests (~30 operations) per blocked cell it tests,
// well under the fp32 rate. What holds them back is latency and issue:
// each cell gathers ~60-160 values and, with the trace, walks its
// obstacles.
//
// Two launches, because the backward samples read the forward field at
// neighbours up to D + 1 cells away, which other blocks write, and no
// block waits on another:
//   launch 1 (forward): rho_fwd and its back-traced position (scalar
//            half), u_fwd, v_fwd and w_fwd (velocity half) into scratch;
//   launch 2 (backward): backward samples, MacCormack correction, clamps,
//            border zeroing, outputs.
//
// K and L: one thread per cell, x fastest, 32 x 8 cells of one z-plane a
// block, reading neighbourhoods straight from global memory (L1/L2). One
// template serves them: kScalar and kVel choose the halves; kTrace
// compiles the trace only into the kernels that run it, so the others keep
// their registers; each kernel has the register budget that ran fastest
// (min_blocks). Staging a block's flags in shared memory (a byte or a bit a
// cell, one plane a block or a 16-plane march) was built and was slower
// on the card: the pruned walk reads a few flags a ray, which L1 holds
// already, and the tile's loads and barrier cost more than they save.
//
// M: each launch marches a kVTX x kVTY column tile along z over a segment
// of kVSegZ output planes (vel3_march), as the TPU kernel keeps its whole
// neighbourhood in VMEM. Every value a cell of the tile reads lies within
// [idx - D, idx + D + 1] on each axis (the window-clamped trilinear
// corners, the Selle corners, the MAC neighbours), so shared memory holds
// rings of planes: the tile plus D cells before and D + 1 after it in x and
// y, u, v and w of each, planes z-D .. z+D+1 around output plane z and
// kVAhead more in flight; the forward launch keeps U's ring, the backward
// one U's and the forward field's. Each step waits for its plane's
// cp.async copies, passes one barrier, issues the copies of the plane
// kVAhead steps ahead into the slot no thread reads any more, and computes
// a plane from shared memory alone, at 32-bit offsets (flags come from
// global memory); the three components of a cell are branch-free, so
// their chains interleave. One thread owns a column, so each cell's MAC
// vectors are computed once a launch. The backward pair of rings at D = 2
// takes 92 KB (two blocks an SM); the rings are built for D up to kVMaxD
// (196 KB at D = 4), and the wrapper refuses a larger D. With orig the
// forward launch keeps U's ring and orig's, the backward one U's, the
// forward field's and orig's: three rings, 138 KB at D = 2 (one block an
// SM), 206 KB at D = kVMaxDOrig = 3 (ten-plane rings); three rings at D =
// 4 exceed a block's 227 KB, so the wrapper refuses D > 3 with orig.
//
// K, L and M run the same device functions on accessors (Field, UAt for
// global memory; RingField, RingAt for the rings), so all three agree bit
// for bit, built with -fmad=false in the plain versions' float32 order.
//
// The first-hit trace walks an exact pruned box instead of the whole
// (2D+1)^3 window. A blocked cell can lower the stopping parameter t only
// if its expanded box meets the segment [c, c + t dir] at 0 <= t_in < t
// <= len, and a min is exact and order-free, so leaving out cells that
// cannot meet the segment changes no bit. The ray starts at the cell
// centre x + 0.5; along an axis a with disp_a > 0 the cells behind it (o <
// 0) end at x + 1e-5 < c, so their exit t_hi < 0 and the hit test fails,
// and cells past floor(0.5 + disp_a + slack) start more than disp_a past c
// (slack covers the 1e-5 margin, the rounding of lo = x - 1e-5 at this
// grid's coordinates and of 0.5 + disp_a, and the ~4 ulp of inv = 1/dir
// against len/disp), so their entry t_lo >= len >= t; mirrored for disp_a
// < 0; for disp_a == 0 (or |dir_a| <= 1e-12) only the ray's own column has
// its coordinate inside the slab. The box is thus, per axis, [floor(0.5 +
// disp_a - slack), 0] or [0, floor(0.5 + disp_a + slack)] within [-D, D]
// and the grid: the own cell alone for a ray that stays in it, at most 27
// cells when every |disp_a| < 1.5. The domain's margin planes are the
// faces of the cells just outside the grid, so by the same argument a box
// inside the grid keeps t = len, and only a box that reaches past the grid
// computes them. slack = 2^-12 + (max(d, h, w) + D) 2^-21 comes from the
// wrapper (ops/line_trace3.py::firsthit_slack3; tests/test_torch_trace3_
// prune.py holds this walk to the full one bit for bit). The walk reads one
// flag a cell of the box and runs the slab tests only for blocked ones: a
// ray with no blocked cell in reach tests nothing. The three reciprocals
// 1/dir_a, the same values the plain version divides for each test, are
// taken once a ray, and only when a margin plane or a blocked cell needs
// them.
#include "common.cuh"

namespace {
using namespace fnk;

constexpr float kHitMargin = 1e-5f;
constexpr float kEps = 1e-12f;
constexpr float kBig = 3e38f;
// float32(1 + 2 * HIT_MARGIN): the expanded cell box's extent.
constexpr float kExtent = (float)(1.0 + 2.0 * 1e-5);
#define kInf __int_as_float(0x7f800000)

// A block: 32 x 8 cells of one z-plane, a thread a cell, x fastest.
constexpr int kBlockX = 32, kBlockY = 8;
// Blocks of 256 threads an SM must hold, for each kernel: 4 (64
// registers), 6 (40) or 8 (32), the budgets that ran fastest on an H100.
constexpr int min_blocks(bool backward, bool scalar, bool vel, bool trace) {
  if (backward) return vel ? 4 : trace ? 6 : 8;
  return trace ? 4 : scalar && vel ? 6 : 8;
}

struct Params {
  int d, h, w, D;
  float dt, halfstr;
  float dim_m[3];   // float32(dim - HIT_MARGIN) for x, y, z
  float slack;      // the pruned trace box's margin (see the note above)
};

// One thread's cell: its coordinates, its index within the sample and the
// sample's strides along x, y, z.
struct Cell {
  int x, y, z;
  size_t i, n;     // index within the sample; cells per sample
  size_t s[3];     // strides along x, y, z
  bool fluid, in;  // flag == fluid; inside the border shell
};

__device__ __forceinline__ size_t idx3(const Params& P, int x, int y,
                                       int z) {
  return ((size_t)z * P.h + y) * P.w + x;
}

// Position clamp to the cell's own centre +- D (window semantics).
__device__ __forceinline__ float clamp_win(float p, float c, int D) {
  return fminf(fmaxf(p, c - (float)D), c + (float)D);
}

// One sample's field in global memory, read at cell (X, Y, Z).
struct Field {
  const float* f;
  int h, w;
  __device__ __forceinline__ float operator()(int X, int Y, int Z) const {
    return f[((size_t)Z * h + Y) * w + X];
  }
};

__device__ __forceinline__ Field field(const float* f, const Params& P) {
  return Field{f, P.h, P.w};
}

// Trilinear sample of one sample's field f (an accessor: Field, or the
// velocity march's RingField) at an absolute position, after the window
// clamp around centre c: pos-0.5, trunc, weights clamped to [0, 1], lower
// corner clamped to [0, dim-2]; lerp along x, then y, then z
// (ops/window3.py::interpol_window3). The corners lie within [idx - D,
// idx + D + 1] of the cell idx a clamp is centred on.
template <class F>
__device__ float trilinear(F f, const Params& P, const float c[3],
                           const float pos[3]) {
  const int dims[3] = {P.w, P.h, P.d};
  int lo[3];
  float a1[3], a0[3];
  for (int a = 0; a < 3; ++a) {
    float q = clamp_win(pos[a], c[a], P.D) - 0.5f;
    int iq = (int)truncf(q);
    a1[a] = fminf(fmaxf(q - (float)iq, 0.f), 1.f);
    a0[a] = 1.f - a1[a];
    lo[a] = min(max(iq, 0), dims[a] - 2);
  }
  float pl[2];
  for (int k = 0; k < 2; ++k) {
    const int Z = lo[2] + k;
    float v0 = a0[0] * f(lo[0], lo[1], Z) + a1[0] * f(lo[0] + 1, lo[1], Z);
    float v1 = a0[0] * f(lo[0], lo[1] + 1, Z) +
               a1[0] * f(lo[0] + 1, lo[1] + 1, Z);
    pl[k] = a0[1] * v0 + a1[1] * v1;
  }
  return a0[2] * pl[0] + a1[2] * pl[1];
}

// The ray's parameter at the domain's margin planes along one axis; inv is
// 1 / (ok ? dir : 1), ok = |dir| > 1e-12.
__device__ __forceinline__ float border_t(float p0, bool ok, float inv,
                                          float dim_m) {
  float t1 = (kHitMargin - p0) * inv;
  float t2 = (dim_m - p0) * inv;
  t1 = (ok && t1 >= 0.f) ? t1 : kBig;
  t2 = (ok && t2 >= 0.f) ? t2 : kBig;
  return fminf(t1, t2);
}

// Entry and exit parameters of the ray against cell coordinate X's
// expanded slab along one axis.
__device__ __forceinline__ void slabs(float p0, bool ok, float inv, int X,
                                      float* t_lo, float* t_hi) {
  float lo = (float)X - kHitMargin;
  float hi = lo + kExtent;
  float t1 = (lo - p0) * inv;
  float t2 = (hi - p0) * inv;
  bool in = p0 >= lo && p0 <= hi;
  *t_lo = ok ? fminf(t1, t2) : (in ? -kBig : kBig);
  *t_hi = ok ? fmaxf(t1, t2) : (in ? kBig : -kBig);
}

// Continuous first-hit trace from the centre c of fluid cell C along
// disp (ops/line_trace3.py::line_trace_firsthit3) over the pruned box. A
// box that stays inside the grid cannot reach the border planes either
// (they are the faces of the cells just outside), so t starts at len
// there; the reciprocals are taken only when a border plane or a blocked
// cell needs them.
__device__ void trace3(const Cell& C, const float c[3], const float disp[3],
                       const int* flags, const Params& P, float out[3]) {
  float len = sqrtf((disp[0] * disp[0] + disp[1] * disp[1]) +
                    disp[2] * disp[2]);
  for (int a = 0; a < 3; ++a) out[a] = c[a];
  if (!(len > kEps)) return;
  float inv_len = 1.f / fmaxf(len, kEps);
  const int idx[3] = {C.x, C.y, C.z};
  const int dims[3] = {P.w, P.h, P.d};
  float dir[3], inv[3];
  bool ok[3];
  int lo[3], hi[3];
  bool edge = false;
  for (int a = 0; a < 3; ++a) {
    dir[a] = disp[a] * inv_len;
    const float e = 0.5f + disp[a];
    lo[a] = idx[a] + (disp[a] < 0.f ? max((int)floorf(e - P.slack), -P.D)
                                     : 0);
    hi[a] = idx[a] + (disp[a] > 0.f ? min((int)floorf(e + P.slack), P.D)
                                     : 0);
    edge |= lo[a] < 0 || hi[a] >= dims[a];
    lo[a] = max(lo[a], 0);
    hi[a] = min(hi[a], dims[a] - 1);
  }
  bool have_inv = false;
  auto reciprocals = [&]() {
    for (int a = 0; a < 3; ++a) {
      ok[a] = fabsf(dir[a]) > kEps;
      inv[a] = 1.f / (ok[a] ? dir[a] : 1.f);
    }
    have_inv = true;
  };
  float t = len;
  if (edge) {
    reciprocals();
    t = fminf(fminf(fminf(border_t(c[0], ok[0], inv[0], P.dim_m[0]),
                          border_t(c[1], ok[1], inv[1], P.dim_m[1])),
                    border_t(c[2], ok[2], inv[2], P.dim_m[2])),
              len);
  }
  for (int Z = lo[2]; Z <= hi[2]; ++Z)
    for (int Y = lo[1]; Y <= hi[1]; ++Y) {
      const int* row = flags + idx3(P, 0, Y, Z);
      for (int X = lo[0]; X <= hi[0]; ++X) {
        if (row[X] == kFluid) continue;
        if (!have_inv) reciprocals();
        float t_in, t_out, tl, th;
        slabs(c[0], ok[0], inv[0], X, &t_in, &t_out);
        slabs(c[1], ok[1], inv[1], Y, &tl, &th);
        t_in = fmaxf(t_in, tl);
        t_out = fminf(t_out, th);
        slabs(c[2], ok[2], inv[2], Z, &tl, &th);
        t_in = fmaxf(t_in, tl);
        t_out = fminf(t_out, th);
        if (t_in <= t_out && t_in >= 0.f) t = fminf(t, t_in);
      }
    }
  t = fmaxf(t, 0.f);
  for (int a = 0; a < 3; ++a) out[a] = c[a] + t * dir[a];
}

// The cell of this thread and its sample b; false past the grid's edge.
__device__ __forceinline__ bool cell_of(const Params& P, const int* flags_all,
                                        int* b, Cell* C, const int** flags) {
  C->x = blockIdx.x * blockDim.x + threadIdx.x;
  C->y = blockIdx.y * blockDim.y + threadIdx.y;
  C->z = blockIdx.z % P.d;
  *b = blockIdx.z / P.d;
  if (C->x >= P.w || C->y >= P.h) return false;
  C->s[0] = 1;
  C->s[1] = P.w;
  C->s[2] = (size_t)P.h * P.w;
  C->n = C->s[2] * P.d;
  C->i = idx3(P, C->x, C->y, C->z);
  *flags = flags_all + *b * C->n;
  C->fluid = (*flags)[C->i] == kFluid;
  C->in = C->x >= 1 && C->x <= P.w - 2 && C->y >= 1 && C->y <= P.h - 2 &&
          C->z >= 1 && C->z <= P.d - 2;
  return true;
}

__device__ __forceinline__ void centre(const Cell& C, float c[3]) {
  c[0] = (float)C.x + 0.5f;
  c[1] = (float)C.y + 0.5f;
  c[2] = (float)C.z + 0.5f;
}

// Centred velocity (ops3d.get_centered3), zero on the border shell.
// U3 holds the sample's u, v, w planes.
__device__ __forceinline__ void centred(const float* const U3[3],
                                        const Cell& C, float cc[3]) {
  for (int a = 0; a < 3; ++a)
    cc[a] = C.in ? 0.5f * (U3[a][C.i] + U3[a][C.i + C.s[a]]) : 0.f;
}

// 0.25 * (((a + b) + c) + d)
__device__ __forceinline__ float avg4(float a, float b, float c, float d) {
  return 0.25f * (((a + b) + c) + d);
}

// U of one sample in global memory around cell C: at(k, dx, dy, dz) is
// component k at the cell's neighbour (x + dx, y + dy, z + dz).
struct UAt {
  const float* const* U3;
  long long i, sy, sz;
  __device__ __forceinline__ float operator()(int k, int dx, int dy,
                                              int dz) const {
    return U3[k][i + dx + dy * sy + dz * sz];
  }
};

__device__ __forceinline__ UAt u_at(const float* const U3[3], const Cell& C) {
  return UAt{U3, (long long)C.i, (long long)C.s[1], (long long)C.s[2]};
}

// The full velocity vector at the face of component c
// (ops3d.mac_vectors3), zero on the border shell; `at` reads U around the
// cell (UAt, or the velocity march's RingAt).
template <class At>
__device__ __forceinline__ void mac_vector(At at, const Cell& C, int c,
                                           float m[3]) {
  if (!C.in) {
    m[0] = m[1] = m[2] = 0.f;
    return;
  }
  if (c == 0) {
    m[0] = at(0, 0, 0, 0);
    m[1] = avg4(at(1, 0, 0, 0), at(1, -1, 0, 0), at(1, 0, 1, 0),
                at(1, -1, 1, 0));
    m[2] = avg4(at(2, 0, 0, 0), at(2, -1, 0, 0), at(2, 0, 0, 1),
                at(2, -1, 0, 1));
  } else if (c == 1) {
    m[0] = avg4(at(0, 0, 0, 0), at(0, 0, -1, 0), at(0, 1, 0, 0),
                at(0, 1, -1, 0));
    m[1] = at(1, 0, 0, 0);
    m[2] = avg4(at(2, 0, 0, 0), at(2, 0, -1, 0), at(2, 0, 0, 1),
                at(2, 0, -1, 1));
  } else {
    m[0] = avg4(at(0, 0, 0, 0), at(0, 0, 0, -1), at(0, 1, 0, 0),
                at(0, 1, 0, -1));
    m[1] = avg4(at(1, 0, 0, 0), at(1, 0, 0, -1), at(1, 0, 1, 0),
                at(1, 0, 1, -1));
    m[2] = at(2, 0, 0, 0);
  }
}

// The scalar's back-traced position for step sdt: the first-hit trace of
// the displacement clipped to +-D (fluid cells; others stay at the
// centre), or the straight back-trace.
template <bool kTrace>
__device__ void scalar_back(const Cell& C, const float c[3],
                            const float cc[3], float sdt, const int* flags,
                            const Params& P, float back[3]) {
  if (!kTrace) {
    for (int a = 0; a < 3; ++a) back[a] = c[a] - sdt * cc[a];
    return;
  }
  if (!C.fluid) {
    for (int a = 0; a < 3; ++a) back[a] = c[a];
    return;
  }
  float disp[3];
  for (int a = 0; a < 3; ++a)
    disp[a] = fminf(fmaxf(-sdt * cc[a], (float)-P.D), (float)P.D);
  trace3(C, c, disp, flags, P, back);
}

// Semi-Lagrangian sample of f at pos, guarded by where(fluid, sample, f)
// and zeroed on the border shell.
template <class F>
__device__ __forceinline__ float sl(F f, const Cell& C, const float c[3],
                                    const float pos[3], const Params& P) {
  float val = C.fluid ? trilinear(f, P, c, pos) : f(C.x, C.y, C.z);
  return C.in ? val : 0.f;
}

// Component comp of the velocity's forward half at cell C: component comp
// of U (orig) sampled at c - dt * its face's MAC vector (sl, with the
// sample taken in every cell so that the three components' chains hold no
// branch).
template <class At, class F>
__device__ __forceinline__ float vel_forward(At at, F orig, const Cell& C,
                                             const float c[3], int comp,
                                             const Params& P) {
  float m[3], pos[3];
  mac_vector(at, C, comp, m);
  for (int a = 0; a < 3; ++a) pos[a] = c[a] - P.dt * m[a];
  const float t = trilinear(orig, P, c, pos);
  const float val = C.fluid ? t : orig(C.x, C.y, C.z);
  return C.in ? val : 0.f;
}

// Component comp of the velocity's backward half at interior cell C: the
// forward field f_fwd sampled at c + dt * the MAC vector, the correction
// unless `skip` (the face does not lie between fluid cells; sl's
// where(fluid, sample, f_fwd) matters only where the cell is fluid, so the
// sample is taken in every cell), and the Selle clamp to the extrema of
// orig over the 8 corners of each of idx -/+ the MAC vector * dt (clipped
// to +-D, truncated, lower corner clamped to [0, dim-2]: within
// [idx - D, idx + D + 1]).
template <class At, class F, class O>
__device__ __forceinline__ float vel_backward(At at, F f_fwd, O orig,
                                              const Cell& C, const float c[3],
                                              int comp, bool skip,
                                              const Params& P) {
  const int idx[3] = {C.x, C.y, C.z};
  const int dims[3] = {P.w, P.h, P.d};
  float m[3], pos[3];
  mac_vector(at, C, comp, m);
  for (int a = 0; a < 3; ++a) pos[a] = c[a] - (-P.dt) * m[a];
  float bwd = trilinear(f_fwd, P, c, pos);
  float fwd = f_fwd(C.x, C.y, C.z);
  float dst = skip ? fwd : fwd + P.halfstr * (orig(C.x, C.y, C.z) - bwd);
  float vel[3];
  for (int a = 0; a < 3; ++a)
    vel[a] = fminf(fmaxf(m[a] * P.dt, (float)-P.D), (float)P.D);
  float mn = kInf, mx = -kInf;
  for (int s = 0; s < 2; ++s) {
    const float sgn = s ? 1.f : -1.f;
    int lo[3];
    for (int a = 0; a < 3; ++a)
      lo[a] = min(max((int)((float)idx[a] + sgn * vel[a]), 0), dims[a] - 2);
    for (int dk = 0; dk <= 1; ++dk)
      for (int dj = 0; dj <= 1; ++dj)
        for (int di = 0; di <= 1; ++di) {
          float o = orig(lo[0] + di, lo[1] + dj, lo[2] + dk);
          mn = fminf(mn, o);
          mx = fmaxf(mx, o);
        }
  }
  return fmaxf(fminf(dst, mx), mn);
}

// Scratch plane k of sample b: the scalar half uses planes 0-3 (rho_fwd
// and its back-traced x, y, z), the velocity half the next three (u_fwd,
// v_fwd, w_fwd).
__device__ __forceinline__ size_t plane(int k, int b, int nb, size_t n) {
  return ((size_t)k * nb + b) * n;
}

template <bool kScalar, bool kVel, bool kTrace>
__global__ void __launch_bounds__(kBlockX * kBlockY,
                                  min_blocks(false, kScalar, kVel, kTrace))
    advect3_forward(const float* __restrict__ rho,
                    const float* __restrict__ U,
                    const int* __restrict__ flags_all,
                    float* __restrict__ scratch, Params P) {
  int b;
  Cell C;
  const int* flags;
  if (!cell_of(P, flags_all, &b, &C, &flags)) return;
  const int nb = gridDim.z / P.d;
  const float* u = U + (size_t)b * 3 * C.n;
  const float* const U3[3] = {u, u + C.n, u + 2 * C.n};
  float c[3];
  centre(C, c);

  if (kScalar) {
    float cc[3], back[3];
    centred(U3, C, cc);
    scalar_back<kTrace>(C, c, cc, P.dt, flags, P, back);
    scratch[plane(0, b, nb, C.n) + C.i] =
        sl(field(rho + (size_t)b * C.n, P), C, c, back, P);
    for (int a = 0; a < 3; ++a)
      scratch[plane(1 + a, b, nb, C.n) + C.i] = C.fluid ? back[a] : c[a];
  }
  if (kVel) {
    const int k = kScalar ? 4 : 0;
    for (int comp = 0; comp < 3; ++comp)
      scratch[plane(k + comp, b, nb, C.n) + C.i] =
          vel_forward(u_at(U3, C), field(U3[comp], P), C, c, comp, P);
  }
}

template <bool kScalar, bool kVel, bool kTrace>
__global__ void __launch_bounds__(kBlockX * kBlockY,
                                  min_blocks(true, kScalar, kVel, kTrace))
    advect3_backward(const float* __restrict__ rho,
                     const float* __restrict__ U,
                     const int* __restrict__ flags_all,
                     const float* __restrict__ scratch,
                     float* __restrict__ rho_out,
                     float* __restrict__ U_out, Params P) {
  int b;
  Cell C;
  const int* flags;
  if (!cell_of(P, flags_all, &b, &C, &flags)) return;
  const int nb = gridDim.z / P.d;
  const float* u = U + (size_t)b * 3 * C.n;
  const float* const U3[3] = {u, u + C.n, u + 2 * C.n};
  float c[3];
  centre(C, c);

  // ---- scalar: backward sample, correction, 3^3 fluid clamp ----
  if (kScalar) {
    const float* s_fwd = scratch + plane(0, b, nb, C.n);
    const float* src = rho + (size_t)b * C.n;
    float cc[3], back[3];
    centred(U3, C, cc);
    scalar_back<kTrace>(C, c, cc, -P.dt, flags, P, back);
    float bwd = sl(field(s_fwd, P), C, c, back, P);
    float fwd = s_fwd[C.i];
    float dst = C.fluid ? fwd + P.halfstr * (src[C.i] - bwd) : fwd;
    float out = dst;
    if (C.in) {
      const int dims[3] = {P.w, P.h, P.d};
      int l[3];
      for (int a = 0; a < 3; ++a) {
        float pa = clamp_win(scratch[plane(1 + a, b, nb, C.n) + C.i], c[a],
                             P.D);
        l[a] = min(max((int)truncf(pa), 0), dims[a] - 1);
      }
      float mn = kInf, mx = -kInf;
      bool found = false;
      for (int dk = -1; dk <= 1; ++dk)
        for (int dj = -1; dj <= 1; ++dj)
          for (int di = -1; di <= 1; ++di) {
            int X = l[0] + di, Y = l[1] + dj, Z = l[2] + dk;
            if (X < 0 || X >= P.w || Y < 0 || Y >= P.h || Z < 0 || Z >= P.d)
              continue;
            size_t j = idx3(P, X, Y, Z);
            if (flags[j] != kFluid) continue;
            mn = fminf(mn, src[j]);
            mx = fmaxf(mx, src[j]);
            found = true;
          }
      out = found ? fmaxf(mn, fminf(mx, dst)) : fwd;
    }
    rho_out[(size_t)b * C.n + C.i] = out;
  }

  // ---- velocity: backward samples, skip-masked correction, Selle ----
  if (kVel) {
    const int k = kScalar ? 4 : 0;
    float* uo = U_out + (size_t)b * 3 * C.n;
    const int idx[3] = {C.x, C.y, C.z};
    for (int comp = 0; comp < 3; ++comp) {
      if (!C.in) {
        uo[comp * C.n + C.i] = 0.f;
        continue;
      }
      const bool skip = !C.fluid ||
                        (idx[comp] > 0 && flags[C.i - C.s[comp]] != kFluid);
      uo[comp * C.n + C.i] = vel_backward(
          u_at(U3, C), field(scratch + plane(k + comp, b, nb, C.n), P),
          field(U3[comp], P), C, c, comp, skip, P);
    }
  }
}

// ---- Kernel M: the velocity alone, as z-marches over column tiles ----

// A block's x-y tile, the output planes of its z segment, the planes a
// ring loads ahead of their first use, and the largest D the rings are
// built for (the backward ring pair at D = 4 takes 196 KB of the 227 KB a
// block may have).
constexpr int kVTX = 32;        // tile columns: one warp a row
constexpr int kVTY = 8;         // tile rows
constexpr int kVSegZ = 32;      // output planes a block
constexpr int kVAhead = 2;      // planes in flight
constexpr int kVMaxD = 4;
constexpr int kVMaxDOrig = 3;   // with orig: three rings a backward block

// Shared memory a block may have (after the opt-in above 48 KB).
constexpr int kSmemMax = 232448;

constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// The geometry of a ring of planes: columns x0-D .. x0+kVTX+D and rows
// y0-D .. y0+kVTY+D of a tile at (x0, y0) (every corner and MAC neighbour
// of its cells: [idx - D, idx + D + 1]), u, v and w of each plane, and
// planes z-D .. z+D+1 around output plane z plus kVAhead in flight: at
// least kMinDepth slots, rounded up to a power of two where the backward
// block's kRings rings still fit (the slot of plane Z is then Z &
// (kDepth - 1)): 2 without orig (U's and the forward field's), 3 with it.
template <int kD, int kRings = 2>
struct Ring {
  static constexpr int kW = kVTX + 2 * kD + 1;
  static constexpr int kH = kVTY + 2 * kD + 1;
  static constexpr int kPlane = kW * kH;                // one component
  static constexpr int kSlot = 3 * kPlane;              // one z plane
  static constexpr int kMinDepth = 2 * kD + 2 + kVAhead;
  static constexpr int kDepth =
      kRings * pow2_at_least(kMinDepth) * kSlot * 4 <= kSmemMax
          ? pow2_at_least(kMinDepth)
          : kMinDepth;
  static constexpr int kFloats = kDepth * kSlot;
  static constexpr int kLoads = (kPlane + kVTX * kVTY - 1) / (kVTX * kVTY);
};
static_assert(2 * Ring<kVMaxD>::kFloats * sizeof(float) <= kSmemMax,
              "the backward rings at kVMaxD exceed a block's shared memory");
static_assert(3 * Ring<kVMaxDOrig, 3>::kFloats * sizeof(float) <= kSmemMax,
              "the backward rings with orig at kVMaxDOrig exceed a block's "
              "shared memory");

// The rings of the block: kernel M's dynamic shared memory.
extern __shared__ float vel3_rings[];

// One component of a ring: plane Z lives in slot Z % kDepth, cell (X, Y)
// at (Y - y0) * kW + (X - x0) of it (x0, y0: the ring's first column and
// row). Offsets into vel3_rings are 32-bit; Z >= 0 for every cell a march
// reads.
template <int kD, int kRings>
struct RingField {
  int base;  // the component's plane in slot 0
  int x0, y0;
  __device__ __forceinline__ float operator()(int X, int Y, int Z) const {
    using G = Ring<kD, kRings>;
    return vel3_rings[base + (int)((unsigned)Z % G::kDepth) * G::kSlot +
                      (Y - y0) * G::kW + (X - x0)];
  }
};

// U's ring around cell (x, y, z), as UAt reads U in global memory: `own`
// is the ring's offset plus the cell's offset within a plane, zo the slot
// offsets of planes z-1, z, z+1 (a MAC vector's dz is a constant once the
// component loop is unrolled, so each read is one add and a load).
template <int kD>
struct RingAt {
  int own;
  int zo[3];
  __device__ __forceinline__ float operator()(int k, int dx, int dy,
                                              int dz) const {
    return vel3_rings[own + k * Ring<kD>::kPlane + zo[dz + 1] +
                      dy * Ring<kD>::kW + dx];
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One half of kernel M over a kVTX x kVTY tile and a z segment of kVSegZ
// output planes. Forward: U's ring; each cell's u_fwd, v_fwd, w_fwd into
// the scratch planes 0-2. Backward: U's ring and the forward field's
// (rings[0, kFloats) and [kFloats, 2 kFloats)); U' out. kOrig adds orig's
// ring after them, which the samples, the correction and the clamp read
// in place of U's (the MAC vectors stay U's). At the step of
// output plane z, it waits for plane z + D + 1's copies, passes one
// barrier, issues plane z + D + 1 + kVAhead's cp.async copies (into the
// slot of a plane no thread reads any more: z - D - 1 or older) and
// computes plane z from shared memory alone;
// flags come from global memory. Cells of the ring off the grid are never
// loaded and never read. Grid: x and y tiles, b * segs z segments.
template <int kD, bool kBackward, bool kOrig>
__global__ void __launch_bounds__(kVTX * kVTY, kBackward || kOrig ? 2 : 4)
    vel3_march(const float* __restrict__ U, const float* __restrict__ orig_all,
               const int* __restrict__ flags_all,
               const float* __restrict__ scratch, float* __restrict__ out,
               Params P, int segs) {
  constexpr int kRings = kOrig ? 3 : 2;
  using G = Ring<kD, kRings>;
  // U's ring, the forward field's, orig's (U's without orig).
  constexpr int ru = 0, rf = G::kFloats;
  constexpr int ro = kOrig ? (kBackward ? 2 : 1) * G::kFloats : ru;
  const int tid = threadIdx.y * kVTX + threadIdx.x;
  const int seg = blockIdx.z % segs, b = blockIdx.z / segs;
  const int nb = gridDim.z / segs;
  const int x0 = blockIdx.x * kVTX - kD, y0 = blockIdx.y * kVTY - kD;
  const int z0 = seg * kVSegZ, z1 = min(z0 + kVSegZ, P.d);
  const size_t hw = (size_t)P.h * P.w, n = hw * P.d;
  const float* const u = U + (size_t)b * 3 * n;
  const float* const o = kOrig ? orig_all + (size_t)b * 3 * n : u;
  const int* const flags = flags_all + (size_t)b * n;

  // This thread's share of a plane: ring cell tid + j * threads, at offset
  // goff[j] of a grid plane, or -1 off the grid.
  int goff[G::kLoads];
#pragma unroll
  for (int j = 0; j < G::kLoads; ++j) {
    const int e = tid + j * kVTX * kVTY;
    const int X = x0 + e % G::kW, Y = y0 + e / G::kW;
    goff[j] = e < G::kPlane && X >= 0 && X < P.w && Y >= 0 && Y < P.h
                  ? Y * P.w + X
                  : -1;
  }
  // One commit group a plane, empty off the grid and past the segment's
  // last plane read (z1 - 1 + D + 1).
  auto load = [&](int Z) {
    if (Z >= 0 && Z < P.d && Z <= z1 + kD) {
      const int slot = (int)((unsigned)Z % G::kDepth) * G::kSlot;
      const size_t zo = (size_t)Z * hw;
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < G::kLoads; ++j) {
          if (goff[j] < 0) continue;
          const int e = slot + k * G::kPlane + tid + j * kVTX * kVTY;
          cp_async4(vel3_rings + ru + e, u + k * n + zo + goff[j]);
          if (kOrig)
            cp_async4(vel3_rings + ro + e, o + k * n + zo + goff[j]);
          if (kBackward)
            cp_async4(vel3_rings + rf + e,
                      scratch + ((size_t)k * nb + b) * n + zo + goff[j]);
        }
    }
    cp_async_commit();
  };

  for (int Z = z0 - kD; Z <= z0 + kD + kVAhead; ++Z) load(Z);
  Cell C;
  C.x = x0 + kD + threadIdx.x;
  C.y = y0 + kD + threadIdx.y;
  const bool owns = C.x < P.w && C.y < P.h;
  float c[3] = {(float)C.x + 0.5f, (float)C.y + 0.5f, 0.f};
  for (int z = z0; z < z1; ++z) {
    cp_async_wait<kVAhead - 1>();
    __syncthreads();
    load(z + kD + 1 + kVAhead);
    if (!owns) continue;
    C.z = z;
    c[2] = (float)z + 0.5f;
    const size_t i = z * hw + (size_t)C.y * P.w + C.x;
    C.fluid = flags[i] == kFluid;
    C.in = C.x >= 1 && C.x <= P.w - 2 && C.y >= 1 && C.y <= P.h - 2 &&
           z >= 1 && z <= P.d - 2;
    RingAt<kD> at;
    at.own = ru + (C.y - y0) * G::kW + (C.x - x0);
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz)
      at.zo[dz + 1] = (int)((unsigned)(z + dz) % G::kDepth) * G::kSlot;
    // The three components of an interior cell hold no branch, so their
    // chains interleave.
    float r[3] = {0.f, 0.f, 0.f};
    if (C.in) {
      const size_t stride[3] = {1, (size_t)P.w, hw};
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        const RingField<kD, kRings> orig{ro + comp * G::kPlane, x0, y0};
        if (kBackward) {
          const bool skip = !C.fluid || flags[i - stride[comp]] != kFluid;
          r[comp] = vel_backward(
              at, RingField<kD, kRings>{rf + comp * G::kPlane, x0, y0}, orig,
              C, c, comp, skip, P);
        } else {
          r[comp] = vel_forward(at, orig, C, c, comp, P);
        }
      }
    }
#pragma unroll
    for (int comp = 0; comp < 3; ++comp)
      out[(kBackward ? (size_t)b * 3 + comp : (size_t)comp * nb + b) * n +
          i] = r[comp];
  }
  cp_async_wait<0>();
}

// Bytes of dynamic shared memory of one half's block at max_disp kD.
template <int kD, bool kBackward, bool kOrig>
constexpr size_t march_bytes() {
  return ((kBackward ? 2 : 1) + (kOrig ? 1 : 0)) *
         Ring<kD, kOrig ? 3 : 2>::kFloats * sizeof(float);
}

template <int kD, bool kBackward, bool kOrig>
int launch_vel3_march(const float* U, const float* orig, const int* flags,
                      const float* scratch, float* out, int b,
                      const Params& P, cudaStream_t s) {
  const int segs = (P.d + kVSegZ - 1) / kVSegZ;
  if ((long long)b * segs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = vel3_march<kD, kBackward, kOrig>;
  constexpr size_t bytes = march_bytes<kD, kBackward, kOrig>();
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((P.w + kVTX - 1) / kVTX, (P.h + kVTY - 1) / kVTY,
                  b * segs);
  kern<<<grid, dim3(kVTX, kVTY), bytes, s>>>(U, orig, flags, scratch, out,
                                             P, segs);
  return fnk::launch_status();
}

// The march of one half at max_disp P.D (1..kVMaxD; 1..kVMaxDOrig with
// orig, which is null without).
template <bool kBackward>
int launch_vel3(const float* U, const float* orig, const int* flags,
                const float* scratch, float* out, int b, const Params& P,
                cudaStream_t s) {
  static_assert(kVMaxD == 4 && kVMaxDOrig == 3,
                "launch_vel3 dispatches D = 1..4, with orig 1..3");
  if (orig) {
    switch (P.D) {
      case 1:
        return launch_vel3_march<1, kBackward, true>(U, orig, flags, scratch,
                                                     out, b, P, s);
      case 2:
        return launch_vel3_march<2, kBackward, true>(U, orig, flags, scratch,
                                                     out, b, P, s);
      case 3:
        return launch_vel3_march<3, kBackward, true>(U, orig, flags, scratch,
                                                     out, b, P, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (P.D) {
    case 1:
      return launch_vel3_march<1, kBackward, false>(U, U, flags, scratch, out,
                                                    b, P, s);
    case 2:
      return launch_vel3_march<2, kBackward, false>(U, U, flags, scratch, out,
                                                    b, P, s);
    case 3:
      return launch_vel3_march<3, kBackward, false>(U, U, flags, scratch, out,
                                                    b, P, s);
    case 4:
      return launch_vel3_march<4, kBackward, false>(U, U, flags, scratch, out,
                                                    b, P, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Params make_params(int d, int h, int w, float dt, float halfstr, float wm,
                   float hm, float dm, float slack, int D) {
  Params P;
  P.d = d;
  P.h = h;
  P.w = w;
  P.D = D;
  P.dt = dt;
  P.halfstr = halfstr;
  P.dim_m[0] = wm;
  P.dim_m[1] = hm;
  P.dim_m[2] = dm;
  P.slack = slack;
  return P;
}

bool bad_shape(int b, int d, int h, int w, int D) {
  return b < 1 || d < 3 || h < 3 || w < 3 || D < 1 ||
         (long long)b * d > 65535;
}

// Launch one kernel over b samples.
template <class Kernel, class... Args>
int launch(Kernel kern, int b, const Params& P, cudaStream_t s,
           Args... args) {
  const dim3 grid((P.w + kBlockX - 1) / kBlockX,
                  (P.h + kBlockY - 1) / kBlockY, b * P.d);
  kern<<<grid, dim3(kBlockX, kBlockY), 0, s>>>(args...);
  return fnk::launch_status();
}

}  // namespace

// `parts`: 1 the scalar (K), 2 the velocity (M), 3 both (L); the velocity
// alone never traces; `orig` (b, 3, d, h, w), the field M advects in place
// of U, or null (only M takes one). wm, hm, dm are float32(w - 1e-5),
// float32(h - 1e-5), float32(d - 1e-5); slack the trace box's margin
// (ops/line_trace3.py::firsthit_slack3). Scratch: b*d*h*w floats times 4
// for K, 3 for M, 7 for L. rho and rho_out may be null without the scalar,
// U_out without the velocity.
extern "C" int fn_advect3_forward(int parts, const float* rho,
                                  const float* U, const float* orig,
                                  const int* flags,
                                  float* scratch, int b, int d, int h, int w,
                                  float dt, float wm, float hm, float dm,
                                  float slack, int D, int line_trace,
                                  void* stream) {
  if (bad_shape(b, d, h, w, D) || (orig && parts != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P = make_params(d, h, w, dt, 0.f, wm, hm, dm, slack, D);
  cudaStream_t s = (cudaStream_t)stream;
  const bool tr = line_trace != 0;
  if (parts == 1)
    return tr ? launch(advect3_forward<true, false, true>, b, P, s, rho, U,
                       flags, scratch, P)
              : launch(advect3_forward<true, false, false>, b, P, s, rho, U,
                       flags, scratch, P);
  if (parts == 2)
    return launch_vel3<false>(U, orig, flags, nullptr, scratch, b, P, s);
  if (parts == 3)
    return tr ? launch(advect3_forward<true, true, true>, b, P, s, rho, U,
                       flags, scratch, P)
              : launch(advect3_forward<true, true, false>, b, P, s, rho, U,
                       flags, scratch, P);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fn_advect3_backward(int parts, const float* rho,
                                   const float* U, const float* orig,
                                   const int* flags,
                                   const float* scratch, float* rho_out,
                                   float* U_out, int b, int d, int h, int w,
                                   float dt, float halfstr, float wm,
                                   float hm, float dm, float slack, int D,
                                   int line_trace, void* stream) {
  if (bad_shape(b, d, h, w, D) || (orig && parts != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P = make_params(d, h, w, dt, halfstr, wm, hm, dm, slack, D);
  cudaStream_t s = (cudaStream_t)stream;
  const bool tr = line_trace != 0;
  if (parts == 1)
    return tr ? launch(advect3_backward<true, false, true>, b, P, s, rho, U,
                       flags, scratch, rho_out, U_out, P)
              : launch(advect3_backward<true, false, false>, b, P, s, rho, U,
                       flags, scratch, rho_out, U_out, P);
  if (parts == 2)
    return launch_vel3<true>(U, orig, flags, scratch, U_out, b, P, s);
  if (parts == 3)
    return tr ? launch(advect3_backward<true, true, true>, b, P, s, rho, U,
                       flags, scratch, rho_out, U_out, P)
              : launch(advect3_backward<true, true, false>, b, P, s, rho, U,
                       flags, scratch, rho_out, U_out, P);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The largest max_disp kernel M's rings are built for, without orig (0)
// or with it (1). Launches nothing.
extern "C" int fn_advect3_velocity_max_disp(int orig) {
  return orig ? kVMaxDOrig : kVMaxD;
}

// Bytes of dynamic shared memory a block of M's backward march takes at
// max_disp D without orig (0) or with it (1); 0 for a D it is not built
// for. Launches nothing.
extern "C" int fn_advect3_velocity_smem(int D, int orig) {
  if (orig) {
    switch (D) {
      case 1: return (int)march_bytes<1, true, true>();
      case 2: return (int)march_bytes<2, true, true>();
      case 3: return (int)march_bytes<3, true, true>();
    }
    return 0;
  }
  switch (D) {
    case 1: return (int)march_bytes<1, true, false>();
    case 2: return (int)march_bytes<2, true, false>();
    case 3: return (int)march_bytes<3, true, false>();
    case 4: return (int)march_bytes<4, true, false>();
  }
  return 0;
}
