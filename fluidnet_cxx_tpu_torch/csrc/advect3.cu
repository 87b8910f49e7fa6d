// Kernels K, L and M: 3-D MacCormack advection on the window engine.
//
//   K  the scalar alone; replaces fluidnet_cxx_tpu/ops/pallas/
//      advect3_pallas.py::advect_scalar3_pallas (body
//      _advect_scalar3_kernel);
//   L  scalar + MAC velocity from the same pre-advection U; replaces
//      advect3_pallas.py::advect_all3_pallas (body _advect_all3_kernel);
//   M  the MAC velocity alone; replaces advect3_pallas.py::
//      advect_velocity3_pallas (body _advect_vel3_kernel).
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
// out, 24 B a cell; L: 36 B; M: 28 B, ~0.015-0.023 ms at 128^3); the
// trilinear samples and clamps are ~150 operations a cell per half and
// the trace three slab tests (~30 operations) per blocked cell it tests,
// well under the fp32 rate. What holds it back is latency and issue: each
// cell gathers ~60-160 values from L1/L2 and, with the trace, walks its
// obstacles, with 4-8 blocks of 256 threads an SM.
//
// Design: one thread per cell, x fastest, 32 x 8 cells of one z-plane a
// block, reading neighbourhoods straight from global memory (L1/L2). Two
// launches, because the backward samples read the forward field at
// neighbours up to D cells away, which other blocks write, and no block
// waits on another:
//   launch 1 (forward): rho_fwd and its back-traced position (scalar
//            half), u_fwd, v_fwd and w_fwd (velocity half) into scratch;
//   launch 2 (backward): backward samples, MacCormack correction, clamps,
//            border zeroing, outputs.
// One template serves K, L and M: kScalar and kVel choose the halves, so
// all three run the same device functions and agree bit for bit; kTrace
// compiles the trace only into the kernels that run it, so the others keep
// their registers; each kernel has the register budget that ran fastest
// (min_blocks). Built with -fmad=false in the plain versions' float32
// order. Staging a block's flags in shared memory (a byte or a bit a
// cell, one plane a block or a 16-plane march) was built and was slower
// on the card: the pruned walk reads a few flags a ray, which L1 holds
// already, and the tile's loads and barrier cost more than they save.
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

// Trilinear sample of one sample's field f at an absolute position,
// after the window clamp around centre c: pos-0.5, trunc, weights clamped
// to [0, 1], lower corner clamped to [0, dim-2]; lerp along x, then y,
// then z (ops/window3.py::interpol_window3).
__device__ float trilinear(const float* f, const Params& P, const float c[3],
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
    size_t r0 = idx3(P, lo[0], lo[1], lo[2] + k);
    size_t r1 = r0 + P.w;
    float v0 = a0[0] * f[r0] + a1[0] * f[r0 + 1];
    float v1 = a0[0] * f[r1] + a1[0] * f[r1 + 1];
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

// 0.25 * (((a[i] + a[i+o1]) + a[i+o2]) + a[i+o3]) with signed offsets.
__device__ __forceinline__ float avg4(const float* a, long long i,
                                      long long o1, long long o2,
                                      long long o3) {
  return 0.25f * (((a[i] + a[i + o1]) + a[i + o2]) + a[i + o3]);
}

// The full velocity vector at the face of component c
// (ops3d.mac_vectors3), zero on the border shell.
__device__ void mac_vector(const float* const U3[3], const Cell& C, int c,
                           float m[3]) {
  if (!C.in) {
    m[0] = m[1] = m[2] = 0.f;
    return;
  }
  const long long sx = 1, sy = (long long)C.s[1], sz = (long long)C.s[2];
  const long long i = (long long)C.i;
  const float *u = U3[0], *v = U3[1], *W = U3[2];
  if (c == 0) {
    m[0] = u[i];
    m[1] = avg4(v, i, -sx, sy, sy - sx);
    m[2] = avg4(W, i, -sx, sz, sz - sx);
  } else if (c == 1) {
    m[0] = avg4(u, i, -sy, sx, sx - sy);
    m[1] = v[i];
    m[2] = avg4(W, i, -sy, sz, sz - sy);
  } else {
    m[0] = avg4(u, i, -sz, sx, sx - sz);
    m[1] = avg4(v, i, -sz, sy, sy - sz);
    m[2] = W[i];
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
__device__ __forceinline__ float sl(const float* f, const Cell& C,
                                    const float c[3], const float pos[3],
                                    const Params& P) {
  float val = C.fluid ? trilinear(f, P, c, pos) : f[C.i];
  return C.in ? val : 0.f;
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
        sl(rho + (size_t)b * C.n, C, c, back, P);
    for (int a = 0; a < 3; ++a)
      scratch[plane(1 + a, b, nb, C.n) + C.i] = C.fluid ? back[a] : c[a];
  }
  if (kVel) {
    const int k = kScalar ? 4 : 0;
    for (int comp = 0; comp < 3; ++comp) {
      float m[3], pos[3];
      mac_vector(U3, C, comp, m);
      for (int a = 0; a < 3; ++a) pos[a] = c[a] - P.dt * m[a];
      scratch[plane(k + comp, b, nb, C.n) + C.i] = sl(U3[comp], C, c, pos, P);
    }
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
    float bwd = sl(s_fwd, C, c, back, P);
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
    const int dims[3] = {P.w, P.h, P.d};
    for (int comp = 0; comp < 3; ++comp) {
      if (!C.in) {
        uo[comp * C.n + C.i] = 0.f;
        continue;
      }
      const float* f_fwd = scratch + plane(k + comp, b, nb, C.n);
      const float* orig = U3[comp];
      float m[3], pos[3];
      mac_vector(U3, C, comp, m);
      for (int a = 0; a < 3; ++a) pos[a] = c[a] - (-P.dt) * m[a];
      float bwd = sl(f_fwd, C, c, pos, P);
      float fwd = f_fwd[C.i];
      bool skip = !C.fluid ||
                  (idx[comp] > 0 && flags[C.i - C.s[comp]] != kFluid);
      float dst = skip ? fwd : fwd + P.halfstr * (orig[C.i] - bwd);
      // Selle clamp: extrema of orig over the corners of idx -/+ m*dt.
      float vel[3];
      for (int a = 0; a < 3; ++a)
        vel[a] = fminf(fmaxf(m[a] * P.dt, (float)-P.D), (float)P.D);
      float mn = kInf, mx = -kInf;
      for (int s = 0; s < 2; ++s) {
        const float sgn = s ? 1.f : -1.f;
        int lo[3];
        for (int a = 0; a < 3; ++a)
          lo[a] = min(max((int)((float)idx[a] + sgn * vel[a]), 0),
                      dims[a] - 2);
        for (int dk = 0; dk <= 1; ++dk)
          for (int dj = 0; dj <= 1; ++dj)
            for (int di = 0; di <= 1; ++di) {
              float o = orig[idx3(P, lo[0] + di, lo[1] + dj, lo[2] + dk)];
              mn = fminf(mn, o);
              mx = fmaxf(mx, o);
            }
      }
      uo[comp * C.n + C.i] = fmaxf(fminf(dst, mx), mn);
    }
  }
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
// alone never traces. wm, hm, dm are float32(w - 1e-5), float32(h - 1e-5),
// float32(d - 1e-5); slack the trace box's margin
// (ops/line_trace3.py::firsthit_slack3). Scratch: b*d*h*w floats times 4
// for K, 3 for M, 7 for L. rho and rho_out may be null without the scalar,
// U_out without the velocity.
extern "C" int fn_advect3_forward(int parts, const float* rho,
                                  const float* U, const int* flags,
                                  float* scratch, int b, int d, int h, int w,
                                  float dt, float wm, float hm, float dm,
                                  float slack, int D, int line_trace,
                                  void* stream) {
  if (bad_shape(b, d, h, w, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Params P = make_params(d, h, w, dt, 0.f, wm, hm, dm, slack, D);
  cudaStream_t s = (cudaStream_t)stream;
  const bool tr = line_trace != 0;
  if (parts == 1)
    return tr ? launch(advect3_forward<true, false, true>, b, P, s, rho, U,
                       flags, scratch, P)
              : launch(advect3_forward<true, false, false>, b, P, s, rho, U,
                       flags, scratch, P);
  if (parts == 2)
    return launch(advect3_forward<false, true, false>, b, P, s, rho, U,
                  flags, scratch, P);
  if (parts == 3)
    return tr ? launch(advect3_forward<true, true, true>, b, P, s, rho, U,
                       flags, scratch, P)
              : launch(advect3_forward<true, true, false>, b, P, s, rho, U,
                       flags, scratch, P);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fn_advect3_backward(int parts, const float* rho,
                                   const float* U, const int* flags,
                                   const float* scratch, float* rho_out,
                                   float* U_out, int b, int d, int h, int w,
                                   float dt, float halfstr, float wm,
                                   float hm, float dm, float slack, int D,
                                   int line_trace, void* stream) {
  if (bad_shape(b, d, h, w, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Params P = make_params(d, h, w, dt, halfstr, wm, hm, dm, slack, D);
  cudaStream_t s = (cudaStream_t)stream;
  const bool tr = line_trace != 0;
  if (parts == 1)
    return tr ? launch(advect3_backward<true, false, true>, b, P, s, rho, U,
                       flags, scratch, rho_out, U_out, P)
              : launch(advect3_backward<true, false, false>, b, P, s, rho, U,
                       flags, scratch, rho_out, U_out, P);
  if (parts == 2)
    return launch(advect3_backward<false, true, false>, b, P, s, rho, U,
                  flags, scratch, rho_out, U_out, P);
  if (parts == 3)
    return tr ? launch(advect3_backward<true, true, true>, b, P, s, rho, U,
                       flags, scratch, rho_out, U_out, P)
              : launch(advect3_backward<true, true, false>, b, P, s, rho, U,
                       flags, scratch, rho_out, U_out, P);
  return static_cast<int>(cudaErrorInvalidValue);
}
