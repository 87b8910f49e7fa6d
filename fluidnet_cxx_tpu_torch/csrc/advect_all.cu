// Kernels A, D and E: MacCormack advection on the window engine.
//
//   A  scalar + MAC velocity from the same pre-advection U; replaces
//      fluidnet_cxx_tpu/ops/pallas/advect_pallas.py::advect_all_pallas
//      (body _advect_all_kernel);
//   D  the scalar alone; replaces advect_pallas.py::advect_scalar_pallas
//      (body _advect_scalar_kernel);
//   E  the MAC velocity alone; replaces advect_pallas.py::
//      advect_velocity_pallas (body _advect_vel_kernel).
//
// A and E take an optional `orig`, the field that U advects (the viscous
// field of a step with viscosity): the MAC velocity vectors come from U;
// the forward samples, the MacCormack correction and the Selle clamp's
// extrema from orig (orig == U when it is not given).
//
// Same semantics as the port's plain versions ops/advection.py
// (advect_scalar, advect_velocity; impl='window', first-hit trace): the
// back-traced position is clamped to the cell centre +- D, the fluid-aware
// bilinear of _interpol_fluid_window_tile, the scalar 3x3 clamp, the Selle
// clamp of _clamp_mac_tile and the border zeroing of _border_zero.
//
// What bounds them on an H100 (NVIDIA H100 80GB HBM3, 700 W): the bytes
// are few (A: rho, u, v, flags in and rho', u', v' out, 28 B a cell, 36 B
// with orig; D: rho, u, v, flags in, rho' out, 20 B; E: u, v, flags in,
// u', v' out, 20 B, and 28 B with orig); the time goes to issuing the
// per-cell gathers and their arithmetic (~40 values a cell for the
// velocity) and, for A and D, the first-hit trace. E is issue-bound on
// the card: a larger tile (less forward work in the halo) is faster at
// the same blocks an SM, and more blocks an SM help little.
//
// E: one launch, advect_tile, as the TPU kernel keeps a tile and its
// halo in VMEM. A block owns a tw x th output tile (the host's planner,
// ops/kernels/advect.py::plan_tile, picks the largest tile whose grid has
// a block for each of the 132 SMs: 64 x 32 on the 8000 x 800 cylinder,
// 64 x 16 at 512^2). Every value a cell reads lies within a fixed halo of
// it (the window-clamped bilinear corners [c - D, c + D + 1], the Selle
// corners, the MAC neighbours), so the block copies by cp.async, 16 bytes
// a copy where rows allow,
//   orig (U without orig) over the tile - 2D .. + 2D + 2 (kInHalo): the
//            forward samples of every cell the backward reads;
//   the fluid bytes (one a cell, by hand) over the tile - D .. + D + 1
//            (kFwdHalo);
// computes the forward field (u_fwd, v_fwd) over kFwdHalo into shared
// memory, each cell once a block (the halo's cells again in the
// neighbouring blocks: 1.46x the forward work at 64 x 32 and D = 4),
// passes one barrier, and runs the backward samples, the correction and
// the Selle clamp of its own cells from shared memory alone. With orig
// given, U's MAC vectors (read at fixed neighbours, coalesced) come from
// global memory. No scratch plane goes to device memory: each input is
// read from device memory about once (its halo again from L2) and each
// output written once. 60,660 bytes of shared memory a block at 64 x 32
// and D = 4 and 78 registers a thread (three blocks an SM), 88,668 bytes
// at the built limit kMaxD = 8.
//
// A and D: two launches (advect_forward, advect_backward; one thread a
// cell reading its neighbourhood straight from global memory, L1/L2):
//   launch 1 (forward): rho_fwd and its back-traced position, and (A)
//            u_fwd and v_fwd, into scratch planes;
//   launch 2 (backward): backward samples, MacCormack correction, clamps,
//            border zeroing, outputs.
// A's scalar half traces from every cell of the forward region, so a
// one-launch A (the tile above with the scalar half, built and timed on
// the card) recomputes the trace over the halo; at the 512^2 and
// 128 x 512 main paths, where the scratch planes stay in L2, that cost
// more than the round trip saves, and A keeps two launches.
//
// All three run the same device functions on accessors (GridIn and
// GridFluid for global memory, TileField and TileFluid for shared memory),
// so they agree bit for bit with the plain versions, built with
// -fmad=false in their float32 order. E's tiles are built for every max_disp 1..kMaxD;
// its wrapper refuses a larger D, and so do D's entries and wrapper (D's
// backward over shared-memory tiles, built and timed on the card, lost to
// these launches at the plume's sub-cell steps, PERF.md). A takes any D.
//
// The first-hit trace walks an exact pruned box instead of the whole
// (2D+1)^2 window, as kernels K and L do in 3-D (csrc/advect3.cu): a
// blocked cell can lower the stopping parameter t only if its expanded
// box meets the segment [c, c + t dir] at 0 <= t_in < t <= len, and a min
// is exact and order-free, so leaving out cells that cannot meet the
// segment changes no bit. The ray starts at the cell centre x + 0.5;
// along an axis with disp > 0 the cells behind it (o < 0) end at
// x + 1e-5 < c, so their exit t_hi < 0, and cells past floor(0.5 + disp
// + slack) start more than disp past c, so their entry t_lo >= len >= t;
// mirrored for disp < 0; for disp == 0 (or |dir| <= 1e-12) only the
// ray's own column has its coordinate inside the slab. The box is thus,
// per axis, [floor(0.5 + disp - slack), 0] or [0, floor(0.5 + disp +
// slack)] within [-D, D] and the grid. The domain's margin planes lie
// where the faces of the cells just outside the grid do, so a box inside
// the grid keeps t = len and only a box that reaches past the grid
// computes them. slack = 2^-12 + (max(h, w) + D) 2^-21 comes from the
// wrapper (ops/line_trace.py::firsthit_slack2): it covers the 1e-5
// margin, the rounding of lo = X - 1e-5 (half an ulp of X: 2^-12 at
// X = 8000, where the margin rounds away), of 0.5 + disp and of
// lo - (x + 0.5), and the few ulp of inv = 1/dir against len/disp, with
// more than 2^-12 - 1e-5 to spare at every coordinate below 2^23
// (tests/test_torch_trace_prune.py holds the walk to the full one bit for
// bit, also 8000 cells wide). The walk reads one fluid flag a cell of the
// box and runs the slab tests for blocked ones alone; the reciprocals
// 1/dir, the same values the plain version divides for each test, are
// taken once a ray, and only when a margin plane or a blocked cell needs
// them. The slab's upper face stays (lo + 1) + 2e-5, the plain version's
// expression.
#include "common.cuh"

namespace {
using namespace fnk;

constexpr float kHitMargin = 1e-5f;
constexpr float kEps = 1e-12f;
constexpr float kBig = 3e38f;
constexpr float kTwoMargin = 2e-5f;
#define kInf __int_as_float(0x7f800000)

// advect_tile's block: 32 x 8 threads; tile widths are multiples of 32
// and heights of 8. The largest max_disp the tiles are built for, and the
// shared memory a block may have (after the opt-in above 48 KB).
constexpr int kThreads = 256;
constexpr int kMaxD = 8;
constexpr int kSmemMax = 232448;

// A halo around the tile: `a` * D + `lo` cells before its first cell and
// `a` * D + `hi` after its last, on each axis.
struct Halo {
  int a, lo, hi;
};
constexpr Halo kInHalo{2, 0, 2};   // orig (U without orig)
constexpr Halo kFwdHalo{1, 0, 1};  // the forward field, the fluid bytes
// Columns a copied row starts and ends on: 16-byte copies of 4 cells.
constexpr int kAlign = 4;

// One region of shared memory: absolute origin (x0, y0), pitch w rows h.
struct Region {
  int x0, y0, w, h;
};

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// The cells of halo g around the tile at (X0, Y0); a copied region
// (`copied`) starts and ends its rows on multiples of kAlign columns (X0
// is a multiple of 32).
__host__ __device__ inline Region region(Halo g, int X0, int Y0, int tw,
                                         int th, int D, bool copied) {
  const int before = g.a * D + g.lo, after = g.a * D + g.hi;
  const int left = copied ? round_up(before, kAlign) : before;
  const int right = copied ? round_up(after, kAlign) : after;
  return Region{X0 - left, Y0 - before, tw + left + right,
                th + before + after};
}

// The shared memory of one advect_tile block: orig's u and v copied over
// kInHalo, u_fwd and v_fwd over kFwdHalo (4-byte words), then the fluid
// bytes over kFwdHalo, widened as a copied region.
struct Layout {
  int orig, fwd, fluid, bytes;
};

__host__ __device__ inline Layout layout(int tw, int th, int D) {
  const Region in = region(kInHalo, 0, 0, tw, th, D, true);
  const Region fw = region(kFwdHalo, 0, 0, tw, th, D, false);
  const Region fl = region(kFwdHalo, 0, 0, tw, th, D, true);
  Layout L;
  L.orig = 0;
  L.fwd = L.orig + 2 * in.w * in.h;
  L.fluid = L.fwd + 2 * fw.w * fw.h;
  L.bytes = 4 * L.fluid + fl.w * fl.h;
  return L;
}

struct Params {
  int h, w, D, sample_outside;
  float dt, halfstr, wm, hm;
  float slack;  // the pruned trace box's margin (see the note above)
};

// One sample's field in global memory, read at cells inside the grid
// (every read is: the window-clamped corners are, and the scalar's 3x3
// clamp tests its cells).
struct GridIn {
  const float* a;
  int w;
  __device__ __forceinline__ float operator()(int x, int y) const {
    return __ldg(a + (size_t)y * w + x);
  }
};

// Fluid test of one sample's flags in global memory, at cells inside the
// grid (the trace box is clipped to it).
struct GridFluid {
  const int* f;
  int w;
  __device__ __forceinline__ bool operator()(int x, int y) const {
    return f[(size_t)y * w + x] == kFluid;
  }
};

// A region of shared memory read at absolute cells.
template <class T>
struct Tile {
  const T* s;
  int x0, y0, pitch;
  __device__ __forceinline__ T at(int x, int y) const {
    return s[(y - y0) * pitch + (x - x0)];
  }
};

struct TileField : Tile<float> {
  __device__ __forceinline__ float operator()(int x, int y) const {
    return at(x, y);
  }
};

struct TileFluid : Tile<uint8_t> {
  __device__ __forceinline__ bool operator()(int x, int y) const {
    return at(x, y) != 0;
  }
};

// Position clamp to the cell's own centre +- D (window semantics).
__device__ __forceinline__ float clamp_win(float p, float c, int D) {
  return fminf(fmaxf(p, c - (float)D), c + (float)D);
}

struct Corner {
  int x0, y0;
  float s0, s1, t0, t1;
};

__device__ __forceinline__ Corner corner(float px, float py, int h, int w) {
  Corner c;
  float qx = px - 0.5f, qy = py - 0.5f;
  int ix = (int)truncf(qx), iy = (int)truncf(qy);
  c.s1 = fminf(fmaxf(qx - (float)ix, 0.f), 1.f);
  c.t1 = fminf(fmaxf(qy - (float)iy, 0.f), 1.f);
  c.s0 = 1.f - c.s1;
  c.t0 = 1.f - c.t1;
  c.x0 = min(max(ix, 0), w - 2);
  c.y0 = min(max(iy, 0), h - 2);
  return c;
}

// Plain bilinear sample of f on an h x w grid at an already
// window-clamped position.
template <class F>
__device__ float bilinear(F f, int h, int w, float px, float py) {
  Corner c = corner(px, py, h, w);
  float va = f(c.x0, c.y0), vb = f(c.x0, c.y0 + 1);
  float vc = f(c.x0 + 1, c.y0), vd = f(c.x0 + 1, c.y0 + 1);
  float r0 = c.s0 * va + c.s1 * vc;
  float r1 = c.s0 * vb + c.s1 * vd;
  return c.t0 * r0 + c.t1 * r1;
}

__device__ __forceinline__ float comb(float va, bool fa, float vb, bool fb,
                                      float ta, float tb, bool* ok) {
  *ok = fa || fb;
  if (!fa && !fb) return 0.f;
  if (!fa) return vb;
  if (!fb) return va;
  return va * ta + vb * tb;
}

// Fluid-aware bilinear: non-fluid corners are dropped; all four non-fluid
// falls back to the plain bilinear value.
template <class F, class Fl>
__device__ float bilinear_fluid(F f, Fl fluid, int h, int w, float px,
                                float py) {
  Corner c = corner(px, py, h, w);
  float va = f(c.x0, c.y0), vb = f(c.x0, c.y0 + 1);
  float vc = f(c.x0 + 1, c.y0), vd = f(c.x0 + 1, c.y0 + 1);
  bool fa = fluid(c.x0, c.y0);
  bool fb = fluid(c.x0, c.y0 + 1);
  bool fc = fluid(c.x0 + 1, c.y0);
  bool fd = fluid(c.x0 + 1, c.y0 + 1);
  bool fab, fcd, fval;
  float iab = comb(va, fa, vb, fb, c.t0, c.t1, &fab);
  float icd = comb(vc, fc, vd, fd, c.t0, c.t1, &fcd);
  float ival = comb(iab, fab, icd, fcd, c.s0, c.s1, &fval);
  if (fval) return ival;
  return (va * c.t0 + vb * c.t1) * c.s0 + (vc * c.t0 + vd * c.t1) * c.s1;
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
  float hi = (lo + 1.f) + kTwoMargin;
  float t1 = (lo - p0) * inv;
  float t2 = (hi - p0) * inv;
  bool in = p0 >= lo && p0 <= hi;
  *t_lo = ok ? fminf(t1, t2) : (in ? -kBig : kBig);
  *t_hi = ok ? fmaxf(t1, t2) : (in ? kBig : -kBig);
}

// Continuous first-hit trace from the centre (cx, cy) of fluid cell (x, y)
// along (dx, dy) (ops/line_trace.py::line_trace_firsthit) over the pruned
// box (see the note above).
template <class Fl>
__device__ void trace(int x, int y, float cx, float cy, float dx, float dy,
                      Fl fluid, const Params& P, float* bx, float* by) {
  float len = sqrtf(dx * dx + dy * dy);
  *bx = cx;
  *by = cy;
  if (!(len > kEps)) return;
  float inv_len = 1.f / fmaxf(len, kEps);
  float dirx = dx * inv_len, diry = dy * inv_len;
  const float ex = 0.5f + dx, ey = 0.5f + dy;
  int lox = x + (dx < 0.f ? max((int)floorf(ex - P.slack), -P.D) : 0);
  int hix = x + (dx > 0.f ? min((int)floorf(ex + P.slack), P.D) : 0);
  int loy = y + (dy < 0.f ? max((int)floorf(ey - P.slack), -P.D) : 0);
  int hiy = y + (dy > 0.f ? min((int)floorf(ey + P.slack), P.D) : 0);
  const bool edge = lox < 0 || hix >= P.w || loy < 0 || hiy >= P.h;
  lox = max(lox, 0);
  hix = min(hix, P.w - 1);
  loy = max(loy, 0);
  hiy = min(hiy, P.h - 1);
  bool okx = false, oky = false, have_inv = false;
  float invx = 1.f, invy = 1.f;
  auto reciprocals = [&]() {
    okx = fabsf(dirx) > kEps;
    oky = fabsf(diry) > kEps;
    invx = 1.f / (okx ? dirx : 1.f);
    invy = 1.f / (oky ? diry : 1.f);
    have_inv = true;
  };
  float t = len;
  if (edge) {
    reciprocals();
    t = fminf(fminf(border_t(cx, okx, invx, P.wm),
                    border_t(cy, oky, invy, P.hm)),
              len);
  }
  for (int Y = loy; Y <= hiy; ++Y)
    for (int X = lox; X <= hix; ++X) {
      if (fluid(X, Y)) continue;
      if (!have_inv) reciprocals();
      float txl, txh, tyl, tyh;
      slabs(cx, okx, invx, X, &txl, &txh);
      slabs(cy, oky, invy, Y, &tyl, &tyh);
      float t_in = fmaxf(txl, tyl), t_out = fminf(txh, tyh);
      if (t_in <= t_out && t_in >= 0.f) t = fminf(t, t_in);
    }
  t = fmaxf(t, 0.f);
  *bx = cx + t * dirx;
  *by = cy + t * diry;
}

// One scalar semi-Lagrangian sample of `field` with step sdt at (x, y);
// (bx, by) gets the back-traced position (kTrace: the first-hit trace).
template <bool kTrace, class F, class Fl>
__device__ float scalar_sl(F field, Fl fluid_at, bool fluid, int x, int y,
                           float ccx, float ccy, float sdt, const Params& P,
                           float* bx, float* by) {
  float cx = (float)x + 0.5f, cy = (float)y + 0.5f;
  float msdt = -sdt;
  float dx = fminf(fmaxf(msdt * ccx, (float)-P.D), (float)P.D);
  float dy = fminf(fmaxf(msdt * ccy, (float)-P.D), (float)P.D);
  if (kTrace && fluid) {
    trace(x, y, cx, cy, dx, dy, fluid_at, P, bx, by);
  } else if (kTrace) {
    *bx = cx;
    *by = cy;
  } else {
    *bx = cx + dx;
    *by = cy + dy;
  }
  if (!fluid) return field(x, y);
  float px = clamp_win(*bx, cx, P.D), py = clamp_win(*by, cy, P.D);
  return P.sample_outside
             ? bilinear(field, P.h, P.w, px, py)
             : bilinear_fluid(field, fluid_at, P.h, P.w, px, py);
}

// The landing cell of the scalar's forward position (bx, by) of cell
// (x, y), for its 3x3 clamp: the window-clamped position truncated and
// clamped to the grid.
__device__ __forceinline__ void landing(float bx, float by, int x, int y,
                                        const Params& P, int* i0, int* j0) {
  float px = clamp_win(bx, (float)x + 0.5f, P.D);
  float py = clamp_win(by, (float)y + 0.5f, P.D);
  *i0 = min(max((int)truncf(px), 0), P.w - 1);
  *j0 = min(max((int)truncf(py), 0), P.h - 1);
}

// The scalar's MacCormack result at interior-or-border cell (x, y): the
// correction of fwd by src - bwd in fluid cells, then (interior cells) the
// clamp to the extrema of src over the fluid cells (any cell with
// sample_outside) of the 3x3 around the landing cell (i0, j0); the
// forward value where none qualifies.
template <class F, class Fl>
__device__ float scalar_result(F src, Fl fluid_at, bool fluid, bool in,
                               int x, int y, float fwd, float bwd, int i0,
                               int j0, const Params& P) {
  float dst = fluid ? fwd + P.halfstr * (src(x, y) - bwd) : fwd;
  if (!in) return dst;
  float mn = kInf, mx = -kInf;
  int cnt = 0;
  for (int dj = -1; dj <= 1; ++dj)
    for (int di = -1; di <= 1; ++di) {
      int X = i0 + di, Y = j0 + dj;
      if (!inside(X, Y, P.h, P.w)) continue;
      if (!P.sample_outside && !fluid_at(X, Y)) continue;
      float s = src(X, Y);
      mn = fminf(mn, s);
      mx = fmaxf(mx, s);
      ++cnt;
    }
  return cnt >= 1 ? fmaxf(mn, fminf(mx, dst)) : fwd;
}

// Face velocity vectors at interior cell (x, y) from U's components u, v
// (accessors): MAC-x (mxu, mxv) and MAC-y (myu, myv).
template <class F>
__device__ __forceinline__ void mac_vectors(F u, F v, int x, int y,
                                            float* mxu, float* mxv,
                                            float* myu, float* myv) {
  *mxu = u(x, y);
  *myv = v(x, y);
  *mxv = 0.25f * (((v(x, y) + v(x - 1, y)) + v(x, y + 1)) + v(x - 1, y + 1));
  *myu = 0.25f * (((u(x, y) + u(x, y - 1)) + u(x + 1, y)) + u(x + 1, y - 1));
}

// Semi-Lagrangian sample of f at the interior cell (x, y) along (vx, vy):
// the window-clamped bilinear in fluid cells, f there in the others. The
// sample is taken in every cell (its corners lie in the grid), so the u
// and v chains of a cell hold no branch and interleave.
template <class F>
__device__ __forceinline__ float vel_sl(F f, bool fluid, int x, int y,
                                        float vx, float vy, float sdt,
                                        const Params& P) {
  float cx = (float)x + 0.5f, cy = (float)y + 0.5f;
  float msdt = -sdt;
  float px = cx + msdt * vx, py = cy + msdt * vy;
  const float s = bilinear(f, P.h, P.w, clamp_win(px, cx, P.D),
                           clamp_win(py, cy, P.D));
  return fluid ? s : f(x, y);
}

// Selle clamp of dst to the extrema of orig over the bilinear corners of
// the integer positions (x, y) -/+ vel*dt.
template <class F>
__device__ float selle(float dst, F orig, int x, int y, float vdx, float vdy,
                       const Params& P) {
  const int D = P.D;
  float vx = fminf(fmaxf(vdx, (float)-D), (float)D);
  float vy = fminf(fmaxf(vdy, (float)-D), (float)D);
  float mn = kInf, mx = -kInf;
  for (int s = -1; s <= 1; s += 2) {
    float sx = s < 0 ? -vx : vx, sy = s < 0 ? -vy : vy;
    int i0 = min(max((int)((float)x + sx), 0), P.w - 2);
    int j0 = min(max((int)((float)y + sy), 0), P.h - 2);
    for (int dj = 0; dj <= 1; ++dj)
      for (int di = 0; di <= 1; ++di) {
        float o = orig(i0 + di, j0 + dj);
        mn = fminf(mn, o);
        mx = fmaxf(mx, o);
      }
  }
  return fmaxf(fminf(dst, mx), mn);
}

// The velocity's MacCormack result at interior cell (x, y), both
// components: the forward field (fu, fv) sampled at c + dt * each face's
// MAC vector, the correction by orig - bwd unless the face does not lie
// between fluid cells (skip_u, skip_v), and the Selle clamp to orig's
// extrema. Each stage runs for both components before the next, so their
// chains interleave.
template <class F, class O>
__device__ __forceinline__ void vel_result(F fu, F fv, O ou, O ov,
                                           bool fluid, bool skip_u,
                                           bool skip_v, int x, int y,
                                           float mxu, float mxv, float myu,
                                           float myv, const Params& P,
                                           float* ru, float* rv) {
  const float bu = vel_sl(fu, fluid, x, y, mxu, mxv, -P.dt, P);
  const float bv = vel_sl(fv, fluid, x, y, myu, myv, -P.dt, P);
  const float f_u = fu(x, y), f_v = fv(x, y);
  const float du = skip_u ? f_u : f_u + P.halfstr * (ou(x, y) - bu);
  const float dv = skip_v ? f_v : f_v + P.halfstr * (ov(x, y) - bv);
  *ru = selle(du, ou, x, y, mxu * P.dt, mxv * P.dt, P);
  *rv = selle(dv, ov, x, y, myu * P.dt, myv * P.dt, P);
}

// 4-byte (zero-filled unless `on`) and 16-byte copies into shared memory.
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The row and the kAlign-cell chunk of chunk e of region R: e / (R.w /
// kAlign), exact (e < 2^16, R.w < 2^9).
__device__ __forceinline__ void chunk_of(int e, const Region& R, float inv,
                                         int* ly, int* lx) {
  *ly = (int)(((float)e + 0.5f) * inv);
  *lx = (e - *ly * (R.w / kAlign)) * kAlign;
}

// True when every row of the plane at g starts on 16 bytes.
__device__ __forceinline__ bool rows_aligned(const void* g, int w) {
  return w % kAlign == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
}

// Copy one plane of sample field g (h x w) over region R into shared
// memory s, zero off the grid: 16 bytes a chunk of kAlign cells inside
// the grid when rows start on 16 bytes, else cell by cell.
__device__ __forceinline__ void load_plane(float* s, const float* g,
                                           Region R, const Params& P,
                                           int tid) {
  const float inv = 1.f / (float)(R.w / kAlign);
  const bool vec = rows_aligned(g, P.w);
  for (int e = tid; e < R.w * R.h / kAlign; e += kThreads) {
    int ly, lx;
    chunk_of(e, R, inv, &ly, &lx);
    const int X = R.x0 + lx, Y = R.y0 + ly;
    float* dst = s + ly * R.w + lx;
    const float* src = g + (size_t)max(Y, 0) * P.w + X;
    if (vec && Y >= 0 && Y < P.h && X >= 0 && X + kAlign <= P.w) {
      cp_async16(dst, src);
    } else {
      for (int k = 0; k < kAlign; ++k) {
        const bool on = inside(X + k, Y, P.h, P.w);
        cp_async4_zfill(dst + k, on ? src + k : g, on);
      }
    }
  }
}

// The fluid bytes of one sample's flags over region R (0 off the grid),
// four cells a 32-bit store: a 16-byte load where rows start on 16 bytes.
__device__ __forceinline__ void load_fluid(uint8_t* s, const int* flags,
                                           Region R, const Params& P,
                                           int tid) {
  const float inv = 1.f / (float)(R.w / kAlign);
  const bool vec = rows_aligned(flags, P.w);
  for (int e = tid; e < R.w * R.h / kAlign; e += kThreads) {
    int ly, lx;
    chunk_of(e, R, inv, &ly, &lx);
    const int X = R.x0 + lx, Y = R.y0 + ly;
    int f[kAlign];
    if (vec && Y >= 0 && Y < P.h && X >= 0 && X + kAlign <= P.w) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          flags + (size_t)Y * P.w + X));
      f[0] = v.x;
      f[1] = v.y;
      f[2] = v.z;
      f[3] = v.w;
    } else {
      for (int k = 0; k < kAlign; ++k) f[k] = ldf(flags, X + k, Y, P.h, P.w);
    }
    unsigned packed = 0;
    for (int k = 0; k < kAlign; ++k)
      packed |= (unsigned)(f[k] == kFluid) << (8 * k);
    *reinterpret_cast<unsigned*>(s + ly * R.w + lx) = packed;
  }
}

// Kernel E: one block a tw x th tile, see the note above. With `orig`
// given (own_u), U's MAC vectors, read at fixed neighbours (coalesced),
// come from global memory; else U is orig's copy in shared memory. Grid:
// x and y tiles, b samples.
__global__ void __launch_bounds__(kThreads, 3)
    advect_tile(const float* __restrict__ U, const float* __restrict__ orig,
                const int* __restrict__ flags_all, float* __restrict__ U_out,
                Params P, int tw, int th, bool own_u) {
  extern __shared__ float smem[];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int b = blockIdx.z;
  const int h = P.h, w = P.w;
  const size_t n = (size_t)h * w;
  const int X0 = blockIdx.x * tw, Y0 = blockIdx.y * th;
  const Layout L = layout(tw, th, P.D);
  const Region rin = region(kInHalo, X0, Y0, tw, th, P.D, true);
  const Region rfw = region(kFwdHalo, X0, Y0, tw, th, P.D, false);
  const Region rfl = region(kFwdHalo, X0, Y0, tw, th, P.D, true);
  const float* ou = orig + b * 2 * n;
  uint8_t* const sfluid = reinterpret_cast<uint8_t*>(smem + L.fluid);

  // ---- copies: orig by cp.async, the fluid bytes by hand ----
  const int nin = rin.w * rin.h, nf = rfw.w * rfw.h;
  load_plane(smem + L.orig, ou, rin, P, tid);
  load_plane(smem + L.orig + nin, ou + n, rin, P, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  load_fluid(sfluid, flags_all + b * n, rfl, P, tid);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const TileField Ou{{smem + L.orig, rin.x0, rin.y0, rin.w}};
  const TileField Ov{{smem + L.orig + nin, rin.x0, rin.y0, rin.w}};
  const TileFluid Fl{{sfluid, rfl.x0, rfl.y0, rfl.w}};
  const GridIn Gu{U + b * 2 * n, w}, Gv{U + b * 2 * n + n, w};
  float* const sfu = smem + L.fwd;
  float* const sfv = sfu + nf;

  // U's MAC vectors at interior cell (x, y).
  auto mac = [&](int x, int y, float* mxu, float* mxv, float* myu,
                 float* myv) {
    if (own_u)
      mac_vectors(Gu, Gv, x, y, mxu, mxv, myu, myv);
    else
      mac_vectors(Ou, Ov, x, y, mxu, mxv, myu, myv);
  };

  // ---- forward over the tile - D .. + D + 1 ----
  const float inv_fw = 1.f / (float)rfw.w;
  for (int e = tid; e < nf; e += kThreads) {
    // e / rfw.w, exact: e < 2^16 and rfw.w < 2^8.
    const int ly = (int)(((float)e + 0.5f) * inv_fw), lx = e - ly * rfw.w;
    const int x = rfw.x0 + lx, y = rfw.y0 + ly;
    if (!inside(x, y, h, w)) continue;
    const bool fluid = Fl(x, y);
    float su = 0.f, sv = 0.f;
    if (interior(x, y, h, w)) {
      float mxu, mxv, myu, myv;
      mac(x, y, &mxu, &mxv, &myu, &myv);
      su = vel_sl(Ou, fluid, x, y, mxu, mxv, P.dt, P);
      sv = vel_sl(Ov, fluid, x, y, myu, myv, P.dt, P);
    }
    sfu[e] = su;
    sfv[e] = sv;
  }
  __syncthreads();

  // ---- backward, correction and Selle clamp of the tile's own cells ----
  const TileField Fu{{sfu, rfw.x0, rfw.y0, rfw.w}};
  const TileField Fv{{sfv, rfw.x0, rfw.y0, rfw.w}};
  float* uo = U_out + b * 2 * n;
  for (int oy = threadIdx.y; oy < th; oy += kThreads / 32)
    for (int ox = threadIdx.x; ox < tw; ox += 32) {
      const int x = X0 + ox, y = Y0 + oy;
      if (x >= w || y >= h) continue;
      const size_t i = (size_t)y * w + x;
      const bool fluid = Fl(x, y);
      if (!interior(x, y, h, w)) {
        uo[i] = 0.f;
        uo[n + i] = 0.f;
        continue;
      }
      float ru, rv, mxu, mxv, myu, myv;
      mac(x, y, &mxu, &mxv, &myu, &myv);
      vel_result(Fu, Fv, Ou, Ov, fluid, !fluid || !Fl(x - 1, y),
                 !fluid || !Fl(x, y - 1), x, y, mxu, mxv, myu, myv, P, &ru,
                 &rv);
      uo[i] = ru;
      uo[n + i] = rv;
    }
}

// ---- Kernels A and D: two launches over global memory ----

// Scratch plane k of sample b: the scalar half uses planes 0-2 (rho_fwd,
// the back-traced x and y), the velocity half the next two (u_fwd, v_fwd).
__device__ __forceinline__ size_t plane(int k, int b, int nb, int n) {
  return (size_t)(k * nb + b) * n;
}

template <bool kScalar, bool kVel, bool kTrace>
__global__ void advect_forward(const float* __restrict__ rho,
                               const float* __restrict__ U,
                               const float* __restrict__ orig,
                               const int* __restrict__ flags_all,
                               float* __restrict__ scratch, Params P) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  int h = P.h, w = P.w, n = h * w;
  if (x >= w || y >= h) return;
  const float* u = U + (size_t)b * 2 * n;
  const float* v = u + n;
  const int* flags = flags_all + (size_t)b * n;
  int nb = gridDim.z;
  int i = y * w + x;
  bool fluid = flags[i] == kFluid;
  bool in = interior(x, y, h, w);

  if (kScalar) {
    float ccx = in ? 0.5f * (u[i] + u[i + 1]) : 0.f;
    float ccy = in ? 0.5f * (v[i] + v[i + w]) : 0.f;
    float bx, by;
    float f = scalar_sl<kTrace>(GridIn{rho + (size_t)b * n, w},
                                GridFluid{flags, w}, fluid, x, y, ccx, ccy,
                                P.dt, P, &bx, &by);
    scratch[plane(0, b, nb, n) + i] = in ? f : 0.f;
    scratch[plane(1, b, nb, n) + i] = fluid ? bx : (float)x + 0.5f;
    scratch[plane(2, b, nb, n) + i] = fluid ? by : (float)y + 0.5f;
  }
  if (kVel) {
    const int k = kScalar ? 3 : 0;
    const float* ou = orig + (size_t)b * 2 * n;
    float su = 0.f, sv = 0.f;
    if (in) {
      float mxu, mxv, myu, myv;
      mac_vectors(GridIn{u, w}, GridIn{v, w}, x, y, &mxu, &mxv, &myu, &myv);
      su = vel_sl(GridIn{ou, w}, fluid, x, y, mxu, mxv, P.dt, P);
      sv = vel_sl(GridIn{ou + n, w}, fluid, x, y, myu, myv, P.dt, P);
    }
    scratch[plane(k, b, nb, n) + i] = su;
    scratch[plane(k + 1, b, nb, n) + i] = sv;
  }
}

template <bool kScalar, bool kVel, bool kTrace>
__global__ void advect_backward(const float* __restrict__ rho,
                                const float* __restrict__ U,
                                const float* __restrict__ orig,
                                const int* __restrict__ flags_all,
                                const float* __restrict__ scratch,
                                float* __restrict__ rho_out,
                                float* __restrict__ U_out, Params P) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  int h = P.h, w = P.w, n = h * w;
  if (x >= w || y >= h) return;
  const float* u = U + (size_t)b * 2 * n;
  const float* v = u + n;
  const int* flags = flags_all + (size_t)b * n;
  int nb = gridDim.z;
  int i = y * w + x;
  bool fluid = flags[i] == kFluid;
  bool in = interior(x, y, h, w);

  // ---- scalar: backward sample, correction, 3x3 fluid clamp ----
  if (kScalar) {
    const float* s_fwd = scratch + plane(0, b, nb, n);
    const GridFluid fl{flags, w};
    float ccx = in ? 0.5f * (u[i] + u[i + 1]) : 0.f;
    float ccy = in ? 0.5f * (v[i] + v[i + w]) : 0.f;
    float bx, by;
    float bwd = scalar_sl<kTrace>(GridIn{s_fwd, w}, fl, fluid, x, y, ccx,
                                  ccy, -P.dt, P, &bx, &by);
    bwd = in ? bwd : 0.f;
    int i0 = 0, j0 = 0;
    if (in)
      landing(scratch[plane(1, b, nb, n) + i],
              scratch[plane(2, b, nb, n) + i], x, y, P, &i0, &j0);
    rho_out[(size_t)b * n + i] =
        scalar_result(GridIn{rho + (size_t)b * n, w}, fl, fluid, in, x, y,
                      s_fwd[i], bwd, i0, j0, P);
  }

  // ---- velocity: backward samples, skip-masked correction, Selle ----
  if (kVel) {
    const int k = kScalar ? 3 : 0;
    const float* ou = orig + (size_t)b * 2 * n;
    float* uo = U_out + (size_t)b * 2 * n;
    float ru = 0.f, rv = 0.f;
    if (in) {
      float mxu, mxv, myu, myv;
      mac_vectors(GridIn{u, w}, GridIn{v, w}, x, y, &mxu, &mxv, &myu, &myv);
      const bool skip_u = !fluid || flags[i - 1] != kFluid;
      const bool skip_v = !fluid || flags[i - w] != kFluid;
      vel_result(GridIn{scratch + plane(k, b, nb, n), w},
                 GridIn{scratch + plane(k + 1, b, nb, n), w}, GridIn{ou, w},
                 GridIn{ou + n, w}, fluid, skip_u, skip_v, x, y, mxu, mxv,
                 myu, myv, P, &ru, &rv);
    }
    uo[i] = ru;
    uo[n + i] = rv;
  }
}

Params make_params(int h, int w, float dt, float halfstr, float wm, float hm,
                   float slack, int D, int sample_outside) {
  Params P;
  P.h = h;
  P.w = w;
  P.D = D;
  P.sample_outside = sample_outside;
  P.dt = dt;
  P.halfstr = halfstr;
  P.wm = wm;
  P.hm = hm;
  P.slack = slack;
  return P;
}

const dim3 kBlock(32, 8);

bool bad_shape(int b, int h, int w, int D) {
  return b < 1 || b > 65535 || h < 2 || w < 2 || D < 1;
}

bool bad_tile(int D, int tw, int th) {
  return D > kMaxD || tw < 32 || tw % 32 || th < 8 || th % 8 || tw > 128 ||
         th > 64;
}

}  // namespace

// wm/hm are float32(w - 1e-5), float32(h - 1e-5); slack the trace box's
// margin (ops/line_trace.py::firsthit_slack2); `orig` may be null (U
// advects itself). Scratch: 5*b*h*w floats for A, 3 for D.

// ---- A: scalar + velocity, two launches ----
extern "C" int fn_advect_forward(const float* rho, const float* U,
                                 const float* orig, const int* flags,
                                 float* scratch, int b, int h, int w,
                                 float dt, float wm, float hm, float slack,
                                 int D, int line_trace, int sample_outside,
                                 void* stream) {
  if (bad_shape(b, h, w, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Params P = make_params(h, w, dt, 0.f, wm, hm, slack, D,
                               sample_outside);
  const dim3 grid = grid2d(b, h, w, kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  const float* o = orig ? orig : U;
  if (line_trace)
    advect_forward<true, true, true><<<grid, kBlock, 0, s>>>(rho, U, o, flags,
                                                             scratch, P);
  else
    advect_forward<true, true, false><<<grid, kBlock, 0, s>>>(
        rho, U, o, flags, scratch, P);
  return fnk::launch_status();
}

extern "C" int fn_advect_backward(const float* rho, const float* U,
                                  const float* orig, const int* flags,
                                  const float* scratch, float* rho_out,
                                  float* U_out, int b, int h, int w,
                                  float dt, float halfstr, float wm,
                                  float hm, float slack, int D,
                                  int line_trace, int sample_outside,
                                  void* stream) {
  if (bad_shape(b, h, w, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Params P = make_params(h, w, dt, halfstr, wm, hm, slack, D,
                               sample_outside);
  const dim3 grid = grid2d(b, h, w, kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  const float* o = orig ? orig : U;
  if (line_trace)
    advect_backward<true, true, true><<<grid, kBlock, 0, s>>>(
        rho, U, o, flags, scratch, rho_out, U_out, P);
  else
    advect_backward<true, true, false><<<grid, kBlock, 0, s>>>(
        rho, U, o, flags, scratch, rho_out, U_out, P);
  return fnk::launch_status();
}

// ---- D: scalar alone, two launches ----
extern "C" int fn_advect_scalar_forward(const float* rho, const float* U,
                                        const int* flags, float* scratch,
                                        int b, int h, int w, float dt,
                                        float wm, float hm, float slack,
                                        int D, int line_trace,
                                        int sample_outside, void* stream) {
  if (bad_shape(b, h, w, D) || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P = make_params(h, w, dt, 0.f, wm, hm, slack, D,
                               sample_outside);
  const dim3 grid = grid2d(b, h, w, kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (line_trace)
    advect_forward<true, false, true><<<grid, kBlock, 0, s>>>(
        rho, U, nullptr, flags, scratch, P);
  else
    advect_forward<true, false, false><<<grid, kBlock, 0, s>>>(
        rho, U, nullptr, flags, scratch, P);
  return fnk::launch_status();
}

extern "C" int fn_advect_scalar_backward(const float* rho, const float* U,
                                         const int* flags,
                                         const float* scratch,
                                         float* rho_out, int b, int h, int w,
                                         float dt, float halfstr, float wm,
                                         float hm, float slack, int D,
                                         int line_trace, int sample_outside,
                                         void* stream) {
  if (bad_shape(b, h, w, D) || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P = make_params(h, w, dt, halfstr, wm, hm, slack, D,
                               sample_outside);
  const dim3 grid = grid2d(b, h, w, kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (line_trace)
    advect_backward<true, false, true><<<grid, kBlock, 0, s>>>(
        rho, U, nullptr, flags, scratch, rho_out, nullptr, P);
  else
    advect_backward<true, false, false><<<grid, kBlock, 0, s>>>(
        rho, U, nullptr, flags, scratch, rho_out, nullptr, P);
  return fnk::launch_status();
}

// ---- E: velocity alone, one launch over tw x th tiles ----
// (ops/kernels/advect.py::plan_tile; tw a multiple of 32 up to 128, th of
// 8 up to 64; max_disp up to kMaxD.)
extern "C" int fn_advect_velocity(const float* U, const float* orig,
                                  const int* flags, float* U_out, int b,
                                  int h, int w, float dt, float halfstr,
                                  int D, int tw, int th, void* stream) {
  if (bad_shape(b, h, w, D) || bad_tile(D, tw, th))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params P = make_params(h, w, dt, halfstr, 0.f, 0.f, 0.f, D, 0);
  const int bytes = layout(tw, th, D).bytes;
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      advect_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((w + tw - 1) / tw, (h + th - 1) / th, b);
  advect_tile<<<grid, kBlock, bytes, (cudaStream_t)stream>>>(
      U, orig ? orig : U, flags, U_out, P, tw, th, orig != nullptr);
  return fnk::launch_status();
}

// The largest max_disp kernel E's tiles are built for. Launches nothing.
extern "C" int fn_advect_max_disp() { return kMaxD; }

// Bytes of dynamic shared memory of one block of kernel E (0 for a tile
// or D it does not take). Launches nothing.
extern "C" int fn_advect_tile_smem(int tw, int th, int D) {
  if (bad_shape(1, 2, 2, D) || bad_tile(D, tw, th)) return 0;
  return layout(tw, th, D).bytes;
}
