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
// What bounds it on an H100: the bytes are few (A: rho, u, v, flags in and
// rho', u', v' out, 28 B a cell; D: rho, u, v, flags in, rho' out, 20 B;
// E: u, v, flags in, u', v' out, 20 B, and 28 B with orig); the time goes
// to the per-cell window work — up to (2D+1)^2 slab tests of the
// first-hit trace, run only for blocked cells in the window, twice per
// cell. Design: one thread per cell reading its window straight from
// global memory (the neighbourhood stays in L1/L2), two launches because
// the backward pass samples the forward field at neighbouring cells:
//   launch 1 (forward): rho_fwd and its back-traced position (scalar
//            half), u_fwd and v_fwd (velocity half) into scratch planes;
//   launch 2 (backward): backward samples, MacCormack correction, clamps,
//            border zeroing, outputs.
// One template serves A, D and E: kScalar and kVel choose the halves, so
// all three run the same device functions. No block waits on another;
// every loop is bounded by D.
#include "common.cuh"

namespace {
using namespace fnk;

constexpr float kHitMargin = 1e-5f;
constexpr float kEps = 1e-12f;
constexpr float kBig = 3e38f;
constexpr float kTwoMargin = 2e-5f;
#define kInf __int_as_float(0x7f800000)

struct Field {
  const float* a;
  int h, w;
  __device__ float at(int x, int y) const { return ld(a, x, y, h, w); }
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

// Plain bilinear sample at an already window-clamped position.
__device__ float bilinear(const Field& f, float px, float py) {
  Corner c = corner(px, py, f.h, f.w);
  float va = f.at(c.x0, c.y0), vb = f.at(c.x0, c.y0 + 1);
  float vc = f.at(c.x0 + 1, c.y0), vd = f.at(c.x0 + 1, c.y0 + 1);
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
__device__ float bilinear_fluid(const Field& f, const int* flags, float px,
                                float py) {
  Corner c = corner(px, py, f.h, f.w);
  int h = f.h, w = f.w;
  float va = f.at(c.x0, c.y0), vb = f.at(c.x0, c.y0 + 1);
  float vc = f.at(c.x0 + 1, c.y0), vd = f.at(c.x0 + 1, c.y0 + 1);
  bool fa = ldf(flags, c.x0, c.y0, h, w) == kFluid;
  bool fb = ldf(flags, c.x0, c.y0 + 1, h, w) == kFluid;
  bool fc = ldf(flags, c.x0 + 1, c.y0, h, w) == kFluid;
  bool fd = ldf(flags, c.x0 + 1, c.y0 + 1, h, w) == kFluid;
  bool fab, fcd, fval;
  float iab = comb(va, fa, vb, fb, c.t0, c.t1, &fab);
  float icd = comb(vc, fc, vd, fd, c.t0, c.t1, &fcd);
  float ival = comb(iab, fab, icd, fcd, c.s0, c.s1, &fval);
  if (fval) return ival;
  return (va * c.t0 + vb * c.t1) * c.s0 + (vc * c.t0 + vd * c.t1) * c.s1;
}

__device__ __forceinline__ float border_t(float p0, float d, float dim_m) {
  bool ok = fabsf(d) > kEps;
  float inv = 1.f / (ok ? d : 1.f);
  float t1 = (kHitMargin - p0) * inv;
  float t2 = (dim_m - p0) * inv;
  t1 = (ok && t1 >= 0.f) ? t1 : kBig;
  t2 = (ok && t2 >= 0.f) ? t2 : kBig;
  return fminf(t1, t2);
}

__device__ __forceinline__ void slabs(float p0, float d, float lo, float hi,
                                      float* t_lo, float* t_hi) {
  bool ok = fabsf(d) > kEps;
  float inv = 1.f / (ok ? d : 1.f);
  float t1 = (lo - p0) * inv;
  float t2 = (hi - p0) * inv;
  bool in = p0 >= lo && p0 <= hi;
  *t_lo = ok ? fminf(t1, t2) : (in ? -kBig : kBig);
  *t_hi = ok ? fmaxf(t1, t2) : (in ? kBig : -kBig);
}

// Continuous first-hit trace from the centre of fluid cell (x, y) along
// (dx, dy) (ops/line_trace.py::line_trace_firsthit).
__device__ void trace(int x, int y, float cx, float cy, float dx, float dy,
                      const int* flags, int h, int w, float wm, float hm,
                      int D, float* bx, float* by) {
  float len = sqrtf(dx * dx + dy * dy);
  *bx = cx;
  *by = cy;
  if (!(len > kEps)) return;
  float inv_len = 1.f / fmaxf(len, kEps);
  float dirx = dx * inv_len, diry = dy * inv_len;
  float t = fminf(border_t(cx, dirx, wm), border_t(cy, diry, hm));
  t = fminf(t, len);
  for (int oy = -D; oy <= D; ++oy) {
    int Y = y + oy;
    if (Y < 0 || Y >= h) continue;
    for (int ox = -D; ox <= D; ++ox) {
      int X = x + ox;
      if ((ox == 0 && oy == 0) || X < 0 || X >= w) continue;
      if (flags[Y * w + X] == kFluid) continue;
      float lox = (float)X - kHitMargin, loy = (float)Y - kHitMargin;
      float txl, txh, tyl, tyh;
      slabs(cx, dirx, lox, (lox + 1.f) + kTwoMargin, &txl, &txh);
      slabs(cy, diry, loy, (loy + 1.f) + kTwoMargin, &tyl, &tyh);
      float t_in = fmaxf(txl, tyl), t_out = fminf(txh, tyh);
      if (t_in <= t_out && t_in >= 0.f) t = fminf(t, t_in);
    }
  }
  t = fmaxf(t, 0.f);
  *bx = cx + t * dirx;
  *by = cy + t * diry;
}

struct Params {
  int h, w, D, line_trace, sample_outside;
  float dt, halfstr, wm, hm;
};

// One scalar semi-Lagrangian sample of `field` with step sdt at (x, y).
__device__ float scalar_sl(const Field& field, const int* flags, bool fluid,
                           int x, int y, float ccx, float ccy, float sdt,
                           const Params& P, float* bx, float* by) {
  float cx = (float)x + 0.5f, cy = (float)y + 0.5f;
  float msdt = -sdt;
  float dx = fminf(fmaxf(msdt * ccx, (float)-P.D), (float)P.D);
  float dy = fminf(fmaxf(msdt * ccy, (float)-P.D), (float)P.D);
  if (P.line_trace && fluid) {
    trace(x, y, cx, cy, dx, dy, flags, P.h, P.w, P.wm, P.hm, P.D, bx, by);
  } else if (P.line_trace) {
    *bx = cx;
    *by = cy;
  } else {
    *bx = cx + dx;
    *by = cy + dy;
  }
  if (!fluid) return field.at(x, y);
  float px = clamp_win(*bx, cx, P.D), py = clamp_win(*by, cy, P.D);
  return P.sample_outside ? bilinear(field, px, py)
                          : bilinear_fluid(field, flags, px, py);
}

// Face velocity vectors at (x, y): MAC-x (mxu, mxv) and MAC-y (myu, myv),
// zero on the border ring.
__device__ void mac_vectors(const float* u, const float* v, int x, int y,
                            int h, int w, float* mxu, float* mxv, float* myu,
                            float* myv) {
  if (!interior(x, y, h, w)) {
    *mxu = *mxv = *myu = *myv = 0.f;
    return;
  }
  *mxu = u[y * w + x];
  *myv = v[y * w + x];
  *mxv = 0.25f * (((v[y * w + x] + v[y * w + x - 1]) + v[(y + 1) * w + x]) +
                  v[(y + 1) * w + x - 1]);
  *myu = 0.25f * (((u[y * w + x] + u[(y - 1) * w + x]) + u[y * w + x + 1]) +
                  u[(y - 1) * w + x + 1]);
}

__device__ __forceinline__ float vel_sl(const Field& f, bool fluid, int x,
                                        int y, float vx, float vy, float sdt,
                                        int D) {
  if (!fluid) return f.at(x, y);
  float cx = (float)x + 0.5f, cy = (float)y + 0.5f;
  float msdt = -sdt;
  float px = cx + msdt * vx, py = cy + msdt * vy;
  return bilinear(f, clamp_win(px, cx, D), clamp_win(py, cy, D));
}

// Selle clamp of dst to the extrema of orig over the bilinear corners of
// the integer positions (x, y) -/+ vel*dt.
__device__ float selle(float dst, const Field& orig, int x, int y, float vdx,
                       float vdy, int D) {
  float vx = fminf(fmaxf(vdx, (float)-D), (float)D);
  float vy = fminf(fmaxf(vdy, (float)-D), (float)D);
  float mn = kInf, mx = -kInf;
  for (int s = -1; s <= 1; s += 2) {
    float sx = s < 0 ? -vx : vx, sy = s < 0 ? -vy : vy;
    int i0 = min(max((int)((float)x + sx), 0), orig.w - 2);
    int j0 = min(max((int)((float)y + sy), 0), orig.h - 2);
    for (int dj = 0; dj <= 1; ++dj)
      for (int di = 0; di <= 1; ++di) {
        float o = orig.at(i0 + di, j0 + dj);
        mn = fminf(mn, o);
        mx = fmaxf(mx, o);
      }
  }
  return fmaxf(fminf(dst, mx), mn);
}

// Scratch plane k of sample b: the scalar half uses planes 0-2 (rho_fwd,
// the back-traced x and y), the velocity half the next two (u_fwd, v_fwd).
__device__ __forceinline__ size_t plane(int k, int b, int nb, int n) {
  return (size_t)(k * nb + b) * n;
}

template <bool kScalar, bool kVel>
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
    Field src{rho + (size_t)b * n, h, w};
    float bx, by;
    float f = scalar_sl(src, flags, fluid, x, y, ccx, ccy, P.dt, P, &bx, &by);
    scratch[plane(0, b, nb, n) + i] = in ? f : 0.f;
    scratch[plane(1, b, nb, n) + i] = fluid ? bx : (float)x + 0.5f;
    scratch[plane(2, b, nb, n) + i] = fluid ? by : (float)y + 0.5f;
  }
  if (kVel) {
    const int k = kScalar ? 3 : 0;
    const float* ou = orig + (size_t)b * 2 * n;
    float mxu, mxv, myu, myv;
    mac_vectors(u, v, x, y, h, w, &mxu, &mxv, &myu, &myv);
    Field fu{ou, h, w}, fv{ou + n, h, w};
    float su = vel_sl(fu, fluid, x, y, mxu, mxv, P.dt, P.D);
    float sv = vel_sl(fv, fluid, x, y, myu, myv, P.dt, P.D);
    scratch[plane(k, b, nb, n) + i] = in ? su : 0.f;
    scratch[plane(k + 1, b, nb, n) + i] = in ? sv : 0.f;
  }
}

template <bool kScalar, bool kVel>
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
    const float* s_px = scratch + plane(1, b, nb, n);
    const float* s_py = scratch + plane(2, b, nb, n);
    const float* src = rho + (size_t)b * n;
    float ccx = in ? 0.5f * (u[i] + u[i + 1]) : 0.f;
    float ccy = in ? 0.5f * (v[i] + v[i + w]) : 0.f;
    Field fwdf{s_fwd, h, w};
    float bx, by;
    float bwd = scalar_sl(fwdf, flags, fluid, x, y, ccx, ccy, -P.dt, P, &bx,
                          &by);
    bwd = in ? bwd : 0.f;
    float fwd = s_fwd[i];
    float dst = fluid ? fwd + P.halfstr * (src[i] - bwd) : fwd;
    float out;
    if (!in) {
      out = dst;
    } else {
      float cx = (float)x + 0.5f, cy = (float)y + 0.5f;
      float px = clamp_win(s_px[i], cx, P.D), py = clamp_win(s_py[i], cy, P.D);
      int i0 = min(max((int)truncf(px), 0), w - 1);
      int j0 = min(max((int)truncf(py), 0), h - 1);
      float mn = kInf, mx = -kInf;
      int cnt = 0;
      for (int dj = -1; dj <= 1; ++dj)
        for (int di = -1; di <= 1; ++di) {
          int X = i0 + di, Y = j0 + dj;
          if (!inside(X, Y, h, w)) continue;
          if (!P.sample_outside && flags[Y * w + X] != kFluid) continue;
          float s = src[Y * w + X];
          mn = fminf(mn, s);
          mx = fmaxf(mx, s);
          ++cnt;
        }
      out = cnt >= 1 ? fmaxf(mn, fminf(mx, dst)) : fwd;
    }
    rho_out[(size_t)b * n + i] = out;
  }

  // ---- velocity: backward samples, skip-masked correction, Selle ----
  if (kVel) {
    const int k = kScalar ? 3 : 0;
    const float* u_fwd = scratch + plane(k, b, nb, n);
    const float* v_fwd = scratch + plane(k + 1, b, nb, n);
    const float* ou = orig + (size_t)b * 2 * n;
    const float* ov = ou + n;
    float* uo = U_out + (size_t)b * 2 * n;
    float* vo = uo + n;
    if (!in) {
      uo[i] = 0.f;
      vo[i] = 0.f;
      return;
    }
    float mxu, mxv, myu, myv;
    mac_vectors(u, v, x, y, h, w, &mxu, &mxv, &myu, &myv);
    Field fu{u_fwd, h, w}, fv{v_fwd, h, w};
    float bu = vel_sl(fu, fluid, x, y, mxu, mxv, -P.dt, P.D);
    float bv = vel_sl(fv, fluid, x, y, myu, myv, -P.dt, P.D);
    bool skip_u = !fluid || (x > 0 && flags[i - 1] != kFluid);
    bool skip_v = !fluid || (y > 0 && flags[i - w] != kFluid);
    float du = skip_u ? u_fwd[i] : u_fwd[i] + P.halfstr * (ou[i] - bu);
    float dv = skip_v ? v_fwd[i] : v_fwd[i] + P.halfstr * (ov[i] - bv);
    Field fou{ou, h, w}, fov{ov, h, w};
    uo[i] = selle(du, fou, x, y, mxu * P.dt, mxv * P.dt, P.D);
    vo[i] = selle(dv, fov, x, y, myu * P.dt, myv * P.dt, P.D);
  }
}

Params make_params(int h, int w, float dt, float halfstr, float wm, float hm,
                   int D, int line_trace, int sample_outside) {
  Params P;
  P.h = h;
  P.w = w;
  P.D = D;
  P.line_trace = line_trace;
  P.sample_outside = sample_outside;
  P.dt = dt;
  P.halfstr = halfstr;
  P.wm = wm;
  P.hm = hm;
  return P;
}

const dim3 kBlock(32, 8);

template <bool kScalar, bool kVel>
int forward(const float* rho, const float* U, const float* orig,
            const int* flags, float* scratch, int b, const Params& P,
            void* stream) {
  advect_forward<kScalar, kVel>
      <<<grid2d(b, P.h, P.w, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
          rho, U, orig ? orig : U, flags, scratch, P);
  return fnk::launch_status();
}

template <bool kScalar, bool kVel>
int backward(const float* rho, const float* U, const float* orig,
             const int* flags, const float* scratch, float* rho_out,
             float* U_out, int b, const Params& P, void* stream) {
  advect_backward<kScalar, kVel>
      <<<grid2d(b, P.h, P.w, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
          rho, U, orig ? orig : U, flags, scratch, rho_out, U_out, P);
  return fnk::launch_status();
}

}  // namespace

// wm/hm are float32(w - 1e-5), float32(h - 1e-5); `orig` may be null
// (U advects itself). Scratch: 5*b*h*w floats for A, 3 for D, 2 for E.

// ---- A: scalar + velocity ----
extern "C" int fn_advect_forward(const float* rho, const float* U,
                                 const float* orig, const int* flags,
                                 float* scratch, int b, int h, int w,
                                 float dt, float wm, float hm, int D,
                                 int line_trace, int sample_outside,
                                 void* stream) {
  Params P = make_params(h, w, dt, 0.f, wm, hm, D, line_trace,
                         sample_outside);
  return forward<true, true>(rho, U, orig, flags, scratch, b, P, stream);
}

extern "C" int fn_advect_backward(const float* rho, const float* U,
                                  const float* orig, const int* flags,
                                  const float* scratch, float* rho_out,
                                  float* U_out, int b, int h, int w,
                                  float dt, float halfstr, float wm,
                                  float hm, int D, int line_trace,
                                  int sample_outside, void* stream) {
  Params P = make_params(h, w, dt, halfstr, wm, hm, D, line_trace,
                         sample_outside);
  return backward<true, true>(rho, U, orig, flags, scratch, rho_out, U_out,
                              b, P, stream);
}

// ---- D: scalar alone ----
extern "C" int fn_advect_scalar_forward(const float* rho, const float* U,
                                        const int* flags, float* scratch,
                                        int b, int h, int w, float dt,
                                        float wm, float hm, int D,
                                        int line_trace, int sample_outside,
                                        void* stream) {
  Params P = make_params(h, w, dt, 0.f, wm, hm, D, line_trace,
                         sample_outside);
  return forward<true, false>(rho, U, nullptr, flags, scratch, b, P, stream);
}

extern "C" int fn_advect_scalar_backward(const float* rho, const float* U,
                                         const int* flags,
                                         const float* scratch,
                                         float* rho_out, int b, int h, int w,
                                         float dt, float halfstr, float wm,
                                         float hm, int D, int line_trace,
                                         int sample_outside, void* stream) {
  Params P = make_params(h, w, dt, halfstr, wm, hm, D, line_trace,
                         sample_outside);
  return backward<true, false>(rho, U, nullptr, flags, scratch, rho_out,
                               nullptr, b, P, stream);
}

// ---- E: velocity alone ----
extern "C" int fn_advect_velocity_forward(const float* U, const float* orig,
                                          const int* flags, float* scratch,
                                          int b, int h, int w, float dt,
                                          int D, void* stream) {
  Params P = make_params(h, w, dt, 0.f, 0.f, 0.f, D, 0, 0);
  return forward<false, true>(nullptr, U, orig, flags, scratch, b, P,
                              stream);
}

extern "C" int fn_advect_velocity_backward(const float* U, const float* orig,
                                           const int* flags,
                                           const float* scratch,
                                           float* U_out, int b, int h, int w,
                                           float dt, float halfstr, int D,
                                           void* stream) {
  Params P = make_params(h, w, dt, halfstr, 0.f, 0.f, D, 0, 0);
  return backward<false, true>(nullptr, U, orig, flags, scratch, nullptr,
                               U_out, b, P, stream);
}
