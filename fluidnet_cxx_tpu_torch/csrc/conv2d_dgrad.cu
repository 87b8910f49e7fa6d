// The input gradient of kernel B's convolution: for a SAME conv of an NHWC
// input (n, hi, wi, ci) with the HWIO weight W (k, k, ci, co), stride s and
// dilation d, and the gradient dy (n, ho, wo, co) of its output,
//
//   dx[n, y, x, c] = sum_{ky, kx, o} dy[n, oy, ox, o] W[ky, kx, c, o],
//   oy = (y + pad - ky*d) / s, ox = (x + pad - kx*d) / s,
//
// over the taps where both divide exactly and land inside dy (`pad` the top
// and left SAME pad of each axis). ops/kernels/conv_grad.py::conv2d_dgrad
// is its wrapper, which builds the class tables below and asks
// fn_conv2d_dgrad_plan for the plan; the autograd function of
// ops/kernels/punet.py calls it in the backward of each conv of a training
// step whose input needs a gradient.
//
// Replaces no TPU kernel: the JAX package trains through flax nn.Conv and
// lets XLA differentiate it. It is here because every conv on the card runs
// on kernel B, which has no gradient of its own. Its plain version is
// F.conv_transpose2d cut to the SAME window.
//
// What bounds it on an H100: operations. It is a GEMM of M = n*hi*wi dx
// cells by N = ci channels over K = the taps that reach a cell times co,
// 2*n*ho*wo*k*k*ci*co operations in all: 154.6 GFLOP for ScaleNet's 3x3
// 64->128 layer at 128^2, batch 64, 0.94 ms at the 3xTF32 rate (495/3
// TFLOP/s); the tower's thin layers are bound by their bytes.
//
// Design.
//  1. Real channel counts. The call takes the layer's real (ci, co); dy is
//     read at its stored channel stride ys (kernel B's packed 32, or 4 for
//     an output layer) and only its co real channels, rounded up to 4, are
//     gathered; only dx's ci real channels, rounded up to the MMA's 8
//     columns, are computed, and the padded ones written 0 (exact: the
//     packed weight's padded input rows are 0). The weight is read in its
//     own HWIO layout, whose rows (tap, c) hold the co values the GEMM sums
//     over: it is K-major for this GEMM as it stands, so nothing is
//     transposed or padded per call. A thin layer stages K in chunks of its
//     own width: 8 or 16 channels a tap (kc), not 32.
//  2. Stride 2 as output-parity classes. dx's cells split by ((y + pad) mod
//     s, (x + pad) mod s); each class is a stride-1 correlation of dy with
//     the taps of its parity only (3x3 at dilation 1: 2x2, 2x1, 1x2 and 1x1
//     taps), at a dy offset per tap. The tables (each class's first dx
//     cell, its rows and columns, its taps and their dy offsets) come from
//     the host (conv_grad.py::dgrad_classes); stride 1 is one class of all
//     k*k taps. One launch covers every class: the grid's x runs over the
//     m-tiles of class 0, then class 1, ... No zero tap is gathered or
//     multiplied, and the copy loops divide by nothing.
//  3. Two MMA bodies, two ways to stage dy: three routes, chosen per
//     layer by the planner (fn_conv2d_dgrad_plan, from per-layer times on
//     the card; a launch that fails raises: a route is a plan, not a
//     fallback).
//     - mma.sync: kernel B's 3xTF32 m16n8k8 body (each operand split as
//       it leaves shared memory into big = tf32(x) and small = tf32(x -
//       big); small*big + big*small + big*big) on warp tiles of 32 rows x
//       8, 16 or 32 columns.
//     - wgmma (the wide layers): two warpgroups, each wgmma.mma_async
//       m64nNk8 tf32 on one or two m64 tiles, A (dy) from registers,
//       loaded from shared memory and split into big and small there, B
//       (the weight) from shared memory: its big and small halves are
//       made once a call by the wrapper (conv_grad.py::tf32_split,
//       cvt.rna's rounding in integer ops) and staged K-major, one
//       32-channel chunk a 128-byte row, in the 128-byte swizzle, by
//       16-byte cp.async.
//     - The gather (dgrad_mma): each K unit (one tap's chunk of dy
//       channels) stages its rows of dy by 16-byte cp.async with
//       zero-fill at the SAME border, through a 4-stage ring. What bounds
//       it on an H100 is L2 -> shared memory traffic: each dy value is
//       fetched once a tap (2.0-2.5 TB/s measured on the wide layers, on
//       mma.sync and on a wgmma twin alike, which was dropped).
//     - The patch (dgrad_patch, dgrad_wgmma): a block owns a tile of one
//       image's class cells and stages, by 16-byte cp.async with zero-fill
//       (TMA's tiled mode does not gather taps), the halo'd patch of dy
//       its taps read, once a chunk of channels; each tap reads its
//       fragments at its offset in the patch, so dy leaves L2 once a
//       chunk, not once a tap. mma.sync takes it where dy's channels fit
//       one chunk (the thin and the 5x5 layers: the patch and every tap's
//       weights in one stage); wgmma on the wide layers, the weights
//       through a 4-stage ring, the patch in two slots.
//  4. Accuracy and determinism. Each K chunk (a tap's kc channels) is
//     summed from zero on the tensor cores, and the chunk's sum joins the
//     float32 accumulator by an ordinary add (B's rule: one long
//     tensor-core sum missed 1e-5 where this passes 1e-6). A split of K
//     writes its partial tile to a workspace and dgrad_reduce adds the
//     splits in the order 0..S-1, with no atomics: repeats are bit-equal.
//
// Times (chip_smoke.py --dgrad-only, H100 80GB HBM3 at 700 W; PERF.md,
// "Backward kernels"), device ms of one backward at 128^2, batch 64,
// against cuDNN's conv2d_input and the transposed gather in kernel B's
// body that this kernel replaced: FluidNetTower 0.85 (1.60, 2.81),
// MultiScaleNet 9.94 (16.29, 18.08), PUNetD2_128's architecture 0.49
// (0.87, 0.70), its two stride-2 layers 0.063 (0.101, 0.178).
#include "conv_mma.cuh"

namespace {

using namespace fnk::conv;

constexpr int kMaxClasses = 4;  // s x s parity classes, s <= 2
constexpr int kMaxTaps = 49;    // k <= 7
constexpr int kStagesD = 4;     // depth of the cp.async ring
constexpr int kMaxWarpsD = 8;
constexpr int kMaxSplitsD = 64;
constexpr long long kMaxIndexD = 0x7fffffff;

// One parity class: its first dx cell (y0, x0), hq x wq cells s apart,
// ntaps taps, its first m-tile in the grid.
struct Cls {
  int y0, x0, hq, wq, ntaps, tile0;
};
// The class tables: class j's tap i reads weight tap tap[j][i] (ky * k +
// kx) and dy at (qy + oy[j][i], qx + ox[j][i]) for class cell (qy, qx).
struct Table {
  int ncls;
  Cls c[kMaxClasses];
  short tap[kMaxClasses][kMaxTaps];
  short oy[kMaxClasses][kMaxTaps];
  short ox[kMaxClasses][kMaxTaps];
};

struct DArgs {
  const float* dy;   // (n, ho, wo, ys): co real channels
  const float* w;    // HWIO (k, k, cip, cop), row (tap, c) holds o
  const float* wb;   // the wgmma route: tf32 big and small halves of w
  const float* wsm;
  float* dx;         // (n, hi, wi, xs): ci real channels, the rest 0
  float* ws;         // (splits, cells, ci) when splits > 1
  int n, hi, wi, xs, ci, cells;
  int ho, wo, ys, co, co4;
  int cip, cop, stride;
  int cpt;           // K chunks a tap: ceil(co4 / kc)
  int bm, bn, splits;
  int tws;           // the patch route: log2 of its tile's columns
  Table t;
};

// The block's class: the last whose first m-tile is at or before it.
__device__ __forceinline__ int block_class(const Table& t) {
  int c = 0;
  while (c + 1 < t.ncls && (int)blockIdx.x >= t.c[c + 1].tile0) ++c;
  return c;
}

// rows[r] = (dy cell of class cell m0 + r's (qy, qx) in its sample, qy,
// qx, its dx cell); past the class's last cell (0, kNoRow, kNoRow, -1),
// whose taps all land outside dy.
__device__ __forceinline__ void fill_rows_d(const DArgs& a, const Cls& c,
                                            int m0, int4* rows) {
  const int mc = a.n * c.hq * c.wq;
  for (int r = threadIdx.x; r < a.bm; r += blockDim.x) {
    int4 v = make_int4(0, kNoRow, kNoRow, -1);
    const int m = m0 + r;
    if (m < mc) {
      const int qx = m % c.wq, rest = m / c.wq;
      const int qy = rest % c.hq, s = rest / c.hq;
      v = make_int4((s * a.ho + qy) * a.wo + qx, qy, qx,
                    (s * a.hi + c.y0 + a.stride * qy) * a.wi + c.x0 +
                        a.stride * qx);
    }
    rows[r] = v;
  }
}

// One stage's A tile: dy's channels cc .. cc + KC - 1 at each row's cell
// shifted by the tap's offset, rows `row_bytes` apart; zero outside dy and
// past co4.
template <int KC>
__device__ __forceinline__ void load_a_d(const DArgs& a, const int4* rows,
                                         int oy, int ox, int cc, char* dst,
                                         int row_bytes) {
  constexpr int kPieces = KC / 4;
  const int off = oy * a.wo + ox;
  for (int i = threadIdx.x; i < a.bm * kPieces; i += blockDim.x) {
    const int r = i / kPieces, p = i % kPieces;  // powers of two: shifts
    const int4 rw = rows[r];
    const int sy = rw.y + oy, sx = rw.z + ox, ch = cc + 4 * p;
    const bool ok = sy >= 0 && sy < a.ho && sx >= 0 && sx < a.wo && ch < a.co4;
    const float* src = ok ? a.dy + (size_t)(rw.x + off) * a.ys + ch : a.dy;
    cp_async16(dst + r * row_bytes + p * 16, src, ok);
  }
}

// One stage's weight tile of the mma.sync route: rows n0 .. n0 + bn - 1
// (dx channels c; zero past ci) of weight tap `tap`, K pieces o = cc ..
// cc + KC - 1 (zero past co4), rows `row_bytes` apart.
template <int KC>
__device__ __forceinline__ void load_b_d(const DArgs& a, int tap, int n0,
                                         int cc, char* dst, int row_bytes) {
  constexpr int kPieces = KC / 4;
  const float* base = a.w + (size_t)tap * a.cip * a.cop;
  for (int i = threadIdx.x; i < a.bn * kPieces; i += blockDim.x) {
    const int j = i / kPieces, p = i % kPieces;
    const int c = n0 + j, o = cc + 4 * p;
    const bool ok = c < a.ci && o < a.co4;
    cp_async16(dst + j * row_bytes + p * 16,
               ok ? base + (size_t)c * a.cop + o : a.w, ok);
  }
}

// Two neighbouring columns (col even) of one dx cell: with one split the
// value where col < ci, else 0; with splits the real columns into the
// split's slice of the workspace.
__device__ __forceinline__ void store_pair(const DArgs& a, int cell, int col,
                                           float v0, float v1) {
  if (cell < 0 || col >= a.xs) return;
  if (a.splits > 1) {
    float* d = a.ws + ((size_t)blockIdx.z * a.cells + cell) * a.ci + col;
    if (col < a.ci) d[0] = v0;
    if (col + 1 < a.ci) d[1] = v1;
    return;
  }
  *reinterpret_cast<float2*>(a.dx + (size_t)cell * a.xs + col) =
      make_float2(col < a.ci ? v0 : 0.f, col + 1 < a.ci ? v1 : 0.f);
}

// dx's columns c0 .. xs - 1 of the block's rows, which no tile covers: 0.
__device__ __forceinline__ void zero_tail(const DArgs& a, const int4* rows,
                                          int c0) {
  const int w = a.xs - c0;
  if (w <= 0 || a.splits > 1 || blockIdx.y + 1 != gridDim.y) return;
  for (int i = threadIdx.x; i < a.bm * w; i += blockDim.x) {
    const int cell = rows[i / w].w;
    if (cell >= 0) a.dx[(size_t)cell * a.xs + c0 + i % w] = 0.f;
  }
}

// The K chunks of the block's split: [kb, kb + nk) of its class's ntaps *
// cpt, in tap order.
__device__ __forceinline__ void split_range(const DArgs& a, const Cls& c,
                                            int& kb, int& nk) {
  const long long all = (long long)c.ntaps * a.cpt;
  kb = (int)(blockIdx.z * all / a.splits);
  nk = (int)((blockIdx.z + 1) * all / a.splits) - kb;
}

// ---- the patch routes' tile ----

// A tile of TR x TW class cells of one image (TW = 1 << tws, TR = bm >>
// tws) and the patch of dy its taps read: dy rows qy0 + oy_lo .. + ph - 1,
// columns qx0 + ox_lo .. + pw - 1 (the taps' offsets' spans added).
struct PatchTile {
  int img, qy0, qx0, oy_lo, ox_lo, ph, pw;
};

__device__ __forceinline__ PatchTile patch_tile(const DArgs& a, const Cls& c,
                                                int cls) {
  const int tw = 1 << a.tws, tr = a.bm >> a.tws;
  const int tiles_x = (c.wq + tw - 1) >> a.tws;
  const int tiles_y = (c.hq + tr - 1) / tr;
  int tile = (int)blockIdx.x - c.tile0;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  PatchTile p;
  p.img = tile / tiles_y;
  p.qy0 = tile % tiles_y * tr;
  p.qx0 = tx * tw;
  int oy_hi = 0, ox_hi = 0;
  p.oy_lo = p.ox_lo = 0;
  for (int i = 0; i < c.ntaps; ++i) {
    const int oy = a.t.oy[cls][i], ox = a.t.ox[cls][i];
    p.oy_lo = i ? min(p.oy_lo, oy) : oy;
    oy_hi = i ? max(oy_hi, oy) : oy;
    p.ox_lo = i ? min(p.ox_lo, ox) : ox;
    ox_hi = i ? max(ox_hi, ox) : ox;
  }
  p.ph = tr + oy_hi - p.oy_lo;
  p.pw = tw + ox_hi - p.ox_lo;
  return p;
}

// rows[r].w: the dx cell of the tile's row r (-1 past the class).
__device__ __forceinline__ void patch_rows(const DArgs& a, const Cls& c,
                                           const PatchTile& p, int4* rows) {
  const int tw = 1 << a.tws;
  for (int r = threadIdx.x; r < a.bm; r += blockDim.x) {
    const int qy = p.qy0 + (r >> a.tws), qx = p.qx0 + (r & (tw - 1));
    int cell = -1;
    if (qy < c.hq && qx < c.wq)
      cell = (p.img * a.hi + c.y0 + a.stride * qy) * a.wi + c.x0 +
             a.stride * qx;
    rows[r] = make_int4(0, 0, 0, cell);
  }
}

// dy's channels cc .. cc + KC - 1 of the patch, a patch cell every KC + 4
// floats (zero outside dy and past co4); a warp copies a patch row.
template <int KC>
__device__ __forceinline__ void load_patch(const DArgs& a, const PatchTile& p,
                                           int cc, float* dst) {
  constexpr int kPieces = KC / 4;
  const float* dimg = a.dy + (size_t)p.img * a.ho * a.wo * a.ys + cc;
  const int nwarps = blockDim.x / 32;
  for (int py = threadIdx.x / 32; py < p.ph; py += nwarps) {
    const int sy = p.qy0 + p.oy_lo + py;
    for (int j = threadIdx.x % 32; j < p.pw * kPieces; j += 32) {
      const int px = j / kPieces, q = j % kPieces;  // powers of two: shifts
      const int sx = p.qx0 + p.ox_lo + px;
      const bool ok = sy >= 0 && sy < a.ho && sx >= 0 && sx < a.wo &&
                      cc + 4 * q < a.co4;
      cp_async16(dst + (py * p.pw + px) * (KC + 4) + 4 * q,
                 ok ? dimg + (size_t)(sy * a.wo + sx) * a.ys + 4 * q : a.dy,
                 ok);
    }
  }
}

// The patch cell of tile row r at tap offset (0, 0), relative to the
// patch's corner; a tap (oy, ox) adds oy * pw + ox.
__device__ __forceinline__ int patch_base(const DArgs& a, const PatchTile& p,
                                          int r) {
  return ((r >> a.tws) - p.oy_lo) * p.pw + (r & ((1 << a.tws) - 1)) - p.ox_lo;
}

// ---- the mma.sync route ----

// A block of wm x wn warps (bm = 32 wm rows, bn = 8 NT wn columns), each
// warp 32 rows x 8 NT columns; K chunks of KC channels.
template <int KC, int NT>
__global__ void __launch_bounds__(kMaxWarpsD * 32)
    dgrad_mma(const __grid_constant__ DArgs a) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kStrideF = KC + 4;  // floats a row: conflict-free fragments
  constexpr int kRow = kStrideF * 4;
  const int stage = (a.bm + a.bn) * kRow;
  int4* rows = reinterpret_cast<int4*>(smem + kStagesD * stage);
  const int cls = block_class(a.t);
  const Cls& c = a.t.c[cls];
  fill_rows_d(a, c, ((int)blockIdx.x - c.tile0) * a.bm, rows);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wnc = a.bn / (8 * NT);
  const int wm = warp / wnc, wn = warp % wnc;
  const int n0 = blockIdx.y * a.bn;
  int kb, nk;
  split_range(a, c, kb, nk);
  int ti = kb / a.cpt, cc = (kb - ti * a.cpt) * KC;  // chunks load in order
  auto load = [&](int kc) {
    char* st = smem + (kc % kStagesD) * stage;
    load_a_d<KC>(a, rows, a.t.oy[cls][ti], a.t.ox[cls][ti], cc, st, kRow);
    load_b_d<KC>(a, a.t.tap[cls][ti], n0, cc, st + a.bm * kRow, kRow);
    cc += KC;
    if (cc == a.cpt * KC) {
      cc = 0;
      ++ti;
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int s = 0; s < kStagesD - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStagesD - 2>();
    __syncthreads();
    if (kc + kStagesD - 1 < nk) load(kc + kStagesD - 1);
    cp_async_commit();

    const float* af =
        reinterpret_cast<const float*>(smem + (kc % kStagesD) * stage);
    const float* wf = af + a.bm * kStrideF;
    float part[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int kq = ks * 8 + lane % 4;
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = (wn * NT + nt) * 8 + lane / 4;
        split_tf32(wf[col * kStrideF + kq], bb[nt][0], bs[nt][0]);
        split_tf32(wf[col * kStrideF + kq + 4], bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + lane / 4;
        const float v[4] = {af[r * kStrideF + kq], af[(r + 8) * kStrideF + kq],
                            af[r * kStrideF + kq + 4],
                            af[(r + 8) * kStrideF + kq + 4]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], ab[i], as[i]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_tf32(part[mt][nt], as, bb[nt]);
          mma_tf32(part[mt][nt], ab, bs[nt]);
          mma_tf32(part[mt][nt], ab, bb[nt]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = acc[i][j][e] + part[i][j][e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + lane / 4 + h * 8;
        const int col = n0 + (wn * NT + nt) * 8 + 2 * (lane % 4);
        store_pair(a, rows[r].w, col, acc[mt][nt][2 * h],
                   acc[mt][nt][2 * h + 1]);
      }
  zero_tail(a, rows, gridDim.y * a.bn);
}

// ---- the wgmma route ----

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int acc);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %21, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %52, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %53, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(desc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The compiler keeps v in its register up to here and reads it anew after
// (the asynchronous MMAs read and write registers it does not see).
__device__ __forceinline__ void reg_fence(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& v) {
  asm volatile("" : "+r"(v)::"memory");
}
// Writes of the generic proxy (cp.async) made visible to the async proxy
// (wgmma's shared-memory reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's descriptor of a K-major tile in the 128-byte swizzle: rows of
// 128 bytes (32 tf32), 8-row atoms 1024 bytes apart (the tile 1024-byte
// aligned); the leading offset is unused in this layout.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3ffff) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// Bytes a patch cell of the wgmma route holds: 32 channels + 16 bytes (its
// fragment loads then fall on 32 distinct banks).
constexpr int kRowAW = (32 + 4) * 4;
// Dynamic shared memory of the wgmma route with MT m64 tiles a warpgroup
// over a patch of `patch` cells: the ring of weight halves, two patch
// slots, the rows table and the alignment.
template <int BN, int MT>
__host__ __device__ constexpr int wg_smem(int patch) {
  return kStagesD * 2 * BN * 128 + 2 * patch * kRowAW + 128 * MT * 16 + 1024;
}

// One stage's weight half of the wgmma route: rows n0 .. n0 + BN - 1 (dx
// channels; zero past ci) of tap `tap`, the 8 16-byte pieces of K (o = cc ..
// cc + 31; zero past co4) of row j at piece slot p ^ (j % 8).
template <int BN>
__device__ __forceinline__ void load_b_sw(const DArgs& a, const float* w,
                                          int tap, int n0, int cc,
                                          char* dst) {
  const float* base = w + (size_t)tap * a.cip * a.cop;
  for (int i = threadIdx.x; i < BN * 8; i += blockDim.x) {
    const int j = i >> 3, p = i & 7;
    const int c = n0 + j, o = cc + 4 * p;
    const bool ok = c < a.ci && o < a.co4;
    cp_async16(dst + j * 128 + ((p ^ (j & 7)) << 4),
               ok ? base + (size_t)c * a.cop + o : w, ok);
  }
}

// Two warpgroups, each MT m64 tiles x BN columns (bm = 128 MT; MT 2, half
// the weight traffic a row, is faster at BN 64 and slower at 32 on an
// H100, and BN 96 and 128 leave no registers for it), over a TR x TW tile
// of one image's class cells. The K units (32 channels of one tap) run
// chunk by chunk, each chunk's taps in turn: a unit's weight halves come
// through the ring, and a chunk's halo'd dy patch is staged with its first
// tap into one of two slots (the slot of chunk c + 2 is written kStagesD -
// 1 units ahead, after chunk c's last tap when a chunk has kStagesD - 1
// taps or more). Per unit, four k-steps of three wgmma a tile (small(A)
// big(B), big(A) small(B), big(A) big(B)) summed from zero, then added to
// the float32 accumulator.
template <int BN, int MT>
__global__ void __launch_bounds__(2 * 128, 1)
    dgrad_wgmma(const __grid_constant__ DArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kHalf = BN * 128;
  constexpr int kStage = 2 * kHalf;
  constexpr int kStrideF = kRowAW / 4;
  const int cls = block_class(a.t);
  const Cls& c = a.t.c[cls];
  const PatchTile pt = patch_tile(a, c, cls);
  const int slot_f = pt.ph * pt.pw * kStrideF;  // floats a patch slot
  float* slots = reinterpret_cast<float*>(smem + kStagesD * kStage);
  int4* rows = reinterpret_cast<int4*>(slots + 2 * slot_f);
  patch_rows(a, c, pt, rows);
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.y * BN;
  const int nk = c.ntaps * a.cpt;
  int ti = 0, cc = 0;  // the unit loaded next: tap ti of chunk cc
  auto load = [&](int kc) {
    char* st = smem + (kc % kStagesD) * kStage;
    const int tap = a.t.tap[cls][ti];
    load_b_sw<BN>(a, a.wb, tap, n0, cc, st);
    load_b_sw<BN>(a, a.wsm, tap, n0, cc, st + kHalf);
    if (ti == 0) load_patch<32>(a, pt, cc, slots + (cc / 32 % 2) * slot_f);
    if (++ti == c.ntaps) {
      ti = 0;
      cc += 32;
    }
  };

  float acc[MT][BN / 2], part[MT][BN / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[t][i] = part[t][i] = 0.f;

  for (int s = 0; s < kStagesD - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  // This lane's A rows in tile t: r0 + 64 t and r0 + 64 t + 8, and their
  // patch cells at tap offset (0, 0).
  const int r0 = wg * 64 * MT + warp * 16 + lane / 4;
  int pbase[MT][2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pbase[t][h] = patch_base(a, pt, r0 + 64 * t + 8 * h);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStagesD - 2>();
    fence_proxy_async();
    __syncthreads();
    if (kc + kStagesD - 1 < nk) load(kc + kStagesD - 1);
    cp_async_commit();

    const char* st = smem + (kc % kStagesD) * kStage;
    const int chunk = kc / c.ntaps, tap = kc - chunk * c.ntaps;
    const float* slot = slots + (chunk % 2) * slot_f;
    const int toff = a.t.oy[cls][tap] * pt.pw + a.t.ox[cls][tap];
    uint32_t ab[MT][4][4], as[MT][4][4];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const float* f0 = slot + (pbase[t][0] + toff) * kStrideF;
      const float* f1 = slot + (pbase[t][1] + toff) * kStrideF;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int kq = ks * 8 + lane % 4;
        const float v[4] = {f0[kq], f1[kq], f0[kq + 4], f1[kq + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], ab[t][ks][i], as[t][ks][i]);
      }
    }
    const uint64_t db = desc_sw128(st), ds = desc_sw128(st + kHalf);
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(part[t][i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)  // k8 steps: 32 bytes along the rows
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        wgmma_tf32<BN>(part[t], as[t][ks], db + 2 * ks, ks > 0);
        wgmma_tf32<BN>(part[t], ab[t][ks], ds + 2 * ks, 1);
        wgmma_tf32<BN>(part[t], ab[t][ks], db + 2 * ks, 1);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          reg_fence(ab[t][ks][i]);
          reg_fence(as[t][ks][i]);
        }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        reg_fence(part[t][i]);
        acc[t][i] = acc[t][i] + part[t][i];
      }
    }
  }
  cp_async_wait<0>();

  // acc[t][4j + e]: row r0 + 64 t (e < 2) or 8 below, column 8j + 2 (lane %
  // 4) + e % 2.
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_pair(a, rows[r0 + 64 * t + 8 * h].w,
                   n0 + 8 * j + 2 * (lane % 4), acc[t][4 * j + 2 * h],
                   acc[t][4 * j + 2 * h + 1]);
  zero_tail(a, rows, gridDim.y * BN);
}

// ---- the mma.sync route over a halo'd dy patch ----

// Layers whose dy channels fit one K chunk (co4 <= kc): the block owns a
// TR x TW tile of one image's class cells (bm = 32 wm rows = TR * TW, TW
// = 1 << tws) and stages, once, the patch of dy its taps read, (TR + the
// taps' row offsets' span) x (TW + their column span) cells x kc channels
// (zero outside dy), and the weight tiles of all its taps; each tap then
// reads its A fragments from the patch at the tap's offset. dy is read
// from L2 once a block, not once a tap (25 times for a 5x5 kernel).
template <int KC, int NT>
__global__ void __launch_bounds__(kMaxWarpsD * 32)
    dgrad_patch(const __grid_constant__ DArgs a) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kStrideF = KC + 4;  // floats a row: conflict-free fragments
  constexpr int kRow = kStrideF * 4;
  const int cls = block_class(a.t);
  const Cls& c = a.t.c[cls];
  const PatchTile pt = patch_tile(a, c, cls);
  float* patch = reinterpret_cast<float*>(smem);
  float* wts = patch + pt.ph * pt.pw * kStrideF;
  int4* rows = reinterpret_cast<int4*>(wts + c.ntaps * a.bn * kStrideF);
  const int n0 = blockIdx.y * a.bn;
  load_patch<KC>(a, pt, 0, patch);
  for (int t = 0; t < c.ntaps; ++t)
    load_b_d<KC>(a, a.t.tap[cls][t], n0, 0,
                 reinterpret_cast<char*>(wts + t * a.bn * kStrideF), kRow);
  cp_async_commit();
  patch_rows(a, c, pt, rows);
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wnc = a.bn / (8 * NT);
  const int wm = warp / wnc, wn = warp % wnc;
  // This lane's A rows (mt, h): their patch cells at tap offset (0, 0).
  int pbase[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pbase[mt][h] = patch_base(a, pt, wm * 32 + mt * 16 + h * 8 + lane / 4);
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int t = 0; t < c.ntaps; ++t) {
    const int toff = a.t.oy[cls][t] * pt.pw + a.t.ox[cls][t];
    const float* wf = wts + t * a.bn * kStrideF;
    float part[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int kq = ks * 8 + lane % 4;
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = (wn * NT + nt) * 8 + lane / 4;
        split_tf32(wf[col * kStrideF + kq], bb[nt][0], bs[nt][0]);
        split_tf32(wf[col * kStrideF + kq + 4], bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p0 = patch + (pbase[mt][0] + toff) * kStrideF;
        const float* p1 = patch + (pbase[mt][1] + toff) * kStrideF;
        const float v[4] = {p0[kq], p1[kq], p0[kq + 4], p1[kq + 4]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], ab[i], as[i]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_tf32(part[mt][nt], as, bb[nt]);
          mma_tf32(part[mt][nt], ab, bs[nt]);
          mma_tf32(part[mt][nt], ab, bb[nt]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = acc[i][j][e] + part[i][j][e];
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + lane / 4 + h * 8;
        const int col = n0 + (wn * NT + nt) * 8 + 2 * (lane % 4);
        store_pair(a, rows[r].w, col, acc[mt][nt][2 * h],
                   acc[mt][nt][2 * h + 1]);
      }
  zero_tail(a, rows, gridDim.y * a.bn);
}

// dx (cells, xs): each real column the sum of the splits' partials in the
// order 0..S-1, each padded column 0.
__global__ void dgrad_reduce(const float* __restrict__ ws,
                             float* __restrict__ dx, long long cells, int xs,
                             int ci, int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cells * xs) return;
  const long long cell = e / xs;
  const int col = (int)(e - cell * xs);
  float s = 0.f;
  if (col < ci) {
    const long long o = cell * ci + col, total = cells * ci;
    s = ws[o];
    for (int i = 1; i < splits; ++i) s = s + ws[i * total + o];
  }
  dx[e] = s;
}

// The instantiated kernels: the mma.sync routes (gather 1, patch 3) per
// (kc, NT), the wgmma route (2) per (BN, MT); each one's dynamic shared
// memory limit raised to kMaxSmem on first use.
struct Kern {
  int route, kc, n, mt;
  void (*fn)(DArgs);
};
const Kern kKerns[] = {
    {1, 8, 1, 0, dgrad_mma<8, 1>},       {1, 8, 2, 0, dgrad_mma<8, 2>},
    {1, 8, 4, 0, dgrad_mma<8, 4>},       {1, 16, 1, 0, dgrad_mma<16, 1>},
    {1, 16, 2, 0, dgrad_mma<16, 2>},     {1, 16, 4, 0, dgrad_mma<16, 4>},
    {1, 32, 1, 0, dgrad_mma<32, 1>},     {1, 32, 2, 0, dgrad_mma<32, 2>},
    {1, 32, 4, 0, dgrad_mma<32, 4>},     {3, 8, 1, 0, dgrad_patch<8, 1>},
    {3, 8, 2, 0, dgrad_patch<8, 2>},     {3, 8, 4, 0, dgrad_patch<8, 4>},
    {3, 16, 1, 0, dgrad_patch<16, 1>},   {3, 16, 2, 0, dgrad_patch<16, 2>},
    {3, 16, 4, 0, dgrad_patch<16, 4>},   {3, 32, 1, 0, dgrad_patch<32, 1>},
    {3, 32, 2, 0, dgrad_patch<32, 2>},   {3, 32, 4, 0, dgrad_patch<32, 4>},
    {2, 32, 32, 1, dgrad_wgmma<32, 1>},  {2, 32, 64, 2, dgrad_wgmma<64, 2>},
    {2, 32, 96, 1, dgrad_wgmma<96, 1>},  {2, 32, 128, 1, dgrad_wgmma<128, 1>}};
constexpr int kNumKerns = sizeof(kKerns) / sizeof(kKerns[0]);

const Kern* kern_of(int route, int kc, int n, int mt) {
  static bool raised[kNumKerns] = {};
  for (int i = 0; i < kNumKerns; ++i) {
    const Kern& k = kKerns[i];
    if (k.route != route || k.kc != kc || k.n != n || k.mt != mt) continue;
    if (!raised[i]) {
      if (cudaFuncSetAttribute(k.fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem) != cudaSuccess)
        return nullptr;
      raised[i] = true;
    }
    return &k;
  }
  return nullptr;
}

int ceil_div_d(long long a, long long b) { return (int)((a + b - 1) / b); }

// Cells y in [0, size) with (y + pad) % s == p.
int class_extent(int size, int pad, int s, int p) {
  int c = 0;
  for (int y = 0; y < size; ++y) c += (y + pad) % s == p;
  return c;
}

// Taps ky in [0, k) of parity class p: (ky * d) % s == p.
int class_taps(int k, int d, int s, int p) {
  int c = 0;
  for (int ky = 0; ky < k; ++ky) c += (ky * d) % s == p;
  return c;
}

int same_lo(int size, int k, int s, int d) {
  const int out = (size + s - 1) / s;
  const int total = (out - 1) * s + (k - 1) * d + 1 - size;
  return total > 0 ? total / 2 : 0;
}

constexpr int kWavesD = 2;      // blocks a launch: at least 2 per SM
constexpr int kMinChunksD = 4;  // K chunks a split at least

enum DField { kRoute, kKc, kNt, kWm, kWn, kBn, kSplits, kTws, kDFields };

// Dynamic shared memory of a launch: the mma.sync gather's ring; the
// mma.sync patch's patch (`patch` cells) and the weight tiles of its
// ntaps taps; wgmma's (wg_smem).
int dyn_smem(int route, int kc, int bm, int bn, int patch, int ntaps) {
  if (route == 2)
    return bn == 32   ? wg_smem<32, 1>(patch)
           : bn == 64 ? wg_smem<64, 2>(patch)
           : bn == 96 ? wg_smem<96, 1>(patch)
                      : wg_smem<128, 1>(patch);
  if (route == 3) return (patch + ntaps * bn) * (kc + 4) * 4 + bm * 16;
  return kStagesD * (bm + bn) * (kc + 4) * 4 + bm * 16;
}

// The span of the dy offsets of parity class p's taps on one axis.
int class_span(int k, int d, int s, int p) {
  int lo = 0, hi = 0, n = 0;
  for (int kk = 0; kk < k; ++kk) {
    if ((kk * d) % s != p) continue;
    const int o = (p - kk * d) / s;
    lo = n ? (o < lo ? o : lo) : o;
    hi = n ? (o > hi ? o : hi) : o;
    ++n;
  }
  return hi - lo;
}

}  // namespace

// The plan of the input gradient of a layer of real channels ci -> co
// whose input is n x hi x wi (k x k taps, stride, dilation) into
// plan[kDFields]: the route (1 mma.sync gathering each tap's rows of dy,
// 2 wgmma over a halo'd dy patch, 3 mma.sync over one), the K chunk kc,
// the mma.sync warp tile's n8 tiles nt, wm x wn warps (wgmma: wm m64
// tiles a warpgroup), the block's columns bn, the splits of K, log2 of a
// patch tile's columns tws. The route, from per-layer times of each on
// an H100 (PERF.md): wgmma where ci and co are both at least 32 and every
// class has at least kStagesD - 1 taps and 16 columns; else the mma.sync
// patch where dy's real channels fit one chunk (co <= 32) and every class
// is at least 8 cells wide; else the gather (stride 2, 1x1 taps, small
// maps). A positive
// plan[kRoute] on entry fixes it (wgmma then needs ci and co of at least
// 32, kStagesD - 1 taps and 8 columns a class). mma.sync: kc the real co rounded up to 8, 16 or 32; 32 rows x 8 nt
// columns a warp, up to 4 warps across the columns and 8 in all. wgmma:
// two m64 tiles a warpgroup where bn is 64, else one; the columns split
// into equal tiles of at most 128, multiples of 32. A patch tile is 16 (or
// 8) class cells wide. The gather's splits then fill kWavesD blocks an
// SM, at most kMaxSplitsD, each at least kMinChunksD chunks of the class
// with the most (the patch routes do not split). Returns 0, or a CUDA
// error where the route does not take the layer.
extern "C" int fn_conv2d_dgrad_plan(int n, int hi, int wi, int ci, int co,
                                    int k, int stride, int dil, int* plan) {
  if (!plan || n < 1 || hi < 1 || wi < 1 || ci < 1 || co < 1 || k < 1 ||
      k > 7 || stride < 1 || stride > 2 || dil < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n8 = (ci + 7) / 8 * 8, co4 = (co + 3) / 4 * 4;
  const int ph = same_lo(hi, k, stride, dil), pw = same_lo(wi, k, stride, dil);
  // The classes: the narrowest's columns, the largest tap offset spans,
  // the most and the fewest taps (the patches' shared memory and slots).
  int wq_min = wi, span = 0, taps_max = 0, taps_min = k * k;
  for (int p = 0; p < stride; ++p) {
    const int wq = class_extent(wi, pw, stride, p);
    if (wq > 0 && wq < wq_min) wq_min = wq;
    const int sp = class_span(k, dil, stride, p);
    span = sp > span ? sp : span;
    for (int q = 0; q < stride; ++q) {
      const int t = class_taps(k, dil, stride, p) * class_taps(k, dil, stride, q);
      taps_max = t > taps_max ? t : taps_max;
      taps_min = t < taps_min ? t : taps_min;
    }
  }
  const int kc = co4 <= 8 ? 8 : co4 <= 16 ? 16 : 32;
  const int nt = n8 <= 8 ? 1 : n8 <= 16 ? 2 : 4;
  // Warps across the columns: as many as the n8 tiles fill, up to 4; past
  // 4, the most that divide them (192 columns: 3 warps, two column
  // blocks of 96 and no padded columns).
  int wn = ceil_div_d(n8, 8 * nt);
  if (wn > 4) {
    wn = 4;
    while (wn > 1 && (n8 / (8 * nt)) % wn) --wn;
  }
  const int tws = wq_min >= 16 ? 4 : 3;
  // The wgmma tile: columns in equal tiles of at most 128, multiples of 32;
  // two m64 tiles a warpgroup at 64 columns.
  const int bn_w = ceil_div_d(ceil_div_d(n8, ceil_div_d(n8, 128)), 32) * 32;
  const int mt_w = bn_w == 64 ? 2 : 1;
  auto patch_cells = [&](int bm) {
    return ((bm >> tws) + span) * ((1 << tws) + span);
  };
  const bool wgmma_ok =
      ci >= 32 && co >= 32 && wq_min >= 8 && taps_min >= kStagesD - 1 &&
      dyn_smem(2, 32, 128 * mt_w, bn_w, patch_cells(128 * mt_w), 0) <=
          kMaxSmem;
  const bool patch_ok =
      co4 <= 32 && wq_min >= 8 &&
      dyn_smem(3, kc, 32 * (kMaxWarpsD / wn), 8 * nt * wn,
               patch_cells(32 * (kMaxWarpsD / wn)), taps_max) <= kMaxSmem;
  int route = plan[kRoute];
  if (route <= 0) route = wgmma_ok && wq_min >= 16 ? 2 : patch_ok ? 3 : 1;
  if (route < 1 || route > 3 || (route == 2 && !wgmma_ok) ||
      (route == 3 && !patch_ok))
    return static_cast<int>(cudaErrorInvalidValue);
  int rkc = kc, rnt = nt, wm = kMaxWarpsD / wn, rwn = wn;
  int bn = 8 * nt * wn, bm = 32 * wm;
  if (route == 2) {
    rkc = 32;
    bn = bn_w;
    rnt = 0;
    wm = mt_w;
    rwn = 1;
    bm = 128 * wm;
  }
  if (dyn_smem(route, rkc, bm, bn, 0, 0) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpt = ceil_div_d(co4, rkc);
  long long tiles = 0;
  int nk_max = 0;
  for (int py = 0; py < stride; ++py)
    for (int px = 0; px < stride; ++px) {
      const int hq = class_extent(hi, ph, stride, py);
      const int wq = class_extent(wi, pw, stride, px);
      if (hq == 0 || wq == 0) continue;
      tiles += route == 1 ? ceil_div_d((long long)n * hq * wq, bm)
                          : (long long)n * ceil_div_d(hq, bm >> tws) *
                                ceil_div_d(wq, 1 << tws);
      const int nk = class_taps(k, dil, stride, py) *
                     class_taps(k, dil, stride, px) * cpt;
      if (nk > nk_max) nk_max = nk;
    }
  const long long blocks = tiles * ceil_div_d(n8, bn);
  long long splits = 1;
  if (route == 1 && blocks < (long long)kWavesD * sms)
    splits = ceil_div_d((long long)kWavesD * sms, blocks);
  if (splits > kMaxSplitsD) splits = kMaxSplitsD;
  if (splits > nk_max / kMinChunksD) splits = nk_max / kMinChunksD;
  if (splits < 1) splits = 1;
  const int out[kDFields] = {route, rkc, rnt, wm, rwn, bn, (int)splits, tws};
  for (int f = 0; f < kDFields; ++f) plan[f] = out[f];
  return 0;
}

// dy (n, ho, wo, ys) NHWC float32 with co real channels, the HWIO weight w
// (k, k, cip, cop) and, on the wgmma route, its tf32 big and small halves
// wb, wsm in the same layout (else null); dx (n, hi, wi, xs) is written,
// its ci real channels and 0 in the others; ws a (splits, n*hi*wi, ci)
// float32 workspace when splits > 1, else null. `table` is the class
// tables as conv_grad.py::class_table lays them out: the class count, then
// each class's y0, x0, hq, wq, ntaps and its taps' (tap, oy, ox). The plan
// as fn_conv2d_dgrad_plan gives it. One launch on `stream`, and the reduce
// when there are splits.
extern "C" int fn_conv2d_dgrad(const float* dy, const float* w,
                               const float* wb, const float* wsm, float* dx,
                               float* ws, const int* table, int n, int hi,
                               int wi, int xs, int ci, int ho, int wo, int ys,
                               int co, int k, int cip, int cop, int stride,
                               int route, int kc, int nt, int wm, int wn,
                               int bn, int splits, int tws, void* stream) {
  if (!dy || !w || !dx || !table || n < 1 || hi < 1 || wi < 1 || ho < 1 ||
      wo < 1 || k < 1 || k > 7 || stride < 1 || stride > 2 || ci < 1 ||
      ci > xs || ci > cip || co < 1 || co > ys || co > cop || xs % 4 ||
      ys % 4 || cop % 4 || splits < 1 || splits > kMaxSplitsD ||
      (splits > 1) != (ws != nullptr) || !aligned16(dy) || !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)n * hi * wi * xs > kMaxIndexD ||
      (long long)n * ho * wo * ys > kMaxIndexD ||
      (long long)n * hi * wi * ci * splits > kMaxIndexD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int co4 = (co + 3) / 4 * 4;
  int bm;
  const Kern* kern;
  if (route == 2) {
    if (!wb || !wsm || !aligned16(wb) || !aligned16(wsm) || kc != 32 ||
        wm != (bn == 64 ? 2 : 1))
      return static_cast<int>(cudaErrorInvalidValue);
    kern = kern_of(route, 32, bn, wm);
    bm = 128 * wm;
  } else {
    if ((route != 1 && route != 3) || wm < 1 || wn < 1 ||
        wm * wn > kMaxWarpsD || bn != 8 * nt * wn || (route == 3 && co4 > kc))
      return static_cast<int>(cudaErrorInvalidValue);
    kern = kern_of(route, kc, nt, 0);
    bm = 32 * wm;
  }
  if (!kern || (route != 1 && (splits != 1 || tws < 3 || tws > 4 ||
                                bm % (1 << tws))))
    return static_cast<int>(cudaErrorInvalidValue);

  DArgs a{};
  a.dy = dy;
  a.w = w;
  a.wb = wb;
  a.wsm = wsm;
  a.dx = dx;
  a.ws = ws;
  a.n = n;
  a.hi = hi;
  a.wi = wi;
  a.xs = xs;
  a.ci = ci;
  a.cells = n * hi * wi;
  a.ho = ho;
  a.wo = wo;
  a.ys = ys;
  a.co = co;
  a.co4 = co4;
  a.cip = cip;
  a.cop = cop;
  a.stride = stride;
  a.cpt = ceil_div_d(co4, kc);
  a.bm = bm;
  a.bn = bn;
  a.splits = splits;
  a.tws = tws;
  // The class tables; every dx cell in exactly one class. The patch
  // routes' tiles are TR x TW of one image, the gather's bm class cells.
  Table& t = a.t;
  t.ncls = table[0];
  if (t.ncls < 1 || t.ncls > kMaxClasses)
    return static_cast<int>(cudaErrorInvalidValue);
  int pos = 1, tiles = 0, patch_max = 0, taps_max = 0;
  long long cover = 0;
  for (int j = 0; j < t.ncls; ++j) {
    Cls& c = t.c[j];
    c.y0 = table[pos];
    c.x0 = table[pos + 1];
    c.hq = table[pos + 2];
    c.wq = table[pos + 3];
    c.ntaps = table[pos + 4];
    pos += 5;
    if (c.hq < 1 || c.wq < 1 || c.ntaps < 0 || c.ntaps > kMaxTaps ||
        c.y0 < 0 || c.x0 < 0 || c.y0 + stride * (c.hq - 1) >= hi ||
        c.x0 + stride * (c.wq - 1) >= wi)
      return static_cast<int>(cudaErrorInvalidValue);
    int oy_lo = 0, oy_hi = 0, ox_lo = 0, ox_hi = 0;
    for (int i = 0; i < c.ntaps; ++i, pos += 3) {
      const int tap = table[pos], oy = table[pos + 1], ox = table[pos + 2];
      if (tap < 0 || tap >= k * k || oy < -(1 << 14) || oy > (1 << 14) ||
          ox < -(1 << 14) || ox > (1 << 14))
        return static_cast<int>(cudaErrorInvalidValue);
      t.tap[j][i] = (short)tap;
      t.oy[j][i] = (short)oy;
      t.ox[j][i] = (short)ox;
      oy_lo = i && oy_lo < oy ? oy_lo : oy;
      oy_hi = i && oy_hi > oy ? oy_hi : oy;
      ox_lo = i && ox_lo < ox ? ox_lo : ox;
      ox_hi = i && ox_hi > ox ? ox_hi : ox;
    }
    // wgmma stages a chunk's patch with its first tap into one of two
    // slots: a chunk needs kStagesD - 1 taps or more.
    if (route == 2 && c.ntaps < kStagesD - 1)
      return static_cast<int>(cudaErrorInvalidValue);
    c.tile0 = tiles;
    if (route != 1) {
      const int tw = 1 << tws, tr = bm >> tws;
      tiles += n * ceil_div_d(c.hq, tr) * ceil_div_d(c.wq, tw);
      const int cells = (tr + oy_hi - oy_lo) * (tw + ox_hi - ox_lo);
      patch_max = cells > patch_max ? cells : patch_max;
      taps_max = c.ntaps > taps_max ? c.ntaps : taps_max;
    } else {
      tiles += ceil_div_d((long long)n * c.hq * c.wq, bm);
    }
    cover += (long long)c.hq * c.wq;
  }
  if (cover != (long long)hi * wi) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = dyn_smem(route, kc, bm, bn, patch_max, taps_max);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(tiles, ceil_div_d((ci + 7) / 8 * 8, bn), splits);
  const int threads = route == 2 ? 2 * 128 : 32 * wm * wn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern->fn<<<grid, threads, (size_t)smem, s>>>(a);
  int err = fnk::launch_status();
  if (err || splits == 1) return err;
  const long long total = (long long)a.cells * xs;
  dgrad_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      ws, dx, a.cells, xs, ci, splits);
  return fnk::launch_status();
}
