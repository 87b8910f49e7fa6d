// The weight gradient of kernel B's convolution: for an NHWC input x
// (n, hi, wi, ci) and the gradient dy (n, ho, wo, co) of its output,
//
//   dW[kh, kw, ci, co] = sum_{n, y, x} x[n, y*s + kh*d - pad,
//                                          x*s + kw*d - pad, ci] dy[n, y, x, co]
//   db[co]             = sum_{n, y, x} dy[n, y, x, co]
//
// (taps outside the input read 0: flax SAME padding, `pad` the top and
// left one), any odd k, stride and dilation. dW is HWIO, the layout kernel
// B takes. ops/kernels/conv_grad.py::conv2d_wgrad is its wrapper, which
// asks fn_conv2d_wgrad_plan (below) for the plan; the autograd function
// of ops/kernels/punet.py calls it in the backward of each conv of a
// training step.
//
// Replaces no TPU kernel: the JAX package trains through flax nn.Conv and
// lets XLA differentiate it (no Pallas kernel has a custom_vjp). It is
// here because every conv on the card runs on kernel B, which has no
// gradient of its own; the input gradient is conv2d_dgrad.cu's
// fn_conv2d_dgrad (ops/kernels/conv_grad.py::conv2d_dgrad).
// Its plain version is torch.nn.grad.conv2d_weight and a sum over dy.
//
// What bounds it on an H100: operations. It is a GEMM of the im2col
// matrix's transpose (K = k*k*ci rows) by dy (co columns) over M =
// n*ho*wo pixels, 2*M*K*co operations: 154.6 GFLOP for ScaleNet's 3x3
// 64->128 layer at 128^2, batch 64 (M = 1,048,576), 0.94 ms at the 3xTF32
// rate (495/3 TFLOP/s); its bytes (x and dy read once) take 0.24 ms.
//
// Design. The layer's real channel counts (ci, co) come with the call; x
// and dy are read at their stored (kernel B's padded) channel strides, only
// the real rows and columns of [dW; db] are computed, and the padded
// entries of the (k, k, xs, ys) gradient are written 0.
//  - Tensor cores at B's precision: mma.sync m16n8k8 tf32 in 3xTF32 form
//    (B's split of each operand into big + small, by split_tf32i below;
//    small*big + big*small + big*big). The
//    MMA's M is the rows of [dW; db] (tap-major: tap, then channel), N the
//    output channels, K the pixels: A is x^T, B is dy. Staged as [pixel]
//    [channel], A is column-major in shared memory, so its fragments are
//    32-bit loads; the pixel stride of the x patch (cs) and the row stride
//    of the dy tile (cy) are chosen by the planner so that the 8 rows x 4
//    pixels of a warp's load fall on 32 distinct banks.
//  - The plan (fn_conv2d_wgrad_plan, below): the warp tile's columns from
//    co, then the channel slice, m-tiles and warps of least modelled cost
//    at the runtime's occupancy, then splits that fill two waves. Its
//    plans beat one fixed plan per output-channel class by 1.52x summed
//    over the tower's backward and 1.35x over ScaleNet's.
//  - x read once a chunk, not k^2 times: a chunk is a tile of 64 output
//    pixels (TR rows x TW columns of one image, TW = 64 on a 128-wide
//    map); a block stages the halo'd x patch the chunk needs, ((TR-1)*s +
//    (k-1)*d + 1) x ((TW-1)*s + (k-1)*d + 1) pixels x its slice of
//    channels, zero-filled at the SAME border, and dy's 64 pixels x its
//    columns; every tap of the block's rows then reads the patch through a
//    per-row offset. A row's offset may also point at a slot of each patch
//    pixel that holds 1: that is db's row (row k*k*ci, in channel slice
//    0). Wide layers split the input channels into slices, and a slice's
//    rows into row blocks, so that the patch fits and the accumulators fit
//    in registers.
//  - A 3-stage ring of 16-byte cp.async copies stages the next chunks while
//    the warps multiply the current one; one barrier a chunk.
//  - Accuracy and determinism: the tensor cores sum each pair of k-steps
//    (16 pixels, six chained MMAs) from zero; the pairs' sums are added in
//    float32 over the chunk, and the chunk's sum is Kahan-added into the
//    block's running sum; a split of the pixels writes its partial tile to
//    a workspace and wgrad_reduce adds the splits in the order 0..S-1 with
//    Kahan. No atomics: repeats are bit-equal. The tensor cores' own sum
//    over a whole 64-pixel chunk was less exact than a float32 sum of the
//    same terms: a thin layer's gradient then came out nearly as far from
//    float64 as the plain float32 version's, or farther (PERF.md, "wgrad
//    redesigned for Hopper").
//
// Not wgmma: for tf32, wgmma wants both operands K-major, which here means
// pixel-contiguous, and NHWC gives neither (x and dy are channel-
// contiguous). It would need a transposing stage; that is a later
// redesign.
//
// Times (chip_smoke --train-only, H100 80GB HBM3 at 700 W; PERF.md,
// "Backward kernels"), device ms summed over one backward at 128^2, batch
// 64: FluidNetTower (10 calls) 1.49, cuDNN's conv2d_weight 2.18, the fmaf
// kernel this one replaced (CUDA cores, padded rows and columns) 11.45;
// MultiScaleNet (17 calls) 21.9, cuDNN 20.2, the fmaf kernel 71.8. The
// 3x3 64->128 and 128->64 layers at 128^2 take 5.92 and 6.55-6.63 ms, 26
// and 23 TFLOP/s of real work, 2.1x and 2.3x cuDNN's time.
#include "conv_mma.cuh"

namespace {

using namespace fnk::conv;

constexpr int kPix = 64;          // output pixels a chunk: a TR x TW tile
constexpr int kSteps = kPix / 8;  // m16n8k8 steps a chunk
constexpr int kStagesW = 3;       // depth of the cp.async ring
constexpr int kMaxWarps = 8;
constexpr int kMaxSplitsW = 1024;
constexpr long long kMaxIndex = 0x7fffffff;

// sum += v with Kahan's compensation c (the excess added so far: the sum
// is sum - c).
__device__ __forceinline__ void kahan_add(float& sum, float& c, float v) {
  const float y = v - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

// d = a (16x8 tf32, row) * b (8x8 tf32, col) + 0, float32.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// x = big + small, big = tf32(x) rounded to nearest with ties away from
// zero and small = tf32(x - big) (x - big is exact), as conv_mma.cuh's
// split_tf32 (cvt.rna.tf32.f32) gives them for finite x, with integer adds
// and masks in place of the conversion instruction, which took longer here
// (PERF.md, "wgrad redesigned for Hopper").
__device__ __forceinline__ void split_tf32i(float x, uint32_t& big,
                                            uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float rest = x - __uint_as_float(big);
  small = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

struct WArgs {
  const float* x;
  const float* dy;
  float* ws;
  int n, hi, wi, xs, ci;  // x (n, hi, wi, xs): the real channels ci <= xs
  int ho, wo, ys, co;     // dy (n, ho, wo, ys): the real channels co <= ys
  int k, stride, dil, pad;
  int cw, cs;      // channels a slice; floats a patch pixel (ones at cw)
  int nwr, nwc;    // warps over the block's rows, over its columns
  int tws;         // log2 TW: the chunk tile is (kPix >> tws) x (1 << tws)
  int cy;          // floats a pixel row of the dy tile
  int splits;
  int ph, pw;      // patch rows and columns
  int rws;         // log2 of the copy slots a patch row (>= pw * cw / 4)
  int rbs;         // row blocks a slice
  int tiles_y, tiles_x, chunks;
  int rows;        // k*k*ci + 1: rows of [dW; db] in the workspace
  int patch_f, stage_f;  // floats of a patch, of a ring stage
};

// One block: channel slice blockIdx.x / rbs, its row block blockIdx.x %
// rbs, the column block blockIdx.y, the split blockIdx.z (a contiguous
// range of chunks). Warp (wr, wc) owns WM m-tiles x WN n-tiles.
template <int WM, int WN>
__global__ void __launch_bounds__(kMaxWarps * 32) wgrad_mma(WArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int slice = blockIdx.x / a.rbs, rblk = blockIdx.x % a.rbs;
  const int c_lo = slice * a.cw;
  const int cws = min(a.cw, a.ci - c_lo);  // real channels of the slice
  const int kk = a.k * a.k;
  const int kc = kk * cws;                 // tap rows of the slice
  const int srows = kc + (slice == 0);     // slice 0 adds db's row
  const int r0 = rblk * a.nwr * WM * 16;
  if (r0 >= srows) return;  // the whole block: an empty row block
  const int bc = a.nwc * WN * 8;
  const int n0 = blockIdx.y * bc;
  const int wr = warp / a.nwc, wc = warp % a.nwc;
  const int tw = 1 << a.tws, tr = kPix >> a.tws;
  const int rw0 = r0 + wr * WM * 16;  // the warp's first row

  // The patch offsets of this lane's A rows, g and g + 8 of each m-tile:
  // a tap row reads (ky*d, kx*d) from the pixel's corner, channel ch; db's
  // row (and the padded rows past it, never stored) the slot of ones.
  int roff[WM][2];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw0 + mt * 16 + h * 8 + g;
      int off = a.cw;
      if (r < kc) {
        const int tap = r / cws, ch = r - tap * cws;
        const int ky = tap / a.k, kx = tap - ky * a.k;
        off = (ky * a.dil * a.pw + kx * a.dil) * a.cs + ch;
      }
      roff[mt][h] = off;
    }

  // The slot of ones in every patch pixel of every stage (the copies write
  // channels 0 .. cw-1 only).
  for (int i = tid; i < kStagesW * a.ph * a.pw; i += nthr) {
    const int st = i / (a.ph * a.pw), pix = i - st * a.ph * a.pw;
    sm[st * a.stage_f + pix * a.cs + a.cw] = 1.f;
  }

  const int nv = a.cw >> 2, nvs = __ffs(nv) - 1;  // 16-byte pieces a pixel
  const int c4 = (cws + 3) & ~3;                  // channels copied
  const int nu = bc >> 2, nus = __ffs(nu) - 1;    // pieces a dy pixel
  const int co4 = (a.co + 3) & ~3;
  const int rw = 1 << a.rws;
  const int per_img = a.tiles_y * a.tiles_x;
  const float* xs_base = a.x + c_lo;

  // Stage chunk c into ring slot st: the halo'd patch of x (zero outside
  // the input) and dy's 64 pixels x bc columns (zero past the map's edge
  // and past co).
  auto load = [&](int c, int st) {
    const int img = c / per_img, rem = c - img * per_img;
    const int ty = rem / a.tiles_x, tx = rem - ty * a.tiles_x;
    const int yo0 = ty * tr, xo0 = tx * tw;
    const int iy0 = yo0 * a.stride - a.pad, ix0 = xo0 * a.stride - a.pad;
    float* patch = sm + st * a.stage_f;
    float* dyt = patch + a.patch_f;
    const float* ximg = xs_base + img * a.hi * a.wi * a.xs;
    for (int q = tid; q < a.ph * rw; q += nthr) {
      const int py = q >> a.rws, rq = q & (rw - 1);
      const int px = rq >> nvs, v = rq & (nv - 1);
      if (px >= a.pw || 4 * v >= c4) continue;
      const int iy = iy0 + py, ix = ix0 + px;
      const bool ok = iy >= 0 && iy < a.hi && ix >= 0 && ix < a.wi;
      const float* src = ok ? ximg + (iy * a.wi + ix) * a.xs + 4 * v : a.x;
      cp_async16(patch + (py * a.pw + px) * a.cs + 4 * v, src, ok);
    }
    const float* dimg = a.dy + img * a.ho * a.wo * a.ys;
    for (int q = tid; q < kPix * nu; q += nthr) {
      const int p = q >> nus, u = q & (nu - 1);
      const int yo = yo0 + (p >> a.tws), xo = xo0 + (p & (tw - 1));
      const int col = n0 + 4 * u;
      const bool ok = yo < a.ho && xo < a.wo && col < co4;
      const float* src = ok ? dimg + (yo * a.wo + xo) * a.ys + col : a.dy;
      cp_async16(dyt + p * a.cy + 4 * u, src, ok);
    }
  };

  float acc[WM][WN][4], comp[WM][WN][4];
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = comp[mt][nt][e] = 0.f;

  const int c_beg = (int)((long long)blockIdx.z * a.chunks / a.splits);
  const int c_end = (int)((long long)(blockIdx.z + 1) * a.chunks / a.splits);
  const int nch = c_end - c_beg;
  for (int s = 0; s < kStagesW - 1; ++s) {
    if (s < nch) load(c_beg + s, s);
    cp_async_commit();
  }
  const int pstep = a.stride * a.cs;  // patch floats between two pixels
  for (int i = 0; i < nch; ++i) {
    cp_async_wait<kStagesW - 2>();
    __syncthreads();  // chunk i has arrived; slot (i - 1) % 3 is free
    if (i + kStagesW - 1 < nch)
      load(c_beg + i + kStagesW - 1, (i + kStagesW - 1) % kStagesW);
    cp_async_commit();

    const float* patch = sm + (i % kStagesW) * a.stage_f;
    const float* dyt = patch + a.patch_f;
    // The tensor cores sum each pair of k-steps (16 pixels) from zero;
    // the pairs' sums are added in float32 and the chunk's sum joins the
    // running sum by a Kahan add.
    float part[WM][WN][4];
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int nt = 0; nt < WN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
    float st[WM][WN][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      // Pixels p and p + 4 (the step's K columns t and t + 4) lie in one
      // row of the tile (TW >= 8).
      const int p = ks * 8 + t;
      const int po = ((p >> a.tws) * a.pw + (p & (tw - 1))) * pstep;
      const int po4 = po + 4 * pstep;
      uint32_t bb[WN][2], bsm[WN][2];
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) {
        const int col = (wc * WN + nt) * 8 + g;
        split_tf32i(dyt[p * a.cy + col], bb[nt][0], bsm[nt][0]);
        split_tf32i(dyt[(p + 4) * a.cy + col], bb[nt][1], bsm[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < WM; ++mt) {
        const float av[4] = {patch[roff[mt][0] + po], patch[roff[mt][1] + po],
                             patch[roff[mt][0] + po4],
                             patch[roff[mt][1] + po4]};
        uint32_t ab[4], asm_[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32i(av[e], ab[e], asm_[e]);
#pragma unroll
        for (int nt = 0; nt < WN; ++nt) {
          if (ks % 2 == 0)
            mma_tf32_zero(st[mt][nt], asm_, bb[nt]);
          else
            mma_tf32(st[mt][nt], asm_, bb[nt]);
          mma_tf32(st[mt][nt], ab, bsm[nt]);
          mma_tf32(st[mt][nt], ab, bb[nt]);
          if (ks % 2 == 1) {
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][nt][e] += st[mt][nt][e];
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < WM; ++mt)
#pragma unroll
      for (int nt = 0; nt < WN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kahan_add(acc[mt][nt][e], comp[mt][nt][e], part[mt][nt][e]);
  }
  cp_async_wait<0>();

  // The split's partial tile: rows of the slice to their rows of [dW; db]
  // (tap * ci + channel; db's row k*k*ci), real columns only.
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw0 + mt * 16 + h * 8 + g;
      if (r >= srows) continue;
      int grow = kk * a.ci;
      if (r < kc) {
        const int tap = r / cws;
        grow = tap * a.ci + c_lo + (r - tap * cws);
      }
      float* dst = a.ws + ((size_t)blockIdx.z * a.rows + grow) * a.co;
#pragma unroll
      for (int nt = 0; nt < WN; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + (wc * WN + nt) * 8 + 2 * t + j;
          if (col < a.co)
            dst[col] = acc[mt][nt][2 * h + j] - comp[mt][nt][2 * h + j];
        }
    }
}

// dW (k, k, xs, ys) and db (ys): each real entry the sum of the splits'
// partial tiles in the order 0..S-1 (Kahan), each padded entry 0.
__global__ void wgrad_reduce(const float* __restrict__ ws,
                             float* __restrict__ dw, float* __restrict__ db,
                             int kk, int xs, int ys, int ci, int co, int rows,
                             int splits) {
  const long long nw = (long long)kk * xs * ys;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nw + ys) return;
  int grow = -1, col;
  if (e < nw) {
    const int tap = (int)(e / ((long long)xs * ys));
    const int rem = (int)(e - (long long)tap * xs * ys);
    const int ch = rem / ys;
    col = rem - ch * ys;
    if (ch < ci && col < co) grow = tap * ci + ch;
  } else {
    col = (int)(e - nw);
    if (col < co) grow = kk * ci;
  }
  float s = 0.f;
  if (grow >= 0) {
    const long long total = (long long)rows * co;
    const long long o = (long long)grow * co + col;
    float c = 0.f;
    s = ws[o];
    for (int i = 1; i < splits; ++i) kahan_add(s, c, ws[i * total + o]);
    s = s - c;
  }
  if (e < nw)
    dw[e] = s;
  else
    db[e - nw] = s;
}

// The instantiated warp tiles (WM x WN m16n8 tiles a warp): the planner
// picks among them and the entry launches the one picked: the tiles the
// tower's and ScaleNet's layers get (each instantiation costs build time).
struct Tile {
  int wm, wn;
  void (*fn)(WArgs);
};
const Tile kTiles[] = {{1, 1, wgrad_mma<1, 1>}, {4, 1, wgrad_mma<4, 1>},
                       {1, 2, wgrad_mma<1, 2>}, {2, 2, wgrad_mma<2, 2>},
                       {1, 4, wgrad_mma<1, 4>}, {2, 4, wgrad_mma<2, 4>}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

// The tile of (wm, wn), its dynamic shared memory limit raised to
// kMaxSmem on first use; nullptr where none is instantiated.
const Tile* tile_of(int wm, int wn) {
  static bool raised[kNumTiles] = {};
  for (int i = 0; i < kNumTiles; ++i) {
    if (kTiles[i].wm != wm || kTiles[i].wn != wn) continue;
    if (!raised[i]) {
      if (cudaFuncSetAttribute(kTiles[i].fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem) != cudaSuccess)
        return nullptr;
      raised[i] = true;
    }
    return &kTiles[i];
  }
  return nullptr;
}

bool pow2_in(int v, int lo, int hi) {
  return v >= lo && v <= hi && (v & (v - 1)) == 0;
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The least multiple of 4 >= lo whose multiple by step is 8 or 24 modulo
// 32 banks: a warp's fragment load (8 rows x 4 pixels, the pixels `step`
// strides apart) then hits 32 distinct banks. lo rounded up to 4 where no
// stride within 32 floats does.
int bank_stride(int lo, int step) {
  const int base = ceil_div(lo, 4) * 4;
  for (int c = base; c < base + 32; c += 4)
    if (c * step % 32 == 8 || c * step % 32 == 24) return c;
  return base;
}

// The planner's cost model: the padded MMA work (three mma.sync a
// product) at the rate mma.sync reaches and the L2 -> shared memory
// traffic of the staged patches and dy tiles; only the ratio of the two
// rates matters.
constexpr double kMmaRate = 200e12;
constexpr double kL2Rate = 5e12;
constexpr int kSplitsPlan = 256;  // the reduce adds the splits in turn
constexpr int kMinChunks = 32;    // chunks a split at least
constexpr int kWaves = 2;         // waves of resident blocks a launch

enum PlanField { kCw, kCs, kWm, kWn, kNwr, kNwc, kTw, kCy, kSplits, kFields };

}  // namespace

// The plan of a layer of real channels ci -> co on an output map n x ho x
// wo (k x k taps, stride, dilation) into plan[kFields]: the channel slice
// cw, the patch pixel stride cs, the warp tile wm x wn, nwr x nwc warps,
// the chunk tile width tw, the dy tile row stride cy, the splits. wn and
// nwc follow from co (8, 16 or 32 columns a warp, up to 4 warps across),
// tw from wo; cw, wm and nwr minimise the cost of the padded MMA work
// plus the L2 traffic of the staged patches and dy tiles (each row block
// stages its slice's whole patch), divided by the SM's share of 8
// resident warps (the runtime's occupancy of the tile at that shared
// memory); the splits then fill kWaves waves of resident blocks, at most
// kSplitsPlan, each at least kMinChunks chunks. A positive plan[kCw],
// plan[kWm] or plan[kNwr] on entry fixes that field. Returns 0, or a CUDA
// error where no plan fits.
extern "C" int fn_conv2d_wgrad_plan(int n, int ho, int wo, int ci, int co,
                                    int k, int stride, int dil, int* plan) {
  if (!plan || n < 1 || ho < 1 || wo < 1 || ci < 1 || co < 1 || k < 1 ||
      stride < 1 || dil < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fix_cw = plan[kCw], fix_wm = plan[kWm], fix_nwr = plan[kNwr];
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int wn = co <= 8 ? 1 : co <= 16 ? 2 : 4;
  int nwc = 1;
  while (nwc < 4 && nwc < ceil_div(co, 8 * wn)) nwc *= 2;
  const int bc = nwc * wn * 8;
  const int ncb = ceil_div(co, bc);
  int tw = 8;
  while (tw < kPix && tw < wo) tw *= 2;
  const int tr = kPix / tw;
  const int ph = (tr - 1) * stride + (k - 1) * dil + 1;
  const int pw = (tw - 1) * stride + (k - 1) * dil + 1;
  const int cy = bank_stride(bc, 1);
  const double m = (double)n * ho * wo;
  double best = 0.;
  int best_warps = 0, found = 0;
  for (int cw = 4; cw <= 64; cw *= 2) {
    if (fix_cw > 0 ? cw != fix_cw : cw > 4 && cw / 2 >= ci) continue;
    const int cs = bank_stride(cw + 1, stride);
    const long long smem = 4LL * kStagesW * (ph * pw * cs + kPix * cy);
    if (smem > kMaxSmem) continue;
    const int slices = ceil_div(ci, cw);
    const int cwr = ci < cw ? ci : cw;
    const int rows = k * k * cwr + 1;
    for (int wm = 1; wm <= 4; wm *= 2) {
      const Tile* t = fix_wm > 0 && wm != fix_wm ? nullptr : tile_of(wm, wn);
      if (!t) continue;
      for (int nwr = 1; nwr * nwc <= kMaxWarps; ++nwr) {
        if (fix_nwr > 0 ? nwr != fix_nwr : (nwr - 1) * wm * 16 >= rows)
          continue;
        const int rb = nwr * wm * 16, warps = nwr * nwc;
        const int blocks = slices * ceil_div(rows, rb) * ncb;
        int resident = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &resident, t->fn, warps * 32, (size_t)smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (resident < 1) continue;
        const double mma = 6. * m * blocks * rb * bc / kMmaRate;
        const double traffic =
            m * blocks * (4. * ph * pw * cwr / kPix + 4. * bc) / kL2Rate;
        const double share = 8. / ((double)resident * warps);
        const double cost = (mma + traffic) * (share > 1. ? share : 1.);
        if (!found || cost < best || (cost == best && warps > best_warps)) {
          found = 1;
          best = cost;
          best_warps = warps;
          const long long chunks =
              (long long)n * ceil_div(ho, tr) * ceil_div(wo, tw);
          long long splits = (long long)kWaves * sms * resident / blocks;
          if (splits > kSplitsPlan) splits = kSplitsPlan;
          if (splits > chunks / kMinChunks) splits = chunks / kMinChunks;
          if (splits < 1) splits = 1;
          const int out[kFields] = {cw, cs, wm, wn, nwr, nwc, tw, cy,
                                    (int)splits};
          for (int f = 0; f < kFields; ++f) plan[f] = out[f];
        }
      }
    }
  }
  return found ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// x (n, hi, wi, xs) and dy (n, ho, wo, ys) NHWC float32, the layer's real
// channels ci <= xs and co <= ys; dw (k, k, xs, ys) and db (ys,) are
// written (0 in the padded entries); ws is a (splits, k*k*ci + 1, co)
// float32 workspace. The plan, as fn_conv2d_wgrad_plan gives it: channel
// slice cw, patch pixel stride cs, warp tile wm x wn MMA tiles, nwr x nwc
// warps, chunk tile width tw, dy tile row stride cy, splits.
// Two launches on `stream`: the partial tiles, then the reduce.
extern "C" int fn_conv2d_wgrad(const float* x, const float* dy, float* dw,
                               float* db, float* ws, int n, int hi, int wi,
                               int xs, int ci, int ho, int wo, int ys, int co,
                               int k, int stride, int dil, int pad, int cw,
                               int cs, int wm, int wn, int nwr, int nwc,
                               int tw, int cy, int splits, void* stream) {
  if (!x || !dy || !dw || !db || !ws || n < 1 || hi < 1 || wi < 1 ||
      ho < 1 || wo < 1 || k < 1 || stride < 1 || dil < 1 || pad < 0 ||
      ci < 1 || ci > xs || co < 1 || co > ys || xs % 4 || ys % 4 ||
      !aligned16(x) || !aligned16(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  // The plan's shapes: an instantiated warp tile, power-of-two slices,
  // columns and chunk widths, strides with room for the slot of ones.
  const Tile* tile = tile_of(wm, wn);
  if (!tile || !pow2_in(cw, 4, 64) || cs <= cw || cs % 4 ||
      !pow2_in(nwc, 1, 4) || nwr < 1 || nwr * nwc > kMaxWarps ||
      !pow2_in(tw, 8, kPix) || cy % 4 || cy < nwc * wn * 8 || splits < 1 ||
      splits > kMaxSplitsW)
    return static_cast<int>(cudaErrorInvalidValue);
  // The kernels index x, dy and the patch with 32-bit ints.
  if ((long long)n * hi * wi * xs > kMaxIndex ||
      (long long)n * ho * wo * ys > kMaxIndex)
    return static_cast<int>(cudaErrorInvalidValue);
  WArgs a;
  a.x = x;
  a.dy = dy;
  a.ws = ws;
  a.n = n;
  a.hi = hi;
  a.wi = wi;
  a.xs = xs;
  a.ci = ci;
  a.ho = ho;
  a.wo = wo;
  a.ys = ys;
  a.co = co;
  a.k = k;
  a.stride = stride;
  a.dil = dil;
  a.pad = pad;
  a.cw = cw;
  a.cs = cs;
  a.nwr = nwr;
  a.nwc = nwc;
  a.tws = log2i(tw);
  a.cy = cy;
  a.splits = splits;
  const int tr = kPix / tw;
  a.ph = (tr - 1) * stride + (k - 1) * dil + 1;
  a.pw = (tw - 1) * stride + (k - 1) * dil + 1;
  a.rws = log2i(a.pw * (cw / 4));
  a.rbs = (k * k * (ci < cw ? ci : cw) + 1 + nwr * wm * 16 - 1) /
          (nwr * wm * 16);
  a.tiles_y = (ho + tr - 1) / tr;
  a.tiles_x = (wo + tw - 1) / tw;
  const long long chunks = (long long)n * a.tiles_y * a.tiles_x;
  if (chunks > kMaxIndex || splits > chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  a.chunks = (int)chunks;
  a.rows = k * k * ci + 1;
  a.patch_f = a.ph * a.pw * cs;
  a.stage_f = a.patch_f + kPix * cy;
  const long long smem = (long long)kStagesW * a.stage_f * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (ci + cw - 1) / cw;
  const int bc = nwc * wn * 8;
  dim3 grid(slices * a.rbs, (co + bc - 1) / bc, splits);
  const int threads = nwr * nwc * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile->fn<<<grid, threads, (size_t)smem, s>>>(a);
  const int err = fnk::launch_status();
  if (err) return err;
  const long long total = (long long)k * k * xs * ys + ys;
  wgrad_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      ws, dw, db, k * k, xs, ys, ci, co, a.rows, splits);
  return fnk::launch_status();
}
