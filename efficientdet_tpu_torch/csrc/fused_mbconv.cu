// Fused stride-1 inference MBConv, one kernel family for three layouts.
//
// Replaces three Pallas kernels of the JAX package's experiments, which all
// compute one function for a stride-1 block with its BN folded into biases,
//
//   y = proj(SE(swish(dw(swish(expand(x)))))) [+ x]
//
// and differ only in how the activations are laid out:
//
//   experiments/packed_mbconv_pallas.py, _kernel     (B, C, H*W), column wrap masks
//   experiments/packed_mbconv_pallas.py, _rp_kernel  (B, C, Hp*Wp), rows and
//       columns padded with zeros, a 0/1 mask of the real lanes as an input
//   experiments/mbconv_pallas.py, _kernel            (B, H, W, C)
//
// Here a layout is a set of strides (image, channel, pixel) and an origin:
// the kernels walk the H x W grid of real pixels, which lies at (oy, ox) in
// the image held in memory. For the row-padded layout that image is the
// padded one, its padding is data (the halos read it), and its ring of gap
// lanes is written by a small fourth launch, so its tile count equals the
// packed layout's.
//
// Why not the TPU design: the TPU kernels keep a whole image (0.8-4.3 MB)
// in VMEM for one grid step and take the SE's global mean there. A Hopper
// block has at most 227 KB of shared memory, and blocks run in no order, so
// the mean is a reduction across blocks, in three launches (four for rp):
//
//   1. mbconv_pass_kernel<T, K, 0> (pool), a block per (spatial tile, image):
//      the x halo tile into shared memory; then per chunk of CC expanded
//      channels, expand + swish the halo, take the k x k taps, add the bias,
//      swish, and sum over the tile. Each tile's channel sums go to a float32
//      scratch (B, tiles, Ce); no atomics, so a run repeats bit for bit.
//   2. mbconv_se_kernel, a block per image: the mean over its tiles' sums,
//      then the SE's two small products and the sigmoid, in float32.
//   3. mbconv_pass_kernel<T, K, NT> (project): the same recompute per chunk,
//      times the SE scale, rounded, and projected onto NT = ceil(Cout / 8)
//      column tiles, the sums kept in registers over the chunks.
//   4. rp only, mbconv_rp_ring_kernel: the gap lanes, exact zeros (x's own
//      values under a skip).
//
// Recompute or store: the depthwise output is recomputed in the project
// pass, not stored between the passes. Storing it in the input dtype would
// add a rounding point the plain versions do not have; in float32 it is
// 1.2 GB each way at D0's stage-2 block (about 0.72 ms at 3.35 TB/s), more
// than the whole recomputing pass takes there.
//
// What bounds it on an H100: operations on the CUDA cores. The block must
// read x and write y (d0s1 at batch 128: 805 MB, 0.24 ms at 3.35 TB/s) but
// does k*k float32 FMAs and two swishes per expanded channel and pixel,
// twice (two passes). What the design does about it, bf16 (the target):
//   - both 1x1 products run on the tensor cores (mma.sync m16n8k16, float32
//     sums). Expand: M = the chunk's 32 channels (A = wexp columns, held in
//     registers for the chunk), N = halo pixels in tiles of 8 (B = the x halo
//     tile, channel-major in shared memory, read by ldmatrix.trans), K = Cin
//     zero-padded to a multiple of 16; the epilogue adds the bias, takes the
//     swish, multiplies by the halo mask (0 outside the image, the rp mask
//     inside), rounds, and stores bf16 pairs. Project: M = a tile row's 32
//     pixels per warp, N = Cout in tiles of 8 (no wider padding), K = the
//     chunk; A is the scaled, rounded depthwise output in shared memory.
//   - the taps run from registers: a thread owns one channel's strip of
//     R rows x 8 pixels, loads each input row of the strip once (three
//     8-byte loads of bf16), and slides the window over it: about 0.06 (k3)
//     to 0.03 (k5) shared loads per FMA.
//   - a 16 x 32 tile (halo factor 1.27 at k3, 1.56 at k5 with its rows
//     padded to 36) and chunks of 32 channels, two block barriers a chunk;
//     the next chunk's weights set off by cp.async before this chunk's taps
//     (two buffers) and are waited for after them; the project of chunk i-1
//     shares a phase with the expand of chunk i.
//   - one special-function instruction per swish: 0.5 v (1 + tanh.approx(0.5
//     v)) (relative error of tanh.approx 2^-11, below the bf16 rounding that
//     follows it), the halving folded into the bias.
//   - tile traffic is one warp per row: 64-byte coalesced runs, no division
//     per element; NHWC moves a pixel's channels in 16-byte pieces; the halo
//     mask is staged once a tile.
//   - blocks an SM: a block has 512 threads, so 128 registers a thread allow
//     one block an SM and 64 allow two. The k3 pool pass (no project sums)
//     and the k3 passes of a block without an expand up to Cout 24 (their
//     own instances, without the expand's registers) are held to 64 and run
//     two blocks an SM where their shared memory (37-203 KB at the recorded
//     shapes) allows; every other pass runs one.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py's
// mbconv_kernels phase: 0.75-1.75 ms a block, about 6 times its bound): not
// one unit. With the phases of a chunk cut out one at a time, no phase is
// worth more than half of a pass; a block is a chain of short phases between
// barriers (load, expand, taps, project, store), and one or two blocks an SM
// leave their latencies uncovered: a second block an SM was worth 15-20% of
// a pass wherever the registers allowed it. Tried and not kept, for no gain
// on the card: one block walking several tiles with the next tile's x
// loading under this tile's chunks; an 8 x 32 tile with 256 threads (two to
// four blocks an SM, but 1.41x and 1.69x the halo); the channel-major x tile
// by aligned 16-byte loads in place of 4-byte cp.async. The NHWC layout,
// whose tile rows are whole runs of memory, is the fastest of the three at
// the blocks without an expand.
//
// float32 (the card-vs-plain check's path, not the target) shares the walk
// on an 8 x 32 tile with chunks of 16: its products stay float32 FMAs (TF32
// would break its tolerance), its swish keeps __expf and __fdividef.
//
// Rounding points follow the Pallas kernels: the expanded activation is
// rounded to the input dtype after its swish; taps, SE and the scale run in
// float32; the scaled activation is rounded to the input dtype before the
// project, whose sums are float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TW = 32;        // tile width in pixels
constexpr int COLS = 36;      // halo row pitch: TW + 2 * HC
constexpr int HC = 2;         // halo columns left of the tile, for k3 too: rows start on even pixels
constexpr int STRIPS = 4;     // strips of 8 pixels across a tile row
constexpr int RGROUPS = 4;    // row groups down a tile
constexpr int LOADS = 8;      // rows a warp loads before it stores any
constexpr int SMEM_MAX = 232448;

template <typename T> struct Cfg;
template <> struct Cfg<bf16> { static constexpr int TH = 16, CC = 32; };
template <> struct Cfg<float> { static constexpr int TH = 8, CC = 16; };
// threads = 32 * TH = CC * STRIPS * RGROUPS: a thread a (channel, row group, strip)

struct Geo {
  int H, W;                      // the grid walked: the real pixels
  int HI, WI, oy, ox;            // the image in memory and the grid's origin in it
  int cin, ce, cout, cr;
  int xrows;                     // channel rows of the x tile in shared memory
  long long in_b, in_c, in_p;    // x strides: image, channel, pixel
  long long out_b, out_c, out_p; // y strides
  int tiles_x, tiles;
  int has_expand, has_skip, nhwc;
  int words;                     // x rows may be read as aligned 4-byte words
  int wwords;                    // and so may the weights' rows
  int vec_in, vec_out;           // NHWC: a pixel's channels of x, of y, are aligned 16-byte pieces
  float inv_n;                   // 1 / the number of real pixels
};

struct Params {  // the packed tuple, input dtype
  const void *wexp, *bexp, *wdw, *bdw, *wser, *bser, *wsee, *bsee, *wproj, *bproj;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
// round to T and back
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// The activations' swish of (sum + bias), once per expanded channel and
// (halo) pixel in each pass. bf16: one special-function instruction,
// 0.5 v (1 + tanh(0.5 v)), with the halving folded into the bias (act_bias
// gives bias / 2, and sum / 2 + bias / 2 rounds as (sum + bias) / 2 does);
// float32: the fast exponential and division (a few ulps). The SE's sigmoid
// and swish, once per channel and image, take the accurate ones.
template <typename T> __device__ __forceinline__ float act_bias(float bias);
template <> __device__ __forceinline__ float act_bias<float>(float bias) { return bias; }
template <> __device__ __forceinline__ float act_bias<bf16>(float bias) { return 0.5f * bias; }
template <typename T> __device__ __forceinline__ float act(float sum, float bias);
template <> __device__ __forceinline__ float act<float>(float sum, float bias) {
  const float v = sum + bias;
  return __fdividef(v, 1.f + __expf(-v));
}
template <> __device__ __forceinline__ float act<bf16>(float sum, float half_bias) {
  const float h = fmaf(sum, 0.5f, half_bias);
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(h));
  return fmaf(h, th, h);
}
__device__ __forceinline__ float swishf(float v) { return v / (1.f + expf(-v)); }
__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }
// the least odd multiple of 8 that holds n: rows at this pitch start in
// distinct 16-byte bank groups (ldmatrix, the strips' loads)
__host__ __device__ constexpr int odd8(int n) { return 8 * (((n + 7) / 8) | 1); }

template <typename T, int K> struct Tile {
  static constexpr int TH = Cfg<T>::TH, CC = Cfg<T>::CC;
  static constexpr int THREADS = 32 * TH, WARPS = TH, TILE = TH * TW;
  static constexpr int R = TH / RGROUPS;                  // output rows a thread
  static constexpr int P = K / 2, ROWS = TH + 2 * P, PIXP = ROWS * COLS;
  static constexpr int S = odd8(PIXP);                    // pitch of a halo channel row
  static constexpr int SDS = odd8(TILE);                  // pitch of a tile channel row
  static constexpr int WES = CC + 8;                      // pitch of a wexp row (a chunk's columns)
};
__host__ __device__ constexpr int wps_pitch(int nt) { return 8 * ((nt + 1) | 1); }

// Shared memory of a pass block, in bytes from the start:
//   xs  T xrows x S        the x halo tile, channel-major
//   es  T CC x S           the chunk's expanded activation (none without an expand:
//                          the taps read xs)
//   sd  T CC x SDS         the chunk's scaled, rounded depthwise output (project only)
//   (the output tile, T cout x SDS, aliases es and sd after the chunks)
//   hm  f32 PIXP           the halo mask
//   two weight buffers, each: wes T xrows x WES | bes T CC | wds T CC x K*K |
//   bds T CC | scs f32 CC | wps T CC x wps_pitch(NT)
struct Plan {
  int xs, es, sd, hm, wb, wbuf, wes, bes, wds, bds, scs, wps, total;
};

template <typename T, int K>
__host__ __device__ Plan smem_plan(int xrows, int cout, int has_expand, int nt) {
  using Tl = Tile<T, K>;
  const int sz = (int)sizeof(T);
  Plan p;
  int o = 0;
  p.xs = o; o += align16(xrows * Tl::S * sz);
  p.es = o; if (has_expand) o += align16(Tl::CC * Tl::S * sz);
  p.sd = o; if (nt > 0) o += align16(Tl::CC * Tl::SDS * sz);
  if (nt > 0) {
    const int yend = p.es + align16(cout * Tl::SDS * sz);
    if (yend > o) o = yend;
  }
  p.hm = o; o += align16(Tl::PIXP * 4);
  p.wb = o;
  int w = 0;
  p.wes = w; if (has_expand) w += align16(xrows * Tl::WES * sz);
  p.bes = w; w += align16(Tl::CC * sz);
  p.wds = w; w += align16(Tl::CC * K * K * sz);
  p.bds = w; w += align16(Tl::CC * sz);
  p.scs = w; w += Tl::CC * 4;
  p.wps = w; if (nt > 0) w += align16(Tl::CC * wps_pitch(nt) * sz);
  p.wbuf = w;
  p.total = p.wb + 2 * w;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four / two 8x8 b16 matrices, transposed: thread l gets, of matrix j, the
// elements (row 2 (l % 4), row 2 (l % 4) + 1) of column l / 4; lanes 8j..8j+7
// give the addresses of matrix j's rows
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 bytes global -> shared; with full == false nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until this thread's cp.asyncs have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The halo mask and the x halo tile. hm: 0 outside the image in memory, else
// the rp mask's value (1 without a mask). xs: zero outside the image and in
// the channel rows that pad Cin. One warp a row: the channel-major layouts
// read runs of 36 pixels, NHWC a pixel's channels; each warp issues LOADS
// rows of loads before it stores any, so that their latencies overlap.
template <typename T, int K>
__device__ void load_tile(const T* __restrict__ x, const T* __restrict__ mask, const Geo& g,
                          int b, int y0, int x0, T* xs, float* hm) {
  using Tl = Tile<T, K>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int iy0 = y0 - Tl::P + g.oy, ix0 = x0 - HC + g.ox;  // the halo's origin in the image
  for (int hp = threadIdx.x; hp < Tl::PIXP; hp += Tl::THREADS) {
    const int hy = hp / COLS, hx = hp - hy * COLS;
    const int iy = iy0 + hy, ix = ix0 + hx;
    float m = 0.f;
    if (iy >= 0 && iy < g.HI && ix >= 0 && ix < g.WI)
      m = mask ? to_f(mask[(long long)iy * g.WI + ix]) : 1.f;
    hm[hp] = m;
  }
  const T* xb = x + (long long)b * g.in_b;
  const T zero = from_f<T>(0.f);
  if (g.nhwc && g.vec_in) {
    // a thread a pixel (neighbouring lanes, neighbouring pixels: their stores
    // into a channel row do not collide), four 16-byte pieces of its channels
    // in flight at a time
    constexpr int V = 16 / (int)sizeof(T);
    const int pieces = g.xrows / V;
    for (int hp = threadIdx.x; hp < Tl::PIXP; hp += Tl::THREADS) {
      const int hy = hp / COLS, hx = hp - hy * COLS;
      const int iy = iy0 + hy, ix = ix0 + hx;
      const bool in = iy >= 0 && iy < g.HI && ix >= 0 && ix < g.WI;
      const T* src = xb + ((long long)iy * g.WI + ix) * g.in_p;
      for (int q0 = 0; q0 < pieces; q0 += 4) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = (q0 + u) * V;
          v[u] = (in && c < g.cin) ? *reinterpret_cast<const uint4*>(src + c) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (q0 + u >= pieces) break;
          const T* vals = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
          for (int j = 0; j < V; ++j) xs[((q0 + u) * V + j) * Tl::S + hp] = vals[j];
        }
      }
    }
    return;
  }
  if (g.nhwc) {
    for (int cb = 0; cb < g.xrows; cb += 64)
      for (int h0 = warp; h0 < Tl::PIXP; h0 += Tl::WARPS * LOADS) {
        const int c0 = cb + lane, c1 = cb + lane + 32;
        T v0[LOADS], v1[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const int hp = h0 + u * Tl::WARPS;
          const int hy = hp / COLS, hx = hp - hy * COLS;
          const int iy = iy0 + hy, ix = ix0 + hx;
          const bool in = hp < Tl::PIXP && iy >= 0 && iy < g.HI && ix >= 0 && ix < g.WI;
          const T* src = xb + ((long long)iy * g.WI + ix) * g.in_p;
          v0[u] = (in && c0 < g.cin) ? src[c0] : zero;
          v1[u] = (in && c1 < g.cin) ? src[c1] : zero;
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const int hp = h0 + u * Tl::WARPS;
          if (hp >= Tl::PIXP) continue;
          if (c0 < g.xrows) xs[c0 * Tl::S + hp] = v0[u];
          if (c1 < g.xrows) xs[c1 * Tl::S + hp] = v1[u];
        }
      }
    return;
  }
  const int nrows = g.xrows * Tl::ROWS;
  if (g.words) {
    // every row at once, global to shared memory in aligned 4-byte words
    // (two bf16 pixels, both inside the image or both outside), zero-filled
    // outside; the caller's barrier follows cp_async_wait_all
    constexpr int PPW = 4 / (int)sizeof(T), WPR = COLS / PPW;
    for (int f = threadIdx.x; f < nrows * WPR; f += Tl::THREADS) {
      const int r = f / WPR, j = (f - r * WPR) * PPW;
      const int ci = r / Tl::ROWS, hy = r - ci * Tl::ROWS;
      const int iy = iy0 + hy, ix = ix0 + j;
      const bool in = ci < g.cin && iy >= 0 && iy < g.HI && ix >= 0 && ix < g.WI;
      cp_async4(xs + ci * Tl::S + hy * COLS + j,
                in ? xb + ci * g.in_c + (long long)iy * g.WI + ix : xb, in);
    }
    cp_async_commit();
    return;
  }
  for (int r0 = warp; r0 < nrows; r0 += Tl::WARPS * LOADS) {
    T v0[LOADS], v1[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int r = r0 + u * Tl::WARPS;
      const int ci = r / Tl::ROWS, hy = r - ci * Tl::ROWS;
      const int iy = iy0 + hy;
      const bool row_in = r < nrows && ci < g.cin && iy >= 0 && iy < g.HI;
      const T* src = xb + ci * g.in_c + (long long)iy * g.WI + ix0;
      const int ix = ix0 + lane;
      v0[u] = (row_in && ix >= 0 && ix < g.WI) ? src[lane] : zero;
      v1[u] = (row_in && lane < COLS - 32 && ix + 32 < g.WI) ? src[lane + 32] : zero;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int r = r0 + u * Tl::WARPS;
      if (r >= nrows) continue;
      const int ci = r / Tl::ROWS, hy = r - ci * Tl::ROWS;
      T* dst = xs + ci * Tl::S + hy * COLS;
      dst[lane] = v0[u];
      if (lane < COLS - 32) dst[lane + 32] = v1[u];
    }
  }
}

// The weights of the chunk at c0 into one weight buffer, as they are in
// memory (zero past the chunk's end and past Cin, Cout), and the chunk's SE
// scales. Where the rows can be read as aligned words they go by cp.async:
// the caller's cp_async_wait_all and barrier follow, and what it does in
// between hides their latency.
template <typename T, int K, int NT>
__device__ void stage_chunk(const Params& p, const Geo& g, const Plan& pl, int b, int c0,
                            const float* __restrict__ scale, unsigned char* buf) {
  using Tl = Tile<T, K>;
  constexpr int CC = Tl::CC, KK = K * K, WPS = wps_pitch(NT);
  constexpr int E = 4 / (int)sizeof(T);  // elements a word
  const T* wexp = static_cast<const T*>(p.wexp);
  const T* bexp = static_cast<const T*>(p.bexp);
  const T* wdw = static_cast<const T*>(p.wdw);
  const T* bdw = static_cast<const T*>(p.bdw);
  const T* wproj = static_cast<const T*>(p.wproj);
  T* wes = reinterpret_cast<T*>(buf + pl.wes);
  T* bes = reinterpret_cast<T*>(buf + pl.bes);
  T* wds = reinterpret_cast<T*>(buf + pl.wds);
  T* bds = reinterpret_cast<T*>(buf + pl.bds);
  float* scs = reinterpret_cast<float*>(buf + pl.scs);
  T* wps = reinterpret_cast<T*>(buf + pl.wps);
  const int nc = min(CC, g.ce - c0);
  const float* sc = scale + (long long)b * g.ce + c0;
  if (g.wwords) {
    if (g.has_expand) {
      for (int idx = threadIdx.x; idx < g.xrows * (CC / E); idx += Tl::THREADS) {
        const int ci = idx / (CC / E), r = (idx - ci * (CC / E)) * E;
        const bool in = ci < g.cin && r < nc;
        cp_async4(wes + ci * Tl::WES + r, in ? wexp + ci * g.ce + c0 + r : wexp, in);
      }
    }
    for (int e = threadIdx.x * E; e < CC * KK; e += Tl::THREADS * E)
      cp_async4(wds + e, e < nc * KK ? wdw + c0 * KK + e : wdw, e < nc * KK);
    if constexpr (NT > 0) {
      for (int idx = threadIdx.x; idx < CC * (NT * 8 / E); idx += Tl::THREADS) {
        const int r = idx / (NT * 8 / E), o = (idx - r * (NT * 8 / E)) * E;
        const bool in = r < nc && o < g.cout;
        cp_async4(wps + r * WPS + o, in ? wproj + (c0 + r) * g.cout + o : wproj, in);
      }
    }
    if (threadIdx.x < CC / E) {
      const int r = threadIdx.x * E;
      cp_async4(bes + r, bexp + (g.has_expand && r < nc ? c0 + r : 0), g.has_expand && r < nc);
      cp_async4(bds + r, bdw + (r < nc ? c0 + r : 0), r < nc);
    } else if (NT > 0 && threadIdx.x >= 32 && threadIdx.x < 32 + CC) {
      const int r = threadIdx.x - 32;
      cp_async4(scs + r, r < nc ? sc + r : scale, r < nc);
    }
    cp_async_commit();
    return;
  }
  const T zero = from_f<T>(0.f);
  if (g.has_expand) {
    for (int idx = threadIdx.x; idx < g.xrows * CC; idx += Tl::THREADS) {
      const int ci = idx / CC, r = idx - ci * CC;
      wes[ci * Tl::WES + r] = (ci < g.cin && r < nc) ? wexp[ci * g.ce + c0 + r] : zero;
    }
  }
  for (int idx = threadIdx.x; idx < CC * KK; idx += Tl::THREADS)
    wds[idx] = idx < nc * KK ? wdw[c0 * KK + idx] : zero;
  if constexpr (NT > 0) {
    for (int idx = threadIdx.x; idx < CC * NT * 8; idx += Tl::THREADS) {
      const int r = idx / (NT * 8), o = idx - r * (NT * 8);
      wps[r * WPS + o] = (r < nc && o < g.cout) ? wproj[(c0 + r) * g.cout + o] : zero;
    }
  }
  if (threadIdx.x < CC) {
    const int r = threadIdx.x;
    bes[r] = (g.has_expand && r < nc) ? bexp[c0 + r] : zero;
    bds[r] = r < nc ? bdw[c0 + r] : zero;
    if constexpr (NT > 0) scs[r] = r < nc ? sc[r] : 0.f;
  }
}

// es[r][hp] = the expanded activation of chunk channel r at halo pixel hp,
// rounded to T: swish(x . wexp + b) times the halo mask.
// bf16: D (channels x pixels) = wexp^T (channels x Cin) . x (Cin x pixels).
template <int K>
__device__ __forceinline__ void expand_chunk(const bf16* xs, const float* hm, const Geo& g,
                                             const bf16* wes, const bf16* bes, bf16* es) {
  using Tl = Tile<bf16, K>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int ksteps = g.xrows >> 4;  // at most 4: Cin <= 64
  uint32_t af[2][4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    if (ks < ksteps) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4_t(af[mt][ks], wes + (ks * 16 + (lane & 7) + 8 * (lane >> 4)) * Tl::WES +
                                  mt * 16 + 8 * ((lane >> 3) & 1));
    }
  float bias[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) bias[mt][h] = act_bias<bf16>(to_f(bes[mt * 16 + g8 + 8 * h]));
  // two pixel tiles a step, so that four independent sums are in flight
  constexpr int NTILES = Tl::PIXP / 8;
  for (int nt0 = warp; nt0 < NTILES; nt0 += 2 * Tl::WARPS) {
    const bool two = nt0 + Tl::WARPS < NTILES;  // the same for the whole warp
    float acc[2][2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (ks < ksteps) {
        const bf16* xk = xs + (ks * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * Tl::S + nt0 * 8;
        uint32_t b[2][2];
        ldsm_x2_t(b[0][0], b[0][1], xk);
        ldsm_x2_t(b[1][0], b[1][1], two ? xk + Tl::WARPS * 8 : xk);
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[q][mt], af[mt][ks], b[q][0], b[q][1]);
      }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 1 && !two) break;
      const int hp = (nt0 + q * Tl::WARPS) * 8 + 2 * t4;
      const float2 m = *reinterpret_cast<const float2*>(hm + hp);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = act<bf16>(acc[q][mt][2 * h], bias[mt][h]) * m.x;
          const float v1 = act<bf16>(acc[q][mt][2 * h + 1], bias[mt][h]) * m.y;
          *reinterpret_cast<__nv_bfloat162*>(es + (mt * 16 + g8 + 8 * h) * Tl::S + hp) =
              __floats2bfloat162_rn(v0, v1);
        }
    }
  }
}

// float32: FMAs, a halo pixel a thread
template <int K>
__device__ __forceinline__ void expand_chunk(const float* xs, const float* hm, const Geo& g,
                                             const float* wes, const float* bes, float* es) {
  using Tl = Tile<float, K>;
  constexpr int CC = Tl::CC;
  for (int hp = threadIdx.x; hp < Tl::PIXP; hp += Tl::THREADS) {
    float acc[CC];
#pragma unroll
    for (int r = 0; r < CC; ++r) acc[r] = 0.f;
    for (int ci = 0; ci < g.cin; ++ci) {
      const float xv = xs[ci * Tl::S + hp];
      const float4* w4 = reinterpret_cast<const float4*>(wes + ci * Tl::WES);
#pragma unroll
      for (int q = 0; q < CC / 4; ++q) {
        const float4 w = w4[q];
        acc[4 * q + 0] = fmaf(xv, w.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(xv, w.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(xv, w.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(xv, w.w, acc[4 * q + 3]);
      }
    }
    const float m = hm[hp];
#pragma unroll
    for (int r = 0; r < CC; ++r) es[r * Tl::S + hp] = act<float>(acc[r], bes[r]) * m;
  }
}

// 12 neighbouring activations of a halo row as float32
__device__ __forceinline__ void load_window(const bf16* p, float (&w)[12]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + 4 * q);
    w[4 * q + 0] = __uint_as_float(u.x << 16);
    w[4 * q + 1] = __uint_as_float(u.x & 0xffff0000u);
    w[4 * q + 2] = __uint_as_float(u.y << 16);
    w[4 * q + 3] = __uint_as_float(u.y & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_window(const float* p, float (&w)[12]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float4 u = *reinterpret_cast<const float4*>(p + 4 * q);
    w[4 * q + 0] = u.x; w[4 * q + 1] = u.y; w[4 * q + 2] = u.z; w[4 * q + 3] = u.w;
  }
}

// swish(taps + bias) of one channel over this thread's strip: output rows
// row0 .. row0 + R - 1, columns col0 .. col0 + 7 of the tile. Each input row
// of the strip is loaded once and feeds up to K output rows.
template <typename T, int K>
__device__ __forceinline__ void depthwise(const T* e, const T* wd, float bias, int row0,
                                          int col0, float (&o)[Tile<T, K>::R][8]) {
  constexpr int R = Tile<T, K>::R;
  // k3 keeps its 9 weights in registers; k5 reads its 25 where they are used
  float w[K == 3 ? 9 : 1];
  if (K == 3) {
#pragma unroll
    for (int t = 0; t < 9; ++t) w[t] = to_f(wd[t]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[r][j] = 0.f;
#pragma unroll
  for (int ir = 0; ir < R + K - 1; ++ir) {
    float win[12];
    load_window(e + (row0 + ir) * COLS + col0, win);  // halo columns col0 .. col0 + 11
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int dy = ir - r;
      if (dy < 0 || dy >= K) continue;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float wt = K == 3 ? w[K == 3 ? dy * K + dx : 0] : to_f(wd[dy * K + dx]);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[r][j] = fmaf(win[j + dx + HC - K / 2], wt, o[r][j]);
      }
    }
  }
  const float ab = act_bias<T>(bias);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) o[r][j] = act<T>(o[r][j], ab);
}

// acc += sd (tile pixels x chunk channels) . wps (chunk channels x 8 NT)
// bf16: warp w owns tile row w: two m16 tiles of pixels; acc[(mt * NT + nt) * 4 + e]
template <int K, int NT>
__device__ __forceinline__ void project_chunk(const bf16* sd, const bf16* wps,
                                              float (&acc)[NT * 8]) {
  using Tl = Tile<bf16, K>;
  constexpr int WPS = wps_pitch(NT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t a[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4_t(a[mt][ks], sd + (ks * 16 + (lane & 7) + 8 * (lane >> 4)) * Tl::SDS + warp * 32 +
                               mt * 16 + 8 * ((lane >> 3) & 1));
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t b[4];  // k 0-7, 8-15, 16-23, 24-31 of this column tile
    ldsm_x4_t(b, wps + ((lane & 7) + 8 * (lane >> 3)) * WPS + nt * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      mma_bf16(&acc[(mt * NT + nt) * 4], a[mt][0], b[0], b[1]);
      mma_bf16(&acc[(mt * NT + nt) * 4], a[mt][1], b[2], b[3]);
    }
  }
}

// float32: a pixel a thread, acc[o]
template <int K, int NT>
__device__ __forceinline__ void project_chunk(const float* sd, const float* wps,
                                              float (&acc)[NT * 8]) {
  using Tl = Tile<float, K>;
  constexpr int WPS = wps_pitch(NT);
#pragma unroll
  for (int r = 0; r < Tl::CC; ++r) {
    const float v = sd[r * Tl::SDS + threadIdx.x];
    const float4* w4 = reinterpret_cast<const float4*>(wps + r * WPS);
#pragma unroll
    for (int q = 0; q < NT * 2; ++q) {
      const float4 w = w4[q];
      acc[4 * q + 0] = fmaf(v, w.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v, w.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v, w.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v, w.w, acc[4 * q + 3]);
    }
  }
}

// One pass over a tile: NT == 0 the SE pool (channel sums to `partial`),
// NT > 0 the project (the output tile to `out`). EXP == false is the
// instance for blocks without an expand (launch_pass says which have one).
// The k3 pool pass and the k3 passes without an expand up to three column
// tiles are held to two blocks an SM (64 registers at 512 threads).
template <typename T, int K, int NT, bool EXP>
__global__ void
__launch_bounds__(Tile<T, K>::THREADS, (K == 3 && (NT == 0 || (!EXP && NT <= 3))) ? 2 : 1)
mbconv_pass_kernel(const T* __restrict__ x, const T* __restrict__ mask, Params p, Geo g,
                   float* __restrict__ partial, const float* __restrict__ scale,
                   T* __restrict__ out) {
  using Tl = Tile<T, K>;
  constexpr int CC = Tl::CC, R = Tl::R, P = Tl::P, KK = K * K;
  constexpr bool PROJ = NT > 0;
  constexpr bool MMA = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan pl = smem_plan<T, K>(g.xrows, g.cout, g.has_expand, NT);
  T* xs = reinterpret_cast<T*>(smem + pl.xs);
  T* es = reinterpret_cast<T*>(smem + pl.es);
  T* sd = reinterpret_cast<T*>(smem + pl.sd);
  T* ys = reinterpret_cast<T*>(smem + pl.es);  // after the chunks: cout x SDS
  float* hm = reinterpret_cast<float*>(smem + pl.hm);
  unsigned char* wbuf[2] = {smem + pl.wb, smem + pl.wb + pl.wbuf};

  const int tile = blockIdx.x, b = blockIdx.y;
  const int y0 = (tile / g.tiles_x) * Tl::TH, x0 = (tile % g.tiles_x) * TW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this thread's strip of the taps: channel dc of the chunk, rows row0.., columns col0..
  const int col0 = (threadIdx.x & (STRIPS - 1)) * 8;
  const int row0 = ((threadIdx.x >> 2) & (RGROUPS - 1)) * R;
  const int dc = threadIdx.x >> 4;

  float acc[PROJ ? NT * 8 : 1];
#pragma unroll
  for (int i = 0; i < (PROJ ? NT * 8 : 1); ++i) acc[i] = 0.f;

  load_tile<T, K>(x, mask, g, b, y0, x0, xs, hm);
  stage_chunk<T, K, NT>(p, g, pl, b, 0, scale, wbuf[0]);
  cp_async_wait_all();
  __syncthreads();

  int it = 0;
  for (int c0 = 0; c0 < g.ce; c0 += CC, ++it) {
    const unsigned char* wb = wbuf[it & 1];
    // phase 1: the project of the chunk before, the expand of this one
    if constexpr (PROJ)
      if (it > 0) project_chunk<K, NT>(sd, reinterpret_cast<const T*>(wbuf[(it - 1) & 1] + pl.wps), acc);
    if (EXP && g.has_expand)
      expand_chunk<K>(xs, hm, g, reinterpret_cast<const T*>(wb + pl.wes),
                      reinterpret_cast<const T*>(wb + pl.bes), es);
    __syncthreads();
    // phase 2: the weights of the next chunk set off, the taps of this one
    if (c0 + CC < g.ce) stage_chunk<T, K, NT>(p, g, pl, b, c0 + CC, scale, wbuf[(it + 1) & 1]);
    const int ch = min(c0 + dc, g.ce - 1);
    const T* e = EXP && g.has_expand ? es + dc * Tl::S : xs + ch * Tl::S;
    float o[R][8];
    depthwise<T, K>(e, reinterpret_cast<const T*>(wb + pl.wds) + dc * KK,
                    to_f(reinterpret_cast<const T*>(wb + pl.bds)[dc]), row0, col0, o);
    if constexpr (PROJ) {
      const float sc = reinterpret_cast<const float*>(wb + pl.scs)[dc];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T* dst = sd + dc * Tl::SDS + (row0 + r) * TW + col0;
        if (MMA) {
          uint32_t w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(o[r][2 * j] * sc, o[r][2 * j + 1] * sc);
            w[j] = *reinterpret_cast<const uint32_t*>(&v);
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) dst[j] = from_f<T>(o[r][j] * sc);
        }
      }
    } else {
      // the tile's sum of this channel: the 16 threads that share it are
      // 16 neighbouring lanes; a fixed order, so a run repeats bit for bit
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum = fmaf(o[r][j], hm[(row0 + r + P) * COLS + col0 + j + HC], sum);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if ((lane & 15) == 0 && c0 + dc < g.ce)
        partial[((long long)b * g.tiles + tile) * g.ce + c0 + dc] = sum;
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if constexpr (PROJ) {
    project_chunk<K, NT>(sd, reinterpret_cast<const T*>(wbuf[(it - 1) & 1] + pl.wps), acc);
    __syncthreads();

    // bias, the mask (1 at every pixel that is written, but in rp's gaps) and
    // the skip (x is in the halo tile), rounded into the output tile
    const T* bproj = static_cast<const T*>(p.bproj);
    auto put = [&](int o, int py, int px, float v) {
      if (o >= g.cout) return;
      const int hp = (py + P) * COLS + px + HC;
      v = (v + to_f(bproj[o])) * hm[hp];
      if (g.has_skip) v += to_f(xs[o * Tl::S + hp]);
      ys[o * Tl::SDS + py * TW + px] = from_f<T>(v);
    };
    if (MMA) {
      const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            put(nt * 8 + 2 * t4 + (e & 1), warp, mt * 16 + g8 + 8 * (e >> 1),
                acc[(mt * NT + nt) * 4 + e]);
    } else {
#pragma unroll
      for (int o = 0; o < NT * 8; ++o) put(o, threadIdx.x / TW, threadIdx.x % TW, acc[o]);
    }
    __syncthreads();

    // the tile leaves in the layout's own order, a warp a row
    T* ob = out + (long long)b * g.out_b;
    if (g.nhwc && g.vec_out) {
      // a lane a pixel of the warp's row: 16-byte pieces of its channels
      constexpr int V = 16 / (int)sizeof(T);
      const int gy = y0 + warp, gx = x0 + lane;  // WARPS == TH, TW == 32
      if (gy < g.H && gx < g.W)
        for (int c = 0; c < g.cout; c += V) {
          uint4 v;
          T* vals = reinterpret_cast<T*>(&v);
#pragma unroll
          for (int j = 0; j < V; ++j) vals[j] = ys[(c + j) * Tl::SDS + warp * TW + lane];
          *reinterpret_cast<uint4*>(ob + ((long long)gy * g.W + gx) * g.out_p + c) = v;
        }
      return;
    }
    if (g.nhwc) {
      const int gy = y0 + warp;  // WARPS == TH
      if (gy < g.H)
        for (int e = lane; e < TW * g.cout; e += 32) {
          const int px = e / g.cout, o = e - px * g.cout;
          if (x0 + px < g.W)
            ob[((long long)gy * g.W + x0 + px) * g.out_p + o] = ys[o * Tl::SDS + warp * TW + px];
        }
      return;
    }
    for (int r = warp; r < g.cout * Tl::TH; r += Tl::WARPS) {
      const int o = r / Tl::TH, py = r - o * Tl::TH;
      const int gy = y0 + py, gx = x0 + lane;
      if (gy < g.H && gx < g.W)
        ob[o * g.out_c + (long long)(gy + g.oy) * g.WI + gx + g.ox] = ys[o * Tl::SDS + py * TW + lane];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
mbconv_se_kernel(const float* __restrict__ partial, Params p, Geo g, float* __restrict__ scale) {
  extern __shared__ float se_smem[];  // pool[ce], r[cr]
  float* pool = se_smem;
  float* rr = se_smem + g.ce;
  const T* wser = static_cast<const T*>(p.wser);
  const T* bser = static_cast<const T*>(p.bser);
  const T* wsee = static_cast<const T*>(p.wsee);
  const T* bsee = static_cast<const T*>(p.bsee);
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < g.ce; c += blockDim.x) {
    float sum = 0.f;
    for (int t = 0; t < g.tiles; ++t) sum += partial[((long long)b * g.tiles + t) * g.ce + c];
    pool[c] = sum * g.inv_n;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < g.cr; j += blockDim.x) {
    float a = 0.f;
    for (int c = 0; c < g.ce; ++c) a = fmaf(to_f(wser[c * g.cr + j]), pool[c], a);
    rr[j] = swishf(a + to_f(bser[j]));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < g.ce; c += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < g.cr; ++j) a = fmaf(to_f(wsee[j * g.ce + c]), rr[j], a);
    scale[(long long)b * g.ce + c] = sigmoidf(a + to_f(bsee[c]));
  }
}

// The row-padded output's gap lanes, each once: oy rows above the grid, the
// ox + (WI - ox - W) lanes beside each of its rows, the rows below. Exact
// zeros; x's own gap values under a skip.
template <typename T>
__global__ void __launch_bounds__(256)
mbconv_rp_ring_kernel(const T* __restrict__ x, Geo g, T* __restrict__ out) {
  const int top = g.oy * g.WI, side = g.WI - g.W, mid = g.H * side;
  const int n_ring = g.HI * g.WI - g.H * g.W;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_ring) return;
  int lane;
  if (idx < top) {
    lane = idx;
  } else if (idx < top + mid) {
    idx -= top;
    const int row = idx / side, j = idx - row * side;
    lane = (g.oy + row) * g.WI + (j < g.ox ? j : g.W + j);
  } else {
    lane = (g.oy + g.H) * g.WI + idx - top - mid;
  }
  const int o = blockIdx.y, b = blockIdx.z;
  T v = from_f<T>(0.f);
  if (g.has_skip) v = x[(long long)b * g.in_b + o * g.in_c + lane];
  out[(long long)b * g.out_b + o * g.out_c + lane] = v;
}

// Column tiles of 8 of the project. bf16: exactly ceil(Cout / 8). float32
// (not the target) rounds them up to 1, 2, 4 or 8: fewer kernels to build.
int column_tiles(int cout, int bf16_) {
  const int nt = (cout + 7) / 8;
  return (bf16_ || nt <= 2) ? nt : nt <= 4 ? 4 : 8;
}

template <typename T, int K, int NT>
cudaError_t launch_pass(const T* x, const T* mask, const Params& p, const Geo& g, float* partial,
                        const float* scale, T* out, int B, cudaStream_t stream) {
  const Plan pl = smem_plan<T, K>(g.xrows, g.cout, g.has_expand, NT);
  if (pl.total > SMEM_MAX) return cudaErrorInvalidValue;
  // bf16, k3, a block without an expand, up to three column tiles: its own
  // instance, which without the expand's registers fits 64 with little spilled
  auto kernel = mbconv_pass_kernel<T, K, NT, true>;
  if constexpr (sizeof(T) == 2 && K == 3 && NT <= 3)
    if (!g.has_expand) kernel = mbconv_pass_kernel<T, K, NT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.total);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.tiles, B), Tile<T, K>::THREADS, pl.total, stream>>>(x, mask, p, g, partial,
                                                                      scale, out);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_k(const T* x, const T* mask, const Params& p, const Geo& g, float* partial,
                     float* scale, T* out, int B, cudaStream_t stream) {
  cudaError_t err = launch_pass<T, K, 0>(x, mask, p, g, partial, scale, out, B, stream);
  if (err != cudaSuccess) return err;
  mbconv_se_kernel<T><<<B, 256, (g.ce + g.cr) * 4, stream>>>(partial, p, g, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
#define MBCONV_NT_CASE(N) \
  case N:                 \
    return launch_pass<T, K, N>(x, mask, p, g, partial, scale, out, B, stream);
  if constexpr (sizeof(T) == 4) {
    switch (column_tiles(g.cout, 0)) {
      MBCONV_NT_CASE(1) MBCONV_NT_CASE(2) MBCONV_NT_CASE(4) MBCONV_NT_CASE(8)
    }
  } else {
    switch (column_tiles(g.cout, 1)) {
      MBCONV_NT_CASE(1) MBCONV_NT_CASE(2) MBCONV_NT_CASE(3) MBCONV_NT_CASE(4)
      MBCONV_NT_CASE(5) MBCONV_NT_CASE(6) MBCONV_NT_CASE(7) MBCONV_NT_CASE(8)
    }
  }
  return cudaErrorInvalidValue;
#undef MBCONV_NT_CASE
}

int tile_rows(int bf16_) { return bf16_ ? Cfg<bf16>::TH : Cfg<float>::TH; }

int tiles_of(int H, int W, int bf16_) {
  const int th = tile_rows(bf16_);
  return ((W + TW - 1) / TW) * ((H + th - 1) / th);
}

// channel rows of the x tile: Cin padded to the products' K step in bf16
int xrows_of(int cin, int ce, int has_expand, int bf16_) {
  if (!has_expand) return ce;
  return bf16_ ? (cin + 15) / 16 * 16 : cin;
}

enum Layout { PACKED = 0, ROW_PADDED = 1, NHWC = 2 };

int launch(Layout layout, const void* x, const void* mask, const void* const* w, void* out,
           void* partial, void* scale, int B, int H, int W, int pad, int cin, int ce, int cout,
           int cr, int k, int has_expand, int has_skip, int bf16_, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || ce <= 0 || cr <= 0) return (int)cudaErrorInvalidValue;
  if (cout <= 0 || cout > 64 || B > 65535 || (k != 3 && k != 5)) return (int)cudaErrorInvalidValue;
  if (!has_expand && ce != cin) return (int)cudaErrorInvalidValue;
  if (bf16_ && has_expand && cin > 64) return (int)cudaErrorInvalidValue;  // four K steps
  Geo g;
  g.H = H; g.W = W; g.HI = H + 2 * pad; g.WI = W + 2 * pad; g.oy = pad; g.ox = pad;
  g.cin = cin; g.ce = ce; g.cout = cout; g.cr = cr;
  g.xrows = xrows_of(cin, ce, has_expand, bf16_);
  const long long hw = (long long)g.HI * g.WI;
  g.nhwc = layout == NHWC;
  g.in_b = hw * cin; g.out_b = hw * cout;
  g.in_c = g.nhwc ? 1 : hw; g.out_c = g.nhwc ? 1 : hw;
  g.in_p = g.nhwc ? cin : 1; g.out_p = g.nhwc ? cout : 1;
  g.tiles_x = (W + TW - 1) / TW;
  g.tiles = tiles_of(H, W, bf16_);
  g.has_expand = has_expand; g.has_skip = has_skip;
  g.words = !g.nhwc && (!bf16_ || (g.WI % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0));
  const int piece = bf16_ ? 8 : 4;  // channels in 16 bytes
  g.vec_in = g.nhwc && cin % piece == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_out = g.nhwc && cout % piece == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  g.wwords = !bf16_ || (ce % 2 == 0 && cout % 2 == 0);
  for (int i = 0; i < 10; ++i) g.wwords = g.wwords && reinterpret_cast<uintptr_t>(w[i]) % 4 == 0;
  g.inv_n = 1.f / ((float)H * (float)W);
  const Params p = {w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(partial);
  float* sc = static_cast<float*>(scale);
  cudaError_t err;
  const int n_ring = g.HI * g.WI - H * W;
  if (bf16_) {
    using T = bf16;
    const T* xt = static_cast<const T*>(x);
    const T* mt = static_cast<const T*>(mask);
    T* ot = static_cast<T*>(out);
    err = k == 3 ? launch_k<T, 3>(xt, mt, p, g, pa, sc, ot, B, s)
                 : launch_k<T, 5>(xt, mt, p, g, pa, sc, ot, B, s);
    if (err == cudaSuccess && n_ring > 0) {
      mbconv_rp_ring_kernel<T><<<dim3((n_ring + 255) / 256, cout, B), 256, 0, s>>>(xt, g, ot);
      err = cudaGetLastError();
    }
  } else {
    const float* xt = static_cast<const float*>(x);
    const float* mt = static_cast<const float*>(mask);
    float* ot = static_cast<float*>(out);
    err = k == 3 ? launch_k<float, 3>(xt, mt, p, g, pa, sc, ot, B, s)
                 : launch_k<float, 5>(xt, mt, p, g, pa, sc, ot, B, s);
    if (err == cudaSuccess && n_ring > 0) {
      mbconv_rp_ring_kernel<float><<<dim3((n_ring + 255) / 256, cout, B), 256, 0, s>>>(xt, g, ot);
      err = cudaGetLastError();
    }
  }
  return (int)err;
}

}  // namespace

// The number of spatial tiles of an H x W grid of real pixels: the scratch
// `partial` holds B * tiles * Ce float32 sums, `scale` B * Ce.
extern "C" int fused_mbconv_tiles(int H, int W, int bf16) { return tiles_of(H, W, bf16); }

// Dynamic shared memory of the pool pass (project == 0) or the project pass
// of one block, in bytes; the launch is refused above 232,448.
extern "C" int fused_mbconv_smem_bytes(int cin, int ce, int cout, int k, int has_expand,
                                       int bf16, int project) {
  const int xrows = xrows_of(cin, ce, has_expand, bf16);
  const int nt = project ? column_tiles(cout, bf16) : 0;
  if (bf16)
    return k == 3 ? smem_plan<__nv_bfloat16, 3>(xrows, cout, has_expand, nt).total
                  : smem_plan<__nv_bfloat16, 5>(xrows, cout, has_expand, nt).total;
  return k == 3 ? smem_plan<float, 3>(xrows, cout, has_expand, nt).total
                : smem_plan<float, 5>(xrows, cout, has_expand, nt).total;
}

// x (B, Cin, H*W) -> out (B, Cout, H*W).
// w: wexp, bexp, wdw, bdw, wser, bser, wsee, bsee, wproj, bproj (input dtype).
extern "C" int fused_mbconv_packed_launch(const void* x, const void* const* w, void* out,
                                          void* partial, void* scale, int B, int H, int W,
                                          int cin, int ce, int cout, int cr, int k,
                                          int has_expand, int has_skip, int bf16, void* stream) {
  return launch(PACKED, x, nullptr, w, out, partial, scale, B, H, W, 0, cin, ce, cout, cr, k,
                has_expand, has_skip, bf16, stream);
}

// x (B, Cin, Hp*Wp), Hp = H + 2 pad, Wp = W + 2 pad, with the 0/1 mask
// (Hp*Wp) of its H*W real lanes -> out (B, Cout, Hp*Wp); out's gap lanes are
// 0 (x's own values, with a skip).
extern "C" int fused_mbconv_rp_launch(const void* x, const void* mask, const void* const* w,
                                      void* out, void* partial, void* scale, int B, int H,
                                      int W, int pad, int cin, int ce, int cout, int cr,
                                      int k, int has_expand, int has_skip, int bf16,
                                      void* stream) {
  if (pad < k / 2 || mask == nullptr) return (int)cudaErrorInvalidValue;
  return launch(ROW_PADDED, x, mask, w, out, partial, scale, B, H, W, pad, cin, ce, cout, cr, k,
                has_expand, has_skip, bf16, stream);
}

// x (B, H, W, Cin) -> out (B, H, W, Cout).
extern "C" int fused_mbconv_nhwc_launch(const void* x, const void* const* w, void* out,
                                        void* partial, void* scale, int B, int H, int W,
                                        int cin, int ce, int cout, int cr, int k,
                                        int has_expand, int has_skip, int bf16, void* stream) {
  return launch(NHWC, x, nullptr, w, out, partial, scale, B, H, W, 0, cin, ce, cout, cr, k,
                has_expand, has_skip, bf16, stream);
}

extern "C" const char* fused_mbconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
