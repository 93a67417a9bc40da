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
// Here a layout is only a set of strides (image, channel, pixel), so one
// kernel serves all three. The row-padded layout is walked as an Hp x Wp
// image whose padding is data: its expanded activation and its output are
// multiplied by the mask, and its SE mean takes the real lanes only.
//
// Why not the TPU design: the TPU kernels keep a whole image (0.8-4.3 MB)
// in VMEM for one grid step and take the SE's global mean there. A Hopper
// block has at most 227 KB of shared memory, and blocks run in no order, so
// the mean is a reduction across blocks. Like the NHWC Pallas kernel, this
// one recomputes instead of storing the depthwise output (144 x 128^2 x 128
// x 2 B = 604 MB at D0's stage-2 block), in three launches:
//
//   1. mbconv_pool_kernel, a block per (spatial tile, image): stage the x
//      halo tile in shared memory; then per chunk of CC expanded channels,
//      expand + swish the halo (rounded to the input dtype; zero outside the
//      image, which is the zero padding of the expanded activation), take
//      the k x k taps in float32, add the bias, swish, and sum over the tile.
//      Each tile's channel sums go to a float32 scratch (B, tiles, Ce); no
//      atomics, so a run repeats bit for bit.
//   2. mbconv_se_kernel, a block per image: the mean over its tiles' sums,
//      then the SE's two small products and the sigmoid, in float32.
//   3. mbconv_proj_kernel, a block per (spatial tile, image): the same
//      recompute per chunk, times the SE scale, rounded to the input dtype,
//      and each thread accumulates its pixel's project in float32 registers
//      over the chunks. Bias, the rp mask and the skip are applied as the
//      tile leaves through shared memory in the layout's own order.
//
// Rounding points follow the Pallas kernels: the expanded activation is
// rounded to the input dtype after its swish; taps, SE and the scale run in
// float32; the scaled activation is rounded to the input dtype before the
// project.
//
// What bounds it on an H100: operations. The fused block must read x and
// write y (d0s1 at batch 128: 805 MB, 0.24 ms at 3.35 TB/s) but does k*k
// taps per expanded channel and pixel on the CUDA cores, and the two 1x1
// products. This first version runs the products as float32 FMAs on the
// CUDA cores too, and the recompute doubles expand and taps, plus the halo
// (1.33x at k3, 1.69x at k5 on an 8 x 32 tile). Moving the products onto
// the tensor cores (mma.sync / wgmma) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 32, TILE = TH * TW;  // output pixels of a block
constexpr int THREADS = TILE;                    // one output pixel a thread
constexpr int WARPS = THREADS / 32;
constexpr int CC = 16;                           // expanded channels a chunk

enum Layout { PACKED = 0, ROW_PADDED = 1, NHWC = 2 };

struct Geo {
  int H, W;                      // the grid walked (rp: the padded sides)
  int cin, ce, cout, cr;
  long long in_b, in_c, in_p;    // x strides: image, channel, pixel
  long long out_b, out_c, out_p; // y strides
  int tiles_x, tiles;
  int has_expand, has_skip, nhwc;
  float inv_n;                   // 1 / the number of real pixels
};

struct Params {  // the packed tuple, input dtype
  const void *wexp, *bexp, *wdw, *bdw, *wser, *bser, *wsee, *bsee, *wproj, *bproj;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round to T and back
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// The activations' swish, once per expanded channel and (halo) pixel in each
// pass, takes the fast exponential and division (a few ulps); the SE's
// sigmoid and swish, once per channel and image, take the accurate ones.
__device__ __forceinline__ float fast_swishf(float v) { return __fdividef(v, 1.f + __expf(-v)); }
__device__ __forceinline__ float swishf(float v) { return v / (1.f + expf(-v)); }
__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

template <int K> struct Halo {
  static constexpr int P = K / 2, ROWS = TH + 2 * P, COLS = TW + 2 * P, PIX = ROWS * COLS;
};

// Shared memory of a pass block, in bytes from the start:
//   [xs: T cin x PIX][es: f32 CC x PIX]  (the output tile aliases these)
//   wes f32 cin x CC | bes CC | wds CC x K*K | bds CC | scs CC | red WARPS x CC | wps CC x COUT
struct Smem {
  int xs, es, wes, bes, wds, bds, scs, red, wps, total;
};

template <typename T, int K, int COUT>
__host__ __device__ Smem smem_plan(int cin, int cout) {
  Smem s;
  const int pix = Halo<K>::PIX;
  s.xs = 0;
  s.es = align16(cin * pix * (int)sizeof(T));
  int region = s.es + CC * pix * 4;
  const int ytile = cout * (TILE + 1) * 4;
  if (COUT > 0 && ytile > region) region = ytile;
  s.wes = align16(region);
  s.bes = s.wes + align16(cin * CC * 4);
  s.wds = s.bes + CC * 4;
  s.bds = s.wds + align16(CC * K * K * 4);
  s.scs = s.bds + CC * 4;
  s.red = s.scs + CC * 4;
  s.wps = s.red + align16(WARPS * CC * 4);
  s.total = s.wps + CC * (COUT > 0 ? COUT : 0) * 4;
  return s;
}

// The x halo tile, zero outside the grid. NHWC reads channel-fastest,
// the channel-major layouts pixel-fastest, so neighbouring threads read
// neighbouring addresses. Each thread issues LOADS loads before it stores
// any, so that their latencies overlap.
constexpr int LOADS = 8;

template <typename T, int K>
__device__ void load_x_tile(const T* __restrict__ x, const Geo& g, int b, int y0, int x0, T* xs) {
  using Hl = Halo<K>;
  const int n = g.cin * Hl::PIX;
  const T* xb = x + (long long)b * g.in_b;
  for (int base = threadIdx.x; base < n; base += THREADS * LOADS) {
    T v[LOADS];
    int dst[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int idx = base + u * THREADS;
      v[u] = from_f<T>(0.f);
      dst[u] = -1;
      if (idx >= n) continue;
      int ci, hp;
      if (g.nhwc) { hp = idx / g.cin; ci = idx - hp * g.cin; }
      else { ci = idx / Hl::PIX; hp = idx - ci * Hl::PIX; }
      const int hy = hp / Hl::COLS, hx = hp - hy * Hl::COLS;
      const int gy = y0 - Hl::P + hy, gx = x0 - Hl::P + hx;
      if (gy >= 0 && gy < g.H && gx >= 0 && gx < g.W)
        v[u] = xb[ci * g.in_c + ((long long)gy * g.W + gx) * g.in_p];
      dst[u] = ci * Hl::PIX + hp;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (dst[u] >= 0) xs[dst[u]] = v[u];
  }
}

// Chunk weights into shared memory as float32 (zero past the chunk's end).
template <typename T, int K>
__device__ void stage_chunk(const Params& p, const Geo& g, int c0, int nc,
                            float* wes, float* bes, float* wds, float* bds) {
  const T* wexp = static_cast<const T*>(p.wexp);
  const T* bexp = static_cast<const T*>(p.bexp);
  const T* wdw = static_cast<const T*>(p.wdw);
  const T* bdw = static_cast<const T*>(p.bdw);
  if (g.has_expand) {
    for (int idx = threadIdx.x; idx < g.cin * CC; idx += THREADS) {
      const int ci = idx / CC, r = idx - ci * CC;
      wes[idx] = r < nc ? to_f(wexp[ci * g.ce + c0 + r]) : 0.f;
    }
  }
  for (int idx = threadIdx.x; idx < CC * K * K; idx += THREADS) {
    const int r = idx / (K * K), t = idx - r * (K * K);
    wds[idx] = r < nc ? to_f(wdw[(c0 + r) * K * K + t]) : 0.f;
  }
  if (threadIdx.x < CC) {
    const int r = threadIdx.x;
    bes[r] = (g.has_expand && r < nc) ? to_f(bexp[c0 + r]) : 0.f;
    bds[r] = r < nc ? to_f(bdw[c0 + r]) : 0.f;
  }
}

// es[r][hp] = the expanded activation of chunk channel r at halo pixel hp,
// rounded to T, times the mask, zero outside the grid.
template <typename T, int K>
__device__ void expand_chunk(const T* xs, const T* __restrict__ mask, const Geo& g, int y0, int x0,
                             int c0, int nc, const float* wes, const float* bes, float* es) {
  using Hl = Halo<K>;
  for (int hp = threadIdx.x; hp < Hl::PIX; hp += THREADS) {
    const int hy = hp / Hl::COLS, hx = hp - hy * Hl::COLS;
    const int gy = y0 - Hl::P + hy, gx = x0 - Hl::P + hx;
    const bool in = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
    if (g.has_expand) {
      float acc[CC];
#pragma unroll
      for (int r = 0; r < CC; ++r) acc[r] = 0.f;
      for (int ci = 0; ci < g.cin; ++ci) {
        const float xv = to_f(xs[ci * Hl::PIX + hp]);
        const float4* w4 = reinterpret_cast<const float4*>(wes + ci * CC);
#pragma unroll
        for (int q = 0; q < CC / 4; ++q) {
          const float4 w = w4[q];
          acc[4 * q + 0] = fmaf(xv, w.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, w.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, w.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, w.w, acc[4 * q + 3]);
        }
      }
      float m = 0.f;
      if (in) m = mask ? to_f(mask[(long long)gy * g.W + gx]) : 1.f;
#pragma unroll
      for (int r = 0; r < CC; ++r)
        es[r * Hl::PIX + hp] = (r < nc && in) ? rnd<T>(fast_swishf(acc[r] + bes[r]) * m) : 0.f;
    } else {  // Ce == Cin: the activation is x itself (zero outside the grid)
#pragma unroll
      for (int r = 0; r < CC; ++r)
        es[r * Hl::PIX + hp] = r < nc ? to_f(xs[(c0 + r) * Hl::PIX + hp]) : 0.f;
    }
  }
}

// swish(taps + bias) of the chunk's channels at this thread's pixel
template <int K>
__device__ __forceinline__ void depthwise(const float* es, const float* wds, const float* bds,
                                          int py, int px, float (&dwo)[CC]) {
  using Hl = Halo<K>;
#pragma unroll
  for (int r = 0; r < CC; ++r) {
    const float* e = es + r * Hl::PIX + py * Hl::COLS + px;
    const float* w = wds + r * K * K;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx) acc = fmaf(e[dy * Hl::COLS + dx], w[dy * K + dx], acc);
    dwo[r] = fast_swishf(acc + bds[r]);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(THREADS, 4)
mbconv_pool_kernel(const T* __restrict__ x, const T* __restrict__ mask, Params p, Geo g,
                   float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = smem_plan<T, K, 0>(g.cin, 0);
  T* xs = reinterpret_cast<T*>(smem + s.xs);
  float* es = reinterpret_cast<float*>(smem + s.es);
  float* wes = reinterpret_cast<float*>(smem + s.wes);
  float* bes = reinterpret_cast<float*>(smem + s.bes);
  float* wds = reinterpret_cast<float*>(smem + s.wds);
  float* bds = reinterpret_cast<float*>(smem + s.bds);
  float* red = reinterpret_cast<float*>(smem + s.red);

  const int tile = blockIdx.x, b = blockIdx.y;
  const int y0 = (tile / g.tiles_x) * TH, x0 = (tile % g.tiles_x) * TW;
  const int py = threadIdx.x / TW, px = threadIdx.x % TW;
  const int gy = y0 + py, gx = x0 + px;
  float m = 0.f;  // weight of this pixel in the mean
  if (gy < g.H && gx < g.W) m = mask ? to_f(mask[(long long)gy * g.W + gx]) : 1.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_x_tile<T, K>(x, g, b, y0, x0, xs);
  for (int c0 = 0; c0 < g.ce; c0 += CC) {
    const int nc = min(CC, g.ce - c0);
    stage_chunk<T, K>(p, g, c0, nc, wes, bes, wds, bds);
    __syncthreads();
    expand_chunk<T, K>(xs, mask, g, y0, x0, c0, nc, wes, bes, es);
    __syncthreads();
    float dwo[CC];
    depthwise<K>(es, wds, bds, py, px, dwo);
#pragma unroll
    for (int r = 0; r < CC; ++r) {
      float v = dwo[r] * m;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp * CC + r] = v;
    }
    __syncthreads();
    if (threadIdx.x < nc) {
      float sum = 0.f;
      for (int w = 0; w < WARPS; ++w) sum += red[w * CC + threadIdx.x];
      partial[((long long)b * g.tiles + tile) * g.ce + c0 + threadIdx.x] = sum;
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

template <typename T, int K, int COUT>
__global__ void __launch_bounds__(THREADS, COUT > 32 ? 2 : 3)
mbconv_proj_kernel(const T* __restrict__ x, const T* __restrict__ mask, Params p, Geo g,
                   const float* __restrict__ scale, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = smem_plan<T, K, COUT>(g.cin, g.cout);
  T* xs = reinterpret_cast<T*>(smem + s.xs);
  float* es = reinterpret_cast<float*>(smem + s.es);
  float* wes = reinterpret_cast<float*>(smem + s.wes);
  float* bes = reinterpret_cast<float*>(smem + s.bes);
  float* wds = reinterpret_cast<float*>(smem + s.wds);
  float* bds = reinterpret_cast<float*>(smem + s.bds);
  float* scs = reinterpret_cast<float*>(smem + s.scs);
  float* wps = reinterpret_cast<float*>(smem + s.wps);
  float* ys = reinterpret_cast<float*>(smem);  // after the chunks: cout x (TILE + 1)
  const T* wproj = static_cast<const T*>(p.wproj);
  const T* bproj = static_cast<const T*>(p.bproj);

  const int tile = blockIdx.x, b = blockIdx.y;
  const int y0 = (tile / g.tiles_x) * TH, x0 = (tile % g.tiles_x) * TW;
  const int py = threadIdx.x / TW, px = threadIdx.x % TW;

  float y[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) y[o] = 0.f;

  load_x_tile<T, K>(x, g, b, y0, x0, xs);
  for (int c0 = 0; c0 < g.ce; c0 += CC) {
    const int nc = min(CC, g.ce - c0);
    stage_chunk<T, K>(p, g, c0, nc, wes, bes, wds, bds);
    for (int idx = threadIdx.x; idx < CC * COUT; idx += THREADS) {
      const int r = idx / COUT, o = idx - r * COUT;
      wps[idx] = (r < nc && o < g.cout) ? to_f(wproj[(c0 + r) * g.cout + o]) : 0.f;
    }
    if (threadIdx.x < CC)
      scs[threadIdx.x] = threadIdx.x < nc ? scale[(long long)b * g.ce + c0 + threadIdx.x] : 0.f;
    __syncthreads();
    expand_chunk<T, K>(xs, mask, g, y0, x0, c0, nc, wes, bes, es);
    __syncthreads();
    float dwo[CC];
    depthwise<K>(es, wds, bds, py, px, dwo);
#pragma unroll
    for (int r = 0; r < CC; ++r) {
      const float v = rnd<T>(dwo[r] * scs[r]);
      const float4* w4 = reinterpret_cast<const float4*>(wps + r * COUT);
#pragma unroll
      for (int q = 0; q < COUT / 4; ++q) {
        const float4 w = w4[q];
        y[4 * q + 0] = fmaf(v, w.x, y[4 * q + 0]);
        y[4 * q + 1] = fmaf(v, w.y, y[4 * q + 1]);
        y[4 * q + 2] = fmaf(v, w.z, y[4 * q + 2]);
        y[4 * q + 3] = fmaf(v, w.w, y[4 * q + 3]);
      }
    }
    __syncthreads();
  }

  // leave through shared memory, in the layout's own order
#pragma unroll
  for (int o = 0; o < COUT; ++o)
    if (o < g.cout) ys[o * (TILE + 1) + threadIdx.x] = y[o] + to_f(bproj[o]);
  __syncthreads();
  const T* xb = x + (long long)b * g.in_b;
  T* ob = out + (long long)b * g.out_b;
  const int n_out = g.cout * TILE;
  for (int base = threadIdx.x; base < n_out; base += THREADS * LOADS) {
    float v[LOADS];
    long long dst[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {  // all loads first, then the stores
      const int idx = base + u * THREADS;
      dst[u] = -1;
      if (idx >= n_out) continue;
      int o, pix;
      if (g.nhwc) { pix = idx / g.cout; o = idx - pix * g.cout; }
      else { o = idx / TILE; pix = idx - o * TILE; }
      const int gy = y0 + pix / TW, gx = x0 + pix % TW;
      if (gy >= g.H || gx >= g.W) continue;
      const long long n = (long long)gy * g.W + gx;
      float val = ys[o * (TILE + 1) + pix];
      if (mask) val *= to_f(mask[n]);  // rp: gap lanes leave as exactly 0 (+ x's own zeros)
      if (g.has_skip) val += to_f(xb[o * g.in_c + n * g.in_p]);
      v[u] = val;
      dst[u] = o * g.out_c + n * g.out_p;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (dst[u] >= 0) ob[dst[u]] = from_f<T>(v[u]);
  }
}

template <typename T, int K, int COUT>
cudaError_t launch_proj(const T* x, const T* mask, const Params& p, const Geo& g,
                        const float* scale, T* out, int B, cudaStream_t stream) {
  const Smem s = smem_plan<T, K, COUT>(g.cin, g.cout);
  if (s.total > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mbconv_proj_kernel<T, K, COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s.total);
  if (err != cudaSuccess) return err;
  mbconv_proj_kernel<T, K, COUT><<<dim3(g.tiles, B), THREADS, s.total, stream>>>(
      x, mask, p, g, scale, out);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_k(const T* x, const T* mask, const Params& p, const Geo& g, float* partial,
                     float* scale, T* out, int B, cudaStream_t stream) {
  const Smem s = smem_plan<T, K, 0>(g.cin, 0);
  if (s.total > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mbconv_pool_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s.total);
  if (err != cudaSuccess) return err;
  mbconv_pool_kernel<T, K><<<dim3(g.tiles, B), THREADS, s.total, stream>>>(x, mask, p, g, partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mbconv_se_kernel<T><<<B, 256, (g.ce + g.cr) * 4, stream>>>(partial, p, g, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (g.cout <= 8) return launch_proj<T, K, 8>(x, mask, p, g, scale, out, B, stream);
  if (g.cout <= 16) return launch_proj<T, K, 16>(x, mask, p, g, scale, out, B, stream);
  if (g.cout <= 32) return launch_proj<T, K, 32>(x, mask, p, g, scale, out, B, stream);
  return launch_proj<T, K, 64>(x, mask, p, g, scale, out, B, stream);
}

int tiles_of(int H, int W) { return ((W + TW - 1) / TW) * ((H + TH - 1) / TH); }

int launch(Layout layout, const void* x, const void* mask, const void* const* w, void* out,
           void* partial, void* scale, int B, int H, int W, int cin, int ce, int cout, int cr,
           int k, int has_expand, int has_skip, float inv_n, int bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || ce <= 0 || cr <= 0) return (int)cudaErrorInvalidValue;
  if (cout <= 0 || cout > 64 || B > 65535 || (k != 3 && k != 5)) return (int)cudaErrorInvalidValue;
  if (!has_expand && ce != cin) return (int)cudaErrorInvalidValue;
  Geo g;
  g.H = H; g.W = W; g.cin = cin; g.ce = ce; g.cout = cout; g.cr = cr;
  const long long hw = (long long)H * W;
  g.nhwc = layout == NHWC;
  g.in_b = hw * cin; g.out_b = hw * cout;
  g.in_c = g.nhwc ? 1 : hw; g.out_c = g.nhwc ? 1 : hw;
  g.in_p = g.nhwc ? cin : 1; g.out_p = g.nhwc ? cout : 1;
  g.tiles_x = (W + TW - 1) / TW;
  g.tiles = tiles_of(H, W);
  g.has_expand = has_expand; g.has_skip = has_skip; g.inv_n = inv_n;
  const Params p = {w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(partial);
  float* sc = static_cast<float*>(scale);
  cudaError_t err;
  if (bf16) {
    using T = __nv_bfloat16;
    const T* xt = static_cast<const T*>(x);
    const T* mt = static_cast<const T*>(mask);
    T* ot = static_cast<T*>(out);
    err = k == 3 ? launch_k<T, 3>(xt, mt, p, g, pa, sc, ot, B, s)
                 : launch_k<T, 5>(xt, mt, p, g, pa, sc, ot, B, s);
  } else {
    const float* xt = static_cast<const float*>(x);
    const float* mt = static_cast<const float*>(mask);
    float* ot = static_cast<float*>(out);
    err = k == 3 ? launch_k<float, 3>(xt, mt, p, g, pa, sc, ot, B, s)
                 : launch_k<float, 5>(xt, mt, p, g, pa, sc, ot, B, s);
  }
  return (int)err;
}

}  // namespace

// The number of spatial tiles of an H x W grid: the scratch `partial` holds
// B * tiles * Ce float32 sums, `scale` B * Ce.
extern "C" int fused_mbconv_tiles(int H, int W) { return tiles_of(H, W); }

// x (B, Cin, H*W) -> out (B, Cout, H*W).
// w: wexp, bexp, wdw, bdw, wser, bser, wsee, bsee, wproj, bproj (input dtype).
extern "C" int fused_mbconv_packed_launch(const void* x, const void* const* w, void* out,
                                          void* partial, void* scale, int B, int H, int W,
                                          int cin, int ce, int cout, int cr, int k,
                                          int has_expand, int has_skip, int bf16, void* stream) {
  return launch(PACKED, x, nullptr, w, out, partial, scale, B, H, W, cin, ce, cout, cr, k,
                has_expand, has_skip, 1.f / ((float)H * (float)W), bf16, stream);
}

// x (B, Cin, Hp*Wp) with the 0/1 mask (Hp*Wp) of its n_real real lanes ->
// out (B, Cout, Hp*Wp); out's gap lanes are 0 (plus x's, with a skip).
extern "C" int fused_mbconv_rp_launch(const void* x, const void* mask, const void* const* w,
                                      void* out, void* partial, void* scale, int B, int Hp,
                                      int Wp, int n_real, int cin, int ce, int cout, int cr,
                                      int k, int has_expand, int has_skip, int bf16,
                                      void* stream) {
  if (n_real <= 0) return (int)cudaErrorInvalidValue;
  return launch(ROW_PADDED, x, mask, w, out, partial, scale, B, Hp, Wp, cin, ce, cout, cr, k,
                has_expand, has_skip, 1.f / (float)n_real, bf16, stream);
}

// x (B, H, W, Cin) -> out (B, H, W, Cout).
extern "C" int fused_mbconv_nhwc_launch(const void* x, const void* const* w, void* out,
                                        void* partial, void* scale, int B, int H, int W,
                                        int cin, int ce, int cout, int cr, int k,
                                        int has_expand, int has_skip, int bf16, void* stream) {
  return launch(NHWC, x, nullptr, w, out, partial, scale, B, H, W, cin, ce, cout, cr, k,
                has_expand, has_skip, 1.f / ((float)H * (float)W), bf16, stream);
}

extern "C" const char* fused_mbconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
