// One BiFPN node in one pass, on channels-last maps:
//
//   out = silu( sum_i w_i kept_i + w_m R(moved) )        (B, H, W, C), one rounding
//
// `kept` are the one or two inputs already at the node's level, `moved` the
// input from the level above (top-down: R is the nearest 2x upsample,
// out[y, x] reads moved[y / 2, x / 2]) or below (bottom-up: R is the 3x3
// stride-2 max-pool with flax's SAME pad, which for the even fine size 2H
// pads one row and one column of -inf after the map; the pad is never
// written, a window simply stops at the edge). Weighted nodes (D0-D5) take
// the raw float32 fusion weights and form w = relu(w) / (sum relu(w) +
// 1e-4), rounded to the activation's type, as the model's `fuse` does;
// plain nodes (D6, D7, D7x) sum. The products and sums are float32 in
// `fuse`'s order, each rounded to float32 (no contraction into an FMA), so
// a float32 node equals ATen's chain bit for bit; bf16 rounds once where
// ATen's chain rounds after every op. SiLU is silu.cuh's.
//
// Replaces no TPU kernel: XLA fuses the resample, the weighted sum and the
// swish of a node into one loop fusion. On the card ATen ran them apart:
// `F.interpolate` wrote the upsampled map whole, `F.pad` wrote a -inf
// padded copy of the finer map that `F.max_pool2d` read, then one
// broadcast multiply an input, the adds, `silu`, and five one-element
// launches for the weights.
//
// What bounds it on an H100: bytes. A node reads each kept input once, the
// moved input once at its own level, and writes its output once; a few
// float32 operations an element lie between. The design does what the
// bytes ask: 16-byte vectors along the channels (8 bf16 or 4 float32
// elements; every BiFPN width divides by 8) and many loads in flight a
// thread.
// - Top-down, a thread owns one vector of a 2x2 output quad: it reads the
//   moved vector once and the quad's kept vectors, and writes four.
// - Bottom-up, a thread owns one vector of two neighbouring output columns
//   over a strip of ROWS output rows: the five fine columns under the pair
//   (the middle one shared by both windows) come in by row, and a row's
//   column maxima, kept in registers, serve the window below too, so a
//   fine element is read about once (the strip's last row and a pair's
//   last column again by the next strip and pair, from L2), not the 2.25
//   times a window at a time would read it. Maxima stay in the storage
//   type (bf16 pairs by `__hmax2_nan`), NaN-propagating as ATen's pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "silu.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;  // bottom-up: output rows a thread
constexpr float FUSION_EPS = 1e-4f;

template <typename T> struct Elems { static constexpr int N = 16 / sizeof(T); };

// a 16-byte vector to float32 and back (bf16: two elements a word, the
// lower address in the low half)
template <typename T> __device__ __forceinline__ void unpack(uint4 v, float (&f)[Elems<T>::N]);
template <> __device__ __forceinline__ void unpack<float>(uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 v, float (&f)[8]) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <typename T> __device__ __forceinline__ uint4 pack(const float (&f)[Elems<T>::N]);
template <> __device__ __forceinline__ uint4 pack<float>(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float (&f)[8]) {
  unsigned int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
           ((unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the max-pool's pad: a vector of -inf
template <typename T> __device__ __forceinline__ uint4 neg_inf();
template <> __device__ __forceinline__ uint4 neg_inf<float>() {
  return make_uint4(0xff800000u, 0xff800000u, 0xff800000u, 0xff800000u);
}
template <> __device__ __forceinline__ uint4 neg_inf<__nv_bfloat16>() {
  return make_uint4(0xff80ff80u, 0xff80ff80u, 0xff80ff80u, 0xff80ff80u);
}

__device__ __forceinline__ float max_nan(float a, float b) { return (b > a || b != b) ? b : a; }
__device__ __forceinline__ unsigned int max_nan2(unsigned int a, unsigned int b) {
  const __nv_bfloat162 m = __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                       *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const unsigned int*>(&m);
}

// elementwise max of two vectors, NaN-propagating (exact in either type)
template <typename T> __device__ __forceinline__ uint4 vmax(uint4 a, uint4 b);
template <> __device__ __forceinline__ uint4 vmax<float>(uint4 a, uint4 b) {
  return make_uint4(
      __float_as_uint(max_nan(__uint_as_float(a.x), __uint_as_float(b.x))),
      __float_as_uint(max_nan(__uint_as_float(a.y), __uint_as_float(b.y))),
      __float_as_uint(max_nan(__uint_as_float(a.z), __uint_as_float(b.z))),
      __float_as_uint(max_nan(__uint_as_float(a.w), __uint_as_float(b.w))));
}
template <> __device__ __forceinline__ uint4 vmax<__nv_bfloat16>(uint4 a, uint4 b) {
  return make_uint4(max_nan2(a.x, b.x), max_nan2(a.y, b.y), max_nan2(a.z, b.z),
                    max_nan2(a.w, b.w));
}

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint4 load(const void* base, long long elem_bytes) {
  return __ldg(reinterpret_cast<const uint4*>(static_cast<const char*>(base) + elem_bytes));
}

// The node's fusion weights: relu(w) / (sum relu(w) + eps), summed in
// index order, rounded to T (the model's `fuse`); all 1 for a plain sum
// (never multiplied).
template <typename T, int NIN, bool WEIGHTED>
__device__ __forceinline__ void fusion_weights(const float* __restrict__ raw, float (&w)[NIN]) {
  if (!WEIGHTED) return;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NIN; ++i) {
    const float v = __ldg(raw + i);
    w[i] = v > 0.f ? v : 0.f;
    s = i == 0 ? w[0] : __fadd_rn(s, w[i]);
  }
  const float d = __fadd_rn(s, FUSION_EPS);
#pragma unroll
  for (int i = 0; i < NIN; ++i) w[i] = round_to<T>(__fdiv_rn(w[i], d));
}

// silu(sum_i w_i in_i) of one output vector from its NK kept vectors and
// the resampled one, in `fuse`'s order
template <typename T, int NK, bool WEIGHTED>
__device__ __forceinline__ uint4 fuse(const uint4 (&kept)[NK], uint4 moved,
                                      const float (&w)[NK + 1]) {
  constexpr int N = Elems<T>::N;
  float acc[N], f[N];
  unpack<T>(kept[0], acc);
  if (WEIGHTED) {
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = __fmul_rn(w[0], acc[e]);
  }
#pragma unroll
  for (int i = 1; i <= NK; ++i) {
    unpack<T>(i < NK ? kept[i % NK] : moved, f);  // the kept inputs, then the moved one
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = __fadd_rn(acc[e], WEIGHTED ? __fmul_rn(w[i], f[e]) : f[e]);
  }
  silu_n<T, N>(acc);
  return pack<T>(acc);
}

struct Geom {
  int c;           // channels
  int h, w;        // the node's (output) level
  int cv;          // 16-byte vectors a pixel
  int tiles_h;     // top-down: h / 2; bottom-up: strips of ROWS rows
  int tiles_w;     // top-down: w / 2; bottom-up: column pairs
  long long items; // threads with work
};

// A thread's (vector, tile column, tile row, image): 32-bit division where
// the items fit in 32 bits, as they do at every cell's shapes.
struct Tile {
  int cv, tx, ty;
  long long b;
};

__device__ __forceinline__ Tile tile_of(long long item, const Geom& g) {
  Tile t;
  if (g.items <= 0xffffffffLL) {
    const unsigned int i = (unsigned int)item;
    const unsigned int q = i / (unsigned int)g.cv, r = q / (unsigned int)g.tiles_w;
    const unsigned int b = r / (unsigned int)g.tiles_h;
    t.cv = (int)(i - q * (unsigned int)g.cv);
    t.tx = (int)(q - r * (unsigned int)g.tiles_w);
    t.ty = (int)(r - b * (unsigned int)g.tiles_h);
    t.b = b;
  } else {
    const long long q = item / g.cv, r = q / g.tiles_w;
    t.b = r / g.tiles_h;
    t.cv = (int)(item - q * g.cv);
    t.tx = (int)(q - r * g.tiles_w);
    t.ty = (int)(r - t.b * g.tiles_h);
  }
  return t;
}

// Top-down: the thread's vector of a 2x2 output quad and the moved pixel
// above it.
template <typename T, int NK, bool WEIGHTED>
__device__ __forceinline__ void up_node(long long item, const T* __restrict__ k0,
                                        const T* __restrict__ k1, const T* __restrict__ moved,
                                        const float* __restrict__ raw_w, T* out, const Geom& g) {
  const Tile t = tile_of(item, g);
  const int xq = t.tx, yq = t.ty;
  const long long b = t.b;
  constexpr int N = Elems<T>::N;
  const long long ch = (long long)t.cv * N;
  const uint4 m = load(moved, (((b * g.tiles_h + yq) * g.tiles_w + xq) * g.c + ch) * sizeof(T));
  uint4 kv[4][NK];
  long long off[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    off[p] = ((b * g.h + 2 * yq + p / 2) * g.w + 2 * xq + p % 2) * g.c + ch;
    kv[p][0] = load(k0, off[p] * sizeof(T));
    if (NK == 2) kv[p][NK - 1] = load(k1, off[p] * sizeof(T));
  }
  float w[NK + 1];
  fusion_weights<T, NK + 1, WEIGHTED>(raw_w, w);
#pragma unroll
  for (int p = 0; p < 4; ++p)
    *reinterpret_cast<uint4*>(out + off[p]) = fuse<T, NK, WEIGHTED>(kv[p], m, w);
}

// Bottom-up: the thread's vector of output columns 2 xp and 2 xp + 1 over
// rows ROWS ys .. ROWS ys + ROWS - 1; fine (moved) columns 4 xp .. 4 xp + 4.
template <typename T, int NK, bool WEIGHTED>
__device__ __forceinline__ void down_node(long long item, const T* __restrict__ k0,
                                          const T* __restrict__ k1, const T* __restrict__ moved,
                                          const float* __restrict__ raw_w, T* out,
                                          const Geom& g) {
  const Tile t = tile_of(item, g);
  const long long b = t.b;
  constexpr int N = Elems<T>::N;
  const long long ch = (long long)t.cv * N;
  const int hf = 2 * g.h, wf = 2 * g.w;  // the fine level
  const int x0 = 2 * t.tx;
  const bool pair = x0 + 1 < g.w;
  const int y0 = t.ty * ROWS;
  const T* fine_b = moved + b * hf * (long long)wf * g.c + ch;

  // the column maxima of fine row `fr` under output columns x0 and x0 + 1
  auto row_max = [&](int fr, uint4& m0, uint4& m1) {
    uint4 v[5];
    const T* row = fine_b + (long long)fr * wf * g.c;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int col = 2 * x0 + j;
      v[j] = (j < 3 || pair) && col < wf ? load(row, (long long)col * g.c * sizeof(T))
                                         : neg_inf<T>();
    }
    m0 = vmax<T>(vmax<T>(v[0], v[1]), v[2]);
    m1 = vmax<T>(vmax<T>(v[2], v[3]), v[4]);
  };

  float w[NK + 1];
  fusion_weights<T, NK + 1, WEIGHTED>(raw_w, w);
  uint4 top0, top1;  // fine row 2y's maxima
  row_max(2 * y0, top0, top1);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int y = y0 + i;
    if (y >= g.h) break;
    uint4 mid0, mid1, bot0, bot1;
    row_max(2 * y + 1, mid0, mid1);
    if (2 * y + 2 < hf) {
      row_max(2 * y + 2, bot0, bot1);
    } else {
      bot0 = bot1 = neg_inf<T>();
    }
    const long long off0 = ((b * g.h + y) * g.w + x0) * g.c + ch;
    uint4 kv0[NK], kv1[NK];
    kv0[0] = load(k0, off0 * sizeof(T));
    if (NK == 2) kv0[NK - 1] = load(k1, off0 * sizeof(T));
    if (pair) {
      kv1[0] = load(k0, (off0 + g.c) * sizeof(T));
      if (NK == 2) kv1[NK - 1] = load(k1, (off0 + g.c) * sizeof(T));
    }
    const uint4 p0 = vmax<T>(vmax<T>(top0, mid0), bot0);
    *reinterpret_cast<uint4*>(out + off0) = fuse<T, NK, WEIGHTED>(kv0, p0, w);
    if (pair) {
      const uint4 p1 = vmax<T>(vmax<T>(top1, mid1), bot1);
      *reinterpret_cast<uint4*>(out + off0 + g.c) = fuse<T, NK, WEIGHTED>(kv1, p1, w);
    }
    top0 = bot0;
    top1 = bot1;
  }
}

template <typename T, int NK, bool UP, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS)
bifpn_node_kernel(const T* __restrict__ k0, const T* __restrict__ k1, const T* __restrict__ moved,
                  const float* __restrict__ raw_w, T* out, Geom g) {
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (item >= g.items) return;
  if (UP)
    up_node<T, NK, WEIGHTED>(item, k0, k1, moved, raw_w, out, g);
  else
    down_node<T, NK, WEIGHTED>(item, k0, k1, moved, raw_w, out, g);
}

template <typename T, int NK, bool WEIGHTED>
cudaError_t launch(bool up, const void* k0, const void* k1, const void* moved,
                   const float* weights, void* out, const Geom& g, cudaStream_t s) {
  const long long blocks = (g.items + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = up ? bifpn_node_kernel<T, NK, true, WEIGHTED>
                   : bifpn_node_kernel<T, NK, false, WEIGHTED>;
  kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(k0), static_cast<const T*>(k1), static_cast<const T*>(moved),
      weights, static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_inputs(bool up, const void* k0, const void* k1, const void* moved,
                      const float* weights, void* out, const Geom& g, cudaStream_t s) {
  if (k1)
    return weights ? launch<T, 2, true>(up, k0, k1, moved, weights, out, g, s)
                   : launch<T, 2, false>(up, k0, k1, moved, weights, out, g, s);
  return weights ? launch<T, 1, true>(up, k0, k1, moved, weights, out, g, s)
                 : launch<T, 1, false>(up, k0, k1, moved, weights, out, g, s);
}

}  // namespace

// k0, k1 (null for one kept input), out: (b, h, w, c) channels-last;
// moved: (b, h / 2, w / 2, c) when `up`, else (b, 2 h, 2 w, c); weights:
// null (a plain sum) or the node's raw float32 fusion weights, the kept
// inputs' then the moved one's. One type (bf16 when `bf16`, else float32),
// c a multiple of 8, every pointer 16-byte aligned; h and w even when `up`.
// Launches on `stream`; no synchronisation.
extern "C" int bifpn_node_launch(const void* k0, const void* k1, const void* moved,
                                 const float* weights, void* out, long long b, int c, int h,
                                 int w, int up, int bf16, void* stream) {
  if (b <= 0 || c <= 0 || c % 8 || h <= 0 || w <= 0 || (up && (h % 2 || w % 2)))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k0 | (uintptr_t)k1 | (uintptr_t)moved | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  Geom g;
  g.c = c;
  g.h = h;
  g.w = w;
  g.cv = c / (bf16 ? Elems<__nv_bfloat16>::N : Elems<float>::N);
  g.tiles_h = up ? h / 2 : (h + ROWS - 1) / ROWS;
  g.tiles_w = up ? w / 2 : (w + 1) / 2;
  g.items = b * g.tiles_h * (long long)g.tiles_w * g.cv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? by_inputs<__nv_bfloat16>(up != 0, k0, k1, moved, weights, out, g, s)
                    : by_inputs<float>(up != 0, k0, k1, moved, weights, out, g, s));
}

extern "C" const char* bifpn_node_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
