// The epilogue of the folded backbone's convolutions, in one pass:
//
//   out = act(x + bias[c]) [+ residual]      act: SiLU or identity
//
// over a (B, C, H, W) conv output `x` (the conv ran without its bias), in
// NCHW or channels-last memory (the detector's own path is channels-last:
// its images arrive NHWC and cuDNN keeps their layout), either in place
// (`out` is `x`) or into a new (B, C, H + pt + pb, W + pl + pr) buffer in
// x's layout whose border the same pass writes as zeros: the SAME padding of
// the stride-2 depthwise conv that reads it.
//
// Replaces no TPU kernel: XLA fuses a conv's bias, activation and residual
// into its epilogue, and the JAX package relies on that. On the card ATen's
// cuDNN path runs the conv, then a broadcast add of the bias, `silu`, the
// residual add and `F.pad` (a fill and a copy), each a read and a write of
// the whole activation.
//
// What bounds it on an H100: bytes. Each element is read once (twice with a
// residual) and written once, with a handful of float32 operations between.
// The design does what the bytes ask: 16-byte vector loads and stores (8
// bf16 or 4 float32 elements a vector), two vectors a thread in flight, the
// arithmetic in float32 registers rounded once to the activation's type,
// and no second pass for the border. In float32 SiLU is `v / (1 +
// expf(-v))`, ATen's formula in ATen's precise math, so float32 results
// equal ATen's add, silu and add bit for bit; in bf16, where a precise
// exponential and division per element would cost more issue slots than
// the bytes leave, the fast ones (see `epilogue`).
//
// A thread owns the elements of two 16-byte aligned vectors of the flat
// output and walks their (channel, row, col) from each vector's first, so a
// vector may straddle planes or pixels: any C, H and W. Unpadded, input and
// output share the layout and the input is read by vectors too; padded,
// each output element gathers its input element (consecutive threads read
// consecutive addresses, which L1 merges), or, channels-last with C a
// multiple of the vector, each vector reads one input pixel's channels as a
// vector. The last, partial vector is stored element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "silu.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 2;  // vectors a thread

template <typename T> struct Elems { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

struct Geom {
  long long n_out;               // elements of the output
  unsigned long long plane_out;  // ho * wo
  int c, h, w;                   // input
  int ho, wo;                    // output plane
  int pt, pl;                    // top and left pads
};

// Where flat output element e lies, and the walk to the next element.
// NCHW: plane (b * c + ch), row, col. NHWC: b, row, col, ch. 32-bit
// division where the whole output has under 2^32 elements.
template <bool NHWC, bool PAD> struct Pos {
  long long plane;  // NCHW: b * c + ch; NHWC: b
  int ch, row, col;

  __device__ __forceinline__ Pos(const Geom& g, long long e) {
    const bool small = g.n_out <= 0xffffffffLL;
    if (NHWC) {
      long long q;  // the output pixel, b * ho * wo + row * wo + col
      if (small) {
        const unsigned int e32 = (unsigned int)e, q32 = e32 / (unsigned int)g.c;
        ch = (int)(e32 - q32 * (unsigned int)g.c);
        q = q32;
      } else {
        q = e / g.c;
        ch = (int)(e - q * g.c);
      }
      row = col = 0;
      plane = 0;
      if (PAD) {
        unsigned int rem;
        if (small) {
          const unsigned int q32 = (unsigned int)q, p32 = (unsigned int)g.plane_out;
          const unsigned int b32 = q32 / p32;
          rem = q32 - b32 * p32;
          plane = b32;
        } else {
          plane = (long long)((unsigned long long)q / g.plane_out);
          rem = (unsigned int)(q - plane * (long long)g.plane_out);
        }
        row = (int)(rem / (unsigned int)g.wo);
        col = (int)(rem - (unsigned int)row * (unsigned int)g.wo);
      }
      return;
    }
    unsigned int rem;
    if (small) {
      const unsigned int e32 = (unsigned int)e, p32 = (unsigned int)g.plane_out;
      const unsigned int pl32 = e32 / p32;
      rem = e32 - pl32 * p32;
      plane = pl32;
      ch = (int)(pl32 % (unsigned int)g.c);
    } else {
      plane = (long long)((unsigned long long)e / g.plane_out);
      rem = (unsigned int)((unsigned long long)e - (unsigned long long)plane * g.plane_out);
      ch = (int)(plane % g.c);
    }
    row = (int)(rem / (unsigned int)g.wo);
    col = (int)(rem - (unsigned int)row * (unsigned int)g.wo);
  }

  __device__ __forceinline__ void step(const Geom& g) {
    if (NHWC) {
      if (++ch == g.c) {
        ch = 0;
        if (PAD && ++col == g.wo) {
          col = 0;
          if (++row == g.ho) {
            row = 0;
            ++plane;
          }
        }
      }
      return;
    }
    if (++col == g.wo) {
      col = 0;
      if (++row == g.ho) {
        row = 0;
        ++plane;
        if (++ch == g.c) ch = 0;
      }
    }
  }

  // padded: the input element under this output element, or -1 in the border
  __device__ __forceinline__ long long input(const Geom& g) const {
    const int r = row - g.pt, q = col - g.pl;
    if (r < 0 || r >= g.h || q < 0 || q >= g.w) return -1;
    return NHWC ? ((plane * g.h + r) * g.w + q) * g.c + ch : (plane * g.h + r) * g.w + q;
  }
};

template <typename T, bool SILU, bool RES>
__device__ __forceinline__ float epilogue(float x, float b, float r) {
  float v = x + b;
  if (SILU) v = silu<T>(v);  // precise in float32, the fast form in bf16 (silu.cuh)
  if (RES) v = v + r;
  return v;
}

template <typename T, bool SILU, bool RES, bool PAD, bool NHWC>
__global__ void __launch_bounds__(THREADS)
conv_epilogue_kernel(const T* x, const T* __restrict__ bias, const T* __restrict__ res, T* out,
                     Geom g) {
  constexpr int N = Elems<T>::N;
  const long long base = ((long long)blockIdx.x * ITEMS * THREADS + threadIdx.x) * N;
  // NHWC with whole vectors a pixel: a padded vector is all border or one
  // input pixel's channels, read by a vector too
  const bool pixel_vectors = NHWC && g.c % N == 0;
  uint4 xin[ITEMS], rin[ITEMS];
  if (!PAD) {
    // the input shares the output's layout: every vector in flight first
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const long long e = base + (long long)it * THREADS * N;
      if (e + N <= g.n_out) {
        xin[it] = *reinterpret_cast<const uint4*>(x + e);
        if (RES) rin[it] = __ldg(reinterpret_cast<const uint4*>(res + e));
      }
    }
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const long long e = base + (long long)it * THREADS * N;
    if (e >= g.n_out) break;
    Pos<NHWC, PAD> p(g, e);
    if (e + N <= g.n_out) {
      float xf[N], rf[N], o[N];
      if (PAD && pixel_vectors) {
        const long long i = p.input(g);
        if (i < 0) {
#pragma unroll
          for (int k = 0; k < N; ++k) o[k] = 0.f;
        } else {
          unpack<T>(*reinterpret_cast<const uint4*>(x + i), xf);
          if (RES) unpack<T>(__ldg(reinterpret_cast<const uint4*>(res + i)), rf);
#pragma unroll
          for (int k = 0; k < N; ++k)
            o[k] = epilogue<T, SILU, RES>(xf[k], to_f(__ldg(bias + p.ch + k)), RES ? rf[k] : 0.f);
        }
      } else if (PAD) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const long long i = p.input(g);
          o[k] = i < 0 ? 0.f
                       : epilogue<T, SILU, RES>(to_f(x[i]), to_f(__ldg(bias + p.ch)),
                                                RES ? to_f(res[i]) : 0.f);
          p.step(g);
        }
      } else {
        unpack<T>(xin[it], xf);
        if (RES) unpack<T>(rin[it], rf);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          o[k] = epilogue<T, SILU, RES>(xf[k], to_f(__ldg(bias + p.ch)), RES ? rf[k] : 0.f);
          p.step(g);
        }
      }
      *reinterpret_cast<uint4*>(out + e) = pack<T>(o);
    } else {
      for (long long e2 = e; e2 < g.n_out; ++e2) {  // the last, partial vector
        const long long i = PAD ? p.input(g) : e2;
        out[e2] = from_f<T>(i < 0 ? 0.f
                                  : epilogue<T, SILU, RES>(to_f(x[i]), to_f(__ldg(bias + p.ch)),
                                                           RES ? to_f(res[i]) : 0.f));
        p.step(g);
      }
    }
  }
}

template <typename T, bool SILU, bool RES, bool PAD, bool NHWC>
cudaError_t launch(const void* x, const void* bias, const void* res, void* out, const Geom& g,
                   cudaStream_t s) {
  constexpr int N = Elems<T>::N;
  const long long per_block = (long long)ITEMS * THREADS * N;
  const long long blocks = (g.n_out + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv_epilogue_kernel<T, SILU, RES, PAD, NHWC><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias), static_cast<const T*>(res),
      static_cast<T*>(out), g);
  return cudaGetLastError();
}

template <typename T, bool SILU, bool RES>
cudaError_t by_layout(bool pad, bool nhwc, const void* x, const void* bias, const void* res,
                      void* out, const Geom& g, cudaStream_t s) {
  if (nhwc)
    return pad ? launch<T, SILU, RES, true, true>(x, bias, res, out, g, s)
               : launch<T, SILU, RES, false, true>(x, bias, res, out, g, s);
  return pad ? launch<T, SILU, RES, true, false>(x, bias, res, out, g, s)
             : launch<T, SILU, RES, false, false>(x, bias, res, out, g, s);
}

template <typename T>
cudaError_t by_flags(bool silu, bool pad, bool nhwc, const void* x, const void* bias,
                     const void* res, void* out, const Geom& g, cudaStream_t s) {
  if (silu)
    return res ? by_layout<T, true, true>(pad, nhwc, x, bias, res, out, g, s)
               : by_layout<T, true, false>(pad, nhwc, x, bias, res, out, g, s);
  return res ? by_layout<T, false, true>(pad, nhwc, x, bias, res, out, g, s)
             : by_layout<T, false, false>(pad, nhwc, x, bias, res, out, g, s);
}

}  // namespace

// x: (b, c, h, w) in NCHW (nhwc = 0) or channels-last (nhwc = 1) memory;
// bias: (c,); res: null or like x; out: x itself (all pads 0) or a distinct
// (b, c, h + pt + pb, w + pl + pr) buffer in x's layout; every tensor of
// one type (bf16 when `bf16`, else float32), `out` 16-byte aligned and,
// unpadded, `x` and `res` too (padded NHWC with c a multiple of 16 bytes:
// `x` and `res` as well). Launches on `stream`; no synchronisation.
extern "C" int conv_epilogue_launch(const void* x, const void* bias, const void* res, void* out,
                                    long long b, int c, int h, int w, int pt, int pb, int pl,
                                    int pr, int silu, int nhwc, int bf16, void* stream) {
  if (b <= 0 || c <= 0 || h <= 0 || w <= 0 || pt < 0 || pb < 0 || pl < 0 || pr < 0)
    return (int)cudaErrorInvalidValue;
  const bool pad = pt || pb || pl || pr;
  if (pad == (out == x)) return (int)cudaErrorInvalidValue;  // in place iff unpadded
  const bool vec_in = !pad || (nhwc && c % (bf16 ? 8 : 4) == 0);
  const uintptr_t align = (uintptr_t)out | (vec_in ? ((uintptr_t)x | (uintptr_t)res) : 0);
  if (align % 16) return (int)cudaErrorMisalignedAddress;
  Geom g;
  g.c = c;
  g.h = h;
  g.w = w;
  g.ho = h + pt + pb;
  g.wo = w + pl + pr;
  g.pt = pt;
  g.pl = pl;
  g.plane_out = (unsigned long long)g.ho * (unsigned long long)g.wo;
  g.n_out = b * (long long)c * (long long)g.plane_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? by_flags<__nv_bfloat16>(silu != 0, pad, nhwc != 0, x, bias, res, out, g, s)
                    : by_flags<float>(silu != 0, pad, nhwc != 0, x, bias, res, out, g, s));
}

extern "C" const char* conv_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
