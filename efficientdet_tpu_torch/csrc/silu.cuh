// SiLU of a float32 pre-activation, as the folded backbone's kernels
// (conv_epilogue.cu, depthwise_conv.cu) apply it before they round to the
// activation's type T.
//
// float32: ATen's formula `v / (1 + exp(-v))` in precise math, equal to
// ATen's silu bit for bit. bf16: the fast exponential and reciprocal,
// within a few float32 ulps of it, so at most one bf16 ulp after rounding:
// a precise exponential and division per element would cost more issue
// slots than the bytes leave (below -80 the fast reciprocal of 1 + e^-v
// would flush SiLU's tiny value to 0, so the precise form runs there).
#pragma once

// __expf(-v) where 1 + e^-v differs from 1: the special-function unit's
// 2^x of -v log2(e) (__expf's own steps), flushing results below 2^-126,
// which vanish in 1 + e^-v, instead of scaling them as __expf does
__device__ __forceinline__ float fast_exp_neg(float v) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  return e;
}

template <typename T>
__device__ __forceinline__ float silu(float v) {
  if (sizeof(T) == 4 || v < -80.f) return v / (1.0f + expf(-v));
  return v * __fdividef(1.0f, 1.0f + fast_exp_neg(v));
}

// silu<T> of N values in place. In bf16, where no value lies below -80 (the
// common case), one test for all N and the fast form for each: what silu<T>
// gives there, without a branch a value.
template <typename T, int N>
__device__ __forceinline__ void silu_n(float (&v)[N]) {
  if (sizeof(T) == 2) {
    bool tail = false;
#pragma unroll
    for (int i = 0; i < N; ++i) tail |= v[i] < -80.f;
    if (__builtin_expect(!tail, 1)) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = v[i] * __fdividef(1.0f, 1.0f + fast_exp_neg(v[i]));
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = silu<T>(v[i]);
}
