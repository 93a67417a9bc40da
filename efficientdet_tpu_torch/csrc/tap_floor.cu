// The arithmetic floor of the depthwise tap loops: a kernel that does
// nothing but the per-element body, `repeats` times.
//
// Replaces: experiments/vpu_tap_floor.py, _floor_kernel (measure_rate). For
// each element x of a (rows, 1024) array, CHAINS accumulators start at 0
// and each pass runs
//
//   fma:   accs[t % CHAINS] = accs[t % CHAINS] * w_t + x,  t = 0..TAPS-1,
//          with distinct multipliers w_t = 1 + 1e-3 (t + 1), so the loop
//          cannot be folded into acc * w^k + x * sum;
//   swish: accs[c] = x * sigmoid(accs[c]) for each chain (float32 only), with
//          the fast exponential and division the fused MBConv uses;
//
// and the element's output is the chains' sum, taken in order. CHAINS = 1 is
// the serial chain a naive tap loop makes, 4 the reassociated one a real
// kernel may use to hide the FMA latency.
//
// What bounds it on an H100: operations, by design. Each element is read
// and written once (8 bytes in float32) but gets repeats x TAPS FMAs: at
// repeats 512, taps 9 that is 4,608 FMAs per 8 bytes. The float32 version
// runs one fmaf per FMA on the CUDA cores (67 TFLOP/s, 2 operations an
// FMA); the bf16 version runs __hfma2 on __nv_bfloat162 pairs, two FMAs an
// instruction. A thread owns one element (float32) or one pair (bf16), so
// a warp's loads and stores are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int T> __device__ __forceinline__ float mult() {
  return (float)(1.0 + 1e-3 * (T + 1));  // the Python double, rounded once
}

template <int TAPS, int CHAINS, int T = 0>
__device__ __forceinline__ void taps_f32(float (&acc)[CHAINS], float x) {
  if constexpr (T < TAPS) {
    acc[T % CHAINS] = fmaf(acc[T % CHAINS], mult<T>(), x);
    taps_f32<TAPS, CHAINS, T + 1>(acc, x);
  }
}

template <int TAPS, int CHAINS, int T = 0>
__device__ __forceinline__ void taps_bf16(__nv_bfloat162 (&acc)[CHAINS], __nv_bfloat162 x) {
  if constexpr (T < TAPS) {
    const __nv_bfloat162 w = __bfloat162bfloat162(__double2bfloat16(1.0 + 1e-3 * (T + 1)));
    acc[T % CHAINS] = __hfma2(acc[T % CHAINS], w, x);
    taps_bf16<TAPS, CHAINS, T + 1>(acc, x);
  }
}

template <int TAPS, int CHAINS>
__global__ void __launch_bounds__(THREADS)
tap_floor_fma_f32(const float* __restrict__ x, float* __restrict__ o, long long n, int repeats) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float acc[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c] = 0.f;
  for (int r = 0; r < repeats; ++r) taps_f32<TAPS, CHAINS>(acc, xv);
  float s = acc[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) s = s + acc[c];
  o[i] = s;
}

template <int TAPS, int CHAINS>
__global__ void __launch_bounds__(THREADS)
tap_floor_fma_bf16(const __nv_bfloat162* __restrict__ x, __nv_bfloat162* __restrict__ o,
                   long long npairs, int repeats) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= npairs) return;
  const __nv_bfloat162 xv = x[i];
  __nv_bfloat162 acc[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c] = __float2bfloat162_rn(0.f);
  for (int r = 0; r < repeats; ++r) taps_bf16<TAPS, CHAINS>(acc, xv);
  __nv_bfloat162 s = acc[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) s = __hadd2(s, acc[c]);
  o[i] = s;
}

template <int CHAINS>
__global__ void __launch_bounds__(THREADS)
tap_floor_swish_f32(const float* __restrict__ x, float* __restrict__ o, long long n, int repeats) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  float acc[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c] = 0.f;
  for (int r = 0; r < repeats; ++r) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) acc[c] = __fdividef(xv, 1.f + __expf(-acc[c]));
  }
  float s = acc[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) s = s + acc[c];
  o[i] = s;
}

template <int TAPS, int CHAINS>
cudaError_t launch_fma(const void* x, void* o, long long n, int repeats, int bf16,
                       cudaStream_t s) {
  if (bf16) {
    const long long pairs = n / 2;
    const unsigned blocks = (unsigned)((pairs + THREADS - 1) / THREADS);
    tap_floor_fma_bf16<TAPS, CHAINS><<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat162*>(x), static_cast<__nv_bfloat162*>(o), pairs, repeats);
  } else {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    tap_floor_fma_f32<TAPS, CHAINS><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(o), n, repeats);
  }
  return cudaGetLastError();
}

}  // namespace

// op 0 = fma (taps 3 or 9), 1 = swish (float32; taps ignored); chains 1 or 4.
// x and o hold n elements of float32, or of bf16 with n even.
extern "C" int tap_floor_launch(const void* x, void* o, long long n, int op, int taps,
                                int chains, int repeats, int bf16, void* stream) {
  if (n <= 0 || repeats < 0 || (chains != 1 && chains != 4)) return (int)cudaErrorInvalidValue;
  if (bf16 && (n % 2 || op != 0)) return (int)cudaErrorInvalidValue;
  if ((n + THREADS - 1) / THREADS > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == 1) {
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    if (chains == 1)
      tap_floor_swish_f32<1><<<blocks, THREADS, 0, s>>>(static_cast<const float*>(x),
                                                        static_cast<float*>(o), n, repeats);
    else
      tap_floor_swish_f32<4><<<blocks, THREADS, 0, s>>>(static_cast<const float*>(x),
                                                        static_cast<float*>(o), n, repeats);
    return (int)cudaGetLastError();
  }
  if (op != 0) return (int)cudaErrorInvalidValue;
  if (taps == 9) return (int)(chains == 1 ? launch_fma<9, 1>(x, o, n, repeats, bf16, s)
                                          : launch_fma<9, 4>(x, o, n, repeats, bf16, s));
  if (taps == 3) return (int)(chains == 1 ? launch_fma<3, 1>(x, o, n, repeats, bf16, s)
                                          : launch_fma<3, 4>(x, o, n, repeats, bf16, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tap_floor_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
